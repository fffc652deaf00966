"""The port's layout rules (``launch.sharding``) against the JAX package's,
rule for rule, on the JAX shape trees of every configuration
``tests/test_sharding.py`` uses and on the port's own parameter trees; and
the port's meshes (``launch.mesh``): their refusals and the placements of
a spec tree."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_reduced as jax_reduced, get_spec as jax_spec
from repro.configs.shapes import sds
from repro.core.engine import TrainState as JState
from repro.launch import mesh as jmesh, sharding as jsh
from repro.models.model import SplittableModel as JaxModel
from repro.models.vgg import VggModel as JaxVgg
from repro.configs.vgg16_cifar10 import SPEC as JAX_VGG
from repro_torch.configs import get_reduced
from repro_torch.core import TrainState, init_state_a, default_plan
from repro_torch.launch import mesh as tmesh, sharding as tsh
from repro_torch.launch.mesh import run_on_ranks
from repro_torch.models import SplittableModel
from repro_torch.optim import adam

CPU = torch.device("cpu")


def _abstract(arch, reduced=True, client=None):
    spec = jax_reduced(arch) if reduced else jax_spec(arch)
    model = JaxVgg(JAX_VGG) if arch == "vgg16-cifar10" else JaxModel(spec)
    p = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    if client:
        p = jax.tree.map(lambda s: sds((client,) + s.shape, s.dtype), p)
    return p


def _jax_specs(tree):
    """{path: entries} of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(ps)
            for path, ps in flat}


def _port_specs(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _port_specs(sub, prefix + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _port_specs(sub, prefix + (str(i),)).items()}
    assert isinstance(tree, tsh.PartitionSpec), type(tree)
    return {"/".join(prefix): tuple(tree)}


PARAM_CASES = {
    # tests/test_sharding.py's trees: TP over client-stacked units, the full
    # widths where TP divides, MoE expert parallelism (16 and 32 experts),
    # indivisible REDUCED dims, multi-pod client axes; and VGG-16
    "dense-tp": dict(arch="smollm-135m", client=16, tp=16, client_axes=("data",)),
    "qwen2.5-14b": dict(arch="qwen2.5-14b", reduced=False, tp=16, client_axes=None),
    "moe-16": dict(arch="phi3.5-moe-42b-a6.6b", reduced=False, tp=16, client_axes=None),
    "moe-32": dict(arch="granite-moe-1b-a400m", reduced=False, tp=16, client_axes=None),
    "indivisible": dict(arch="smollm-135m", tp=16, client_axes=None),
    "multipod": dict(arch="qwen2-1.5b", client=32, tp=16, client_axes=("pod", "data")),
    "tp4": dict(arch="qwen2-1.5b", tp=4, client_axes=("data",), client=4),
    "vgg16": dict(arch="vgg16-cifar10", client=20, tp=16, client_axes=("data",)),
}


@pytest.mark.parametrize("name", list(PARAM_CASES))
def test_param_pspecs_equal_jax(name):
    c = dict(PARAM_CASES[name])
    tree = _abstract(c.pop("arch"), c.pop("reduced", True), c.pop("client", None))
    got = _port_specs(tsh.param_pspecs(tree, **c))
    assert got == _jax_specs(jsh.param_pspecs(tree, **c))
    if name == "moe-16":
        assert got["units/moe/w1"][-3] == "model"


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-1.5b"])
def test_rules_on_the_ports_own_trees(arch):
    """The port's REDUCED params (``init_params`` on the CPU), client-stacked
    by ``init_state_a``, get JAX's specs of JAX's tree of the same config."""
    spec = get_reduced(arch)
    model = SplittableModel(spec)
    plan = default_plan(spec.n_units, 4, entities=(4, 2, 1))
    state = init_state_a(model, plan, adam(0.1), torch.Generator().manual_seed(0), CPU)
    jtree = _abstract(arch, client=4)
    for tp, ca in ((16, ("data",)), (4, None), (2, ("pod", "data"))):
        assert (_port_specs(tsh.param_pspecs(state.params, tp=tp, client_axes=ca))
                == _jax_specs(jsh.param_pspecs(jtree, tp=tp, client_axes=ca)))
    assert (_port_specs(tsh.train_pspecs(state.params, ("data",), 4))
            == _jax_specs(jsh.train_pspecs(jtree, ("data",), 4)))


@pytest.mark.parametrize("client_axes", [("data",), ("pod", "data")])
def test_train_pspecs_equal_jax(client_axes):
    p = _abstract("smollm-135m", client=8)
    got = _port_specs(tsh.train_pspecs(p, client_axes, num_clients=8))
    assert got == _jax_specs(jsh.train_pspecs(p, client_axes, num_clients=8))
    ca = client_axes if len(client_axes) > 1 else client_axes[0]
    assert all(e[0] == ca and all(x is None for x in e[1:]) for e in got.values())
    tree = {"stacked": sds((8, 3, 4), jnp.float32), "scalar": sds((), jnp.float32),
            "counter": sds((3,), jnp.int32)}
    for n in (8, None):
        assert (_port_specs(tsh.train_pspecs(tree, client_axes, n))
                == _jax_specs(jsh.train_pspecs(tree, client_axes, n)))


def test_train_pspecs_on_a_train_state_equal_jax():
    """A TrainState under adam: params and both moments client-sharded,
    adam's step counter and the round counter replicated."""
    spec = get_reduced("smollm-135m")
    plan = default_plan(spec.n_units, 4, entities=(4, 2, 1))
    state = init_state_a(SplittableModel(spec), plan, adam(0.1),
                         torch.Generator().manual_seed(0), CPU)
    got = tsh.train_pspecs(state, ("data",), 4)
    jstate = jax.eval_shape(lambda: JState(
        jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), _abstract("smollm-135m", client=4)),
        {"m": jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                           _abstract("smollm-135m", client=4)),
         "v": jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                           _abstract("smollm-135m", client=4)),
         "t": jnp.zeros((), jnp.int32)},
        jnp.zeros((), jnp.int32)))
    ref = jsh.train_pspecs(jstate, ("data",), 4)
    assert isinstance(got, TrainState)
    assert _port_specs(got.params) == _jax_specs(ref.params)
    assert _port_specs(got.opt_state) == _jax_specs(ref.opt_state)
    assert tuple(got.step) == tuple(ref.step) == ()


def test_batch_token_opt_and_state_pspecs_equal_jax():
    batch = {"tokens": sds((16, 16, 128), jnp.int32), "labels": sds((16, 16, 128), jnp.int32)}
    for ca in (("data",), ("pod", "data")):
        assert _port_specs(tsh.batch_pspecs(batch, ca)) == _jax_specs(jsh.batch_pspecs(batch, ca))
        for b in (128, 32, 16, 1):
            assert tuple(tsh.token_pspec(b, ca)) == tuple(jsh.token_pspec(b, ca))
    p = _abstract("qwen2-1.5b", client=4)
    pps = tsh.param_pspecs(p, tp=16, client_axes=("data",))
    assert tsh.opt_pspecs(None, pps, "sgd") == jsh.opt_pspecs(None, pps, "sgd") == ()
    assert tsh.opt_pspecs(None, pps, "momentum") is pps
    a = tsh.opt_pspecs(None, pps, "adam")
    assert a["m"] is pps and a["v"] is pps and tuple(a["t"]) == ()
    with pytest.raises(ValueError):
        tsh.opt_pspecs(None, pps, "lion")
    got = tsh.state_pspecs(p, "adam", tp=16, client_axes=("data",))
    ref = jsh.state_pspecs(p, "adam", tp=16, client_axes=("data",))
    assert _port_specs(got.params) == _jax_specs(ref.params)
    assert _port_specs(got.opt_state) == _jax_specs(ref.opt_state)


@pytest.mark.parametrize("mode", ["decode", "decode-seq-shard", "long"])
def test_cache_pspecs_equal_jax(mode):
    """The serving rules are data for the decode path (ROADMAP A14); they
    already equal JAX's on qwen3-32b's full-width caches."""
    model = JaxModel(jax_spec("qwen3-32b"))
    batch = 1 if mode == "long" else 128
    caches = jax.eval_shape(lambda: model.init_caches(batch, 1024))
    kw = dict(batch=batch, client_axes=("data",), long_context=mode == "long",
              seq_shard=mode == "decode-seq-shard")
    got = _port_specs(tsh.cache_pspecs(caches, **kw))
    assert got == _jax_specs(jsh.cache_pspecs(caches, **kw))
    assert any("data" in e for e in got.values())


def test_mesh_shapes_equal_jax():
    assert tmesh.POD_SHAPE == jmesh.POD_SHAPE and tmesh.MULTIPOD_SHAPE == jmesh.MULTIPOD_SHAPE
    for mp in (False, True):
        assert tmesh.client_axes(mp) == jmesh.client_axes(mp)
        assert tmesh.num_clients(mp) == jmesh.num_clients(mp)
    assert tmesh.default_backend("cpu") == "gloo" and tmesh.default_backend("cuda") == "nccl"


def test_make_debug_mesh_without_a_world_fails_loudly():
    """No initialized world: the mesh refuses and names how to start one,
    rather than building a smaller mesh."""
    with pytest.raises(RuntimeError, match="run_on_ranks"):
        tmesh.make_debug_mesh(data=2, model=1, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_production_mesh(device="cpu")


def _one_rank_meshes():
    """In a one-rank gloo world: the refusals of a wrong world size and
    backend, and the placements of a spec tree on a 1x1 mesh."""
    from torch.distributed.tensor import Replicate, Shard

    out = {}
    for kw in (dict(data=2, model=1), dict(data=1, model=2), dict(data=1, model=1, pods=2)):
        try:
            tmesh.make_debug_mesh(device="cpu", **kw)
        except RuntimeError as e:
            out[str(kw)] = str(e)
    try:
        tmesh.make_debug_mesh(data=1, model=1, device="cpu", backend="nccl")
    except RuntimeError as e:
        out["backend"] = str(e)
    try:
        tmesh.make_production_mesh(device="cpu")
    except RuntimeError as e:
        out["production"] = str(e)
    mesh = tmesh.make_debug_mesh(data=1, model=1, device="cpu")
    specs = {"w": tsh.PartitionSpec("data", None, "model"), "s": tsh.PartitionSpec(),
             "pd": tsh.PartitionSpec(("pod", "data"), None)}
    try:
        tsh.to_placements(mesh, specs)
    except ValueError as e:
        out["unknown-axis"] = str(e)
    del specs["pd"]
    pl = tsh.to_placements(mesh, specs)
    out["placements"] = (pl["w"] == (Shard(0), Shard(2)), pl["s"] == (Replicate(), Replicate()))
    out["dims"] = tuple(mesh.mesh_dim_names)
    return out


def test_make_debug_mesh_refuses_a_world_of_the_wrong_size():
    got = run_on_ranks(_one_rank_meshes, 1, device="cpu")
    for kw, need in (("{'data': 2, 'model': 1}", 2), ("{'data': 1, 'model': 2}", 2),
                     ("{'data': 1, 'model': 1, 'pods': 2}", 2)):
        assert f"needs {need} ranks" in got[kw] and "world has 1" in got[kw], got[kw]
    assert "'nccl'" in got["backend"] and "'gloo'" in got["backend"]
    assert "needs 256 ranks" in got["production"]
    assert "'pod'" in got["unknown-axis"]
    assert got["placements"] == (True, True)
    assert got["dims"] == ("data", "model")
