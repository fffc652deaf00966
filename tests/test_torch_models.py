"""The port's VGG model, loss, optimizers, data and parameter carriers
against the JAX package on the same numpy inputs."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import repro.data as jdata
from repro.configs.vgg16_cifar10 import REDUCED as JAX_REDUCED, SPEC as JAX_SPEC
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.models.vgg import VggModel as JaxVgg
from repro.optim import adam as jadam, momentum as jmomentum, sgd as jsgd
import repro_torch.data as tdata
from repro_torch.configs.vgg16_cifar10 import REDUCED, SPEC
from repro_torch.models import (
    VggModel, build_model, cross_entropy, params_from_numpy, params_to_numpy,
)
from repro_torch.optim import adam, momentum, opt_state_bytes_per_param, sgd

# conv reductions are summed in another order by XLA and by PyTorch
VGG_TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")


def _flat(tree, prefix=()):
    """{key path: numpy array} of a nested dict/list tree from either package."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, prefix + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, prefix + (str(i),)).items()}
    if isinstance(tree, torch.Tensor):
        return {"/".join(prefix): tree.detach().numpy()}
    return {"/".join(prefix): np.asarray(tree)}


def _assert_trees_close(got, ref, **tol):
    g, r = _flat(got), _flat(ref)
    assert g.keys() == r.keys()
    for k in g:
        np.testing.assert_allclose(g[k], r[k], err_msg=k, **tol)


def _vgg_inputs(spec, b=3, seed=0):
    jparams = JaxVgg(spec).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    hw = spec.image_size
    batch = {"images": rng.normal(size=(b, hw, hw, spec.in_channels)).astype(np.float32),
             "labels": rng.integers(0, spec.num_classes, b).astype(np.int32)}
    return params_to_numpy(jparams), batch


def test_spec_accounting_matches_jax():
    for tspec, jspec in ((SPEC, JAX_SPEC), (REDUCED, JAX_REDUCED)):
        assert tspec == type(tspec)(**{f: getattr(jspec, f) for f in tspec.__dataclass_fields__})
        assert tspec.n_units == jspec.n_units
        for u in range(tspec.n_units):
            assert tspec.unit_io(u) == jspec.unit_io(u)
            assert tspec.unit_param_count(u) == jspec.unit_param_count(u)
        assert tspec.total_param_count() == jspec.total_param_count()
    assert SPEC.total_param_count() == 15_245_130


def test_init_params_tree_and_scale():
    p = VggModel(REDUCED).init_params(torch.Generator().manual_seed(0), CPU)
    j = params_to_numpy(JaxVgg(JAX_REDUCED).init_params(jax.random.PRNGKey(0)))
    assert p["frontend"] == {} and p["head"] == {}
    got, ref = _flat(p), _flat(j)
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
    # He-normal: std sqrt(2 / fan_in) for the first conv (fan_in 27)
    assert abs(float(p["units"][0]["w"].std()) - np.sqrt(2 / 27)) < 0.05
    q = VggModel(REDUCED).init_params(torch.Generator().manual_seed(0), CPU)
    assert all(np.array_equal(a, b) for a, b in zip(_flat(p).values(), _flat(q).values()))


@pytest.mark.parametrize("lo,hi", [(0, 5), (0, 2), (2, 4), (3, 5)])
def test_vgg_apply_units_matches_jax(lo, hi):
    """Split points at every kind of unit boundary, including the NHWC
    flatten before the first FC unit (REDUCED: a 4x4x32 map)."""
    np_params, batch = _vgg_inputs(JAX_REDUCED)
    jm, tm = JaxVgg(JAX_REDUCED), VggModel(REDUCED)
    carry = jm.apply_units(np_params["units"], {"h": jnp.asarray(batch["images"])}, 0, lo)
    h = np.array(carry["h"])
    ref = jm.apply_units(np_params["units"], {"h": jnp.asarray(h)}, lo, hi)["h"]
    got = tm.apply_units(params_from_numpy(np_params, CPU)["units"],
                         {"h": torch.from_numpy(h)}, lo, hi)["h"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **VGG_TOL)


def test_vgg_logits_loss_accuracy_and_grads_match_jax():
    np_params, batch = _vgg_inputs(JAX_REDUCED, b=4, seed=1)
    jm, tm = JaxVgg(JAX_REDUCED), VggModel(REDUCED)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = params_from_numpy(np_params, CPU)
    jlogits, _ = jm.forward(np_params, jb)
    tlogits, aux = tm.forward(tp, tb)
    assert float(aux) == 0.0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **VGG_TOL)
    np.testing.assert_allclose(float(tm.loss_fn(tp, tb)), float(jm.loss_fn(np_params, jb)),
                               rtol=1e-5)
    assert float(tm.accuracy(tp, tb)) == float(jm.accuracy(np_params, jb))
    jg = jax.grad(jm.loss_fn)(jax.tree.map(jnp.asarray, np_params), jb)
    tg = grad(tm.loss_fn)(tp, tb)
    _assert_trees_close(tg, jg, **VGG_TOL)


def test_vgg_per_client_vmap_grads_match_jax():
    """The engine's per-client update: vmap over client-stacked weights
    (grouped convolutions in PyTorch)."""
    N = 3
    jm, tm = JaxVgg(JAX_REDUCED), VggModel(REDUCED)
    stacked = [params_to_numpy(jm.init_params(jax.random.PRNGKey(i))) for i in range(N)]
    np_params = jax.tree.map(lambda *xs: np.stack(xs), *stacked)
    rng = np.random.default_rng(2)
    batch = {"images": rng.normal(size=(N, 2, 16, 16, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (N, 2)).astype(np.int32)}
    jl, jg = jax.vmap(jax.value_and_grad(jm.loss_fn))(
        jax.tree.map(jnp.asarray, np_params), jax.tree.map(jnp.asarray, batch))
    tg = vmap(grad(tm.loss_fn))(params_from_numpy(np_params, CPU),
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    _assert_trees_close(tg, jg, **VGG_TOL)


def test_build_model_refuses_transformer_specs():
    """The dense, MoE, SSM and hybrid families are ported; the VLM and
    audio families, and the JAX package's own spec objects, are refused."""
    import dataclasses

    from repro.configs import get_reduced
    from repro_torch.configs import get_reduced as port_get_reduced
    from repro_torch.models import MoeSpec, SplittableModel

    assert isinstance(build_model(REDUCED), VggModel)
    assert isinstance(build_model(port_get_reduced("smollm-135m")), SplittableModel)
    moe = dataclasses.replace(port_get_reduced("smollm-135m"), family="moe",
                              moe=MoeSpec(num_experts=4, top_k=2))
    assert isinstance(build_model(moe), SplittableModel)
    vlm = dataclasses.replace(port_get_reduced("smollm-135m"), family="vlm", prefix_len=4)
    assert isinstance(build_model(vlm), SplittableModel)
    audio = dataclasses.replace(port_get_reduced("smollm-135m"), family="audio",
                                encoder_layers=2, encoder_len=8)
    assert isinstance(build_model(audio), SplittableModel)  # A14.5
    with pytest.raises(TypeError, match="ModelSpec"):
        build_model(get_reduced("smollm-135m"))


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_matches_jax(with_mask):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 5, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32) if with_mask else None
    ref = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    zero = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                         torch.zeros(2, 5))
    assert float(zero) == 0.0  # an all-masked batch divides by max(0, 1)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_match_jax_over_three_steps(name):
    """Elementwise updates; XLA may contract a multiply-add into one FMA,
    so the two can differ by an ulp or two per step."""
    jopt = {"sgd": jsgd, "momentum": jmomentum, "adam": jadam}[name](0.01)
    topt = {"sgd": sgd, "momentum": momentum, "adam": adam}[name](0.01)
    assert topt.state_bytes_per_param == jopt.state_bytes_per_param
    assert opt_state_bytes_per_param(name) == topt.state_bytes_per_param
    rng = np.random.default_rng(4)
    params = {"frontend": {}, "units": [
        {"w": rng.normal(size=(2, 3, 4)).astype(np.float32),
         "b": rng.normal(size=(2, 4)).astype(np.float32)}], "head": {}}
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params, CPU)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = topt.update(tp, params_from_numpy(g, CPU), ts)
    _assert_trees_close(tp, jp, rtol=1e-6, atol=1e-7)
    if name != "sgd":
        _assert_trees_close(ts, js, rtol=1e-6, atol=1e-7)
    if name == "adam":
        assert ts["t"].dtype == torch.int32 and int(ts["t"]) == 3


def test_params_numpy_round_trip_keeps_structure():
    np_params, _ = _vgg_inputs(JAX_REDUCED)
    back = params_to_numpy(params_from_numpy(np_params, CPU))
    assert back["frontend"] == {} and back["head"] == {}
    assert isinstance(back["units"], list)
    for k, v in _flat(np_params).items():
        np.testing.assert_array_equal(_flat(back)[k], v)


@pytest.mark.parametrize("non_iid", [False, True])
def test_data_pipeline_is_byte_identical(non_iid):
    """Same seed, same dataset, partition and three loader rounds."""
    jd = jdata.make_cifar10_like(256, seed=3)
    td = tdata.make_cifar10_like(256, seed=3)
    assert jd.images.tobytes() == td.images.tobytes()
    assert jd.labels.tobytes() == td.labels.tobytes()
    if non_iid:
        jp = jdata.partition_sort_and_shard(jd.labels, 8, 2, 3)
        tp = tdata.partition_sort_and_shard(td.labels, 8, 2, 3)
    else:
        jp = jdata.partition_iid(len(jd.labels), 8, 3)
        tp = tdata.partition_iid(len(td.labels), 8, 3)
    assert [a.tobytes() for a in jp] == [b.tobytes() for b in tp]
    assert jdata.label_skew(jd.labels, jp) == tdata.label_skew(td.labels, tp)
    jl, tl = jdata.image_loader(jd, jp, 4, 3), tdata.image_loader(td, tp, 4, 3)
    for _ in range(3):
        a, b = jl.next_round(), tl.next_round()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_lm_stream_is_byte_identical():
    a = jdata.make_lm_stream(16, 8, 64, seed=1)
    b = tdata.make_lm_stream(16, 8, 64, seed=1)
    assert a.tokens.tobytes() == b.tokens.tobytes()
