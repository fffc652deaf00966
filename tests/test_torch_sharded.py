"""The port's sharded Engine A (``core.sharded``) over a 4-rank gloo group
on the CPU, against the JAX package's sharded sync and guard (run in a
subprocess over 4 forced host devices), the port's unsharded engine and
the JAX package's unsharded engine.

The ranks are spawned once for the module (``rank_cases`` in
``tests/torch_sharded_cases.py`` runs every case); the JAX reference
script runs once too.  The layout is the JAX package's
``test_sharded_engine_a_equivalence``: REDUCED smollm-135m, N = 8 over D = 4,
cuts (1, 2), intervals (2, 2, 1), entities (8, 2, 1) — tier 1's two
groups and every fed level span the ranks — 4 rounds, plain / mask / int8
/ guard+mask, and the async trainer at staleness 0 and 1."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_cases as C
from repro.compress import Int8Stochastic as JInt8
from repro.configs import get_reduced as jax_reduced
from repro.core import build_train_step_a as jax_step_a, init_state_a as jax_init_a
from repro.core.tiers import GuardSpec as JGuard, default_plan as jax_plan
from repro.models.model import SplittableModel as JaxModel
from repro.optim import sgd as jsgd
from repro_torch._tree import tree_leaves
from repro_torch.launch.mesh import run_on_ranks
from repro_torch.models import params_to_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
# the reference's sharded tolerance (tests/test_sharded_exec.py)
RTOL, ATOL, Q8_ATOL = 2e-5, 2e-6, 2e-3
# the port's standing Engine-A tolerance against JAX (ROADMAP §C)
JAX_LOSS_RTOL, JAX_ATOL = 1e-4, 1e-5

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    import torch_sharded_cases as C
    from repro.compress import Int8Stochastic
    from repro.core.sharded import sharded_guard_health, sharded_synchronize
    from repro.core.tiers import GuardSpec, TierPlan
    from repro.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(data=4, model=1)
    plan = TierPlan(**C.SYNC_PLAN)
    comp = Int8Stochastic(tile=C.SYNC_TILE)
    out = {}
    for case in C.SYNC_CASES:
        tree = jax.tree.map(jnp.asarray, C.sync_tree(case))
        specs = jax.tree.map(lambda x: P("data"), tree)
        for step in C.SYNC_STEPS:
            def body(t, m, step=step, case=case):
                return sharded_synchronize(
                    t, plan, step, num_shards=4, axis_names=("data",),
                    compress_fn=(jax.vmap(comp.transform) if case == "int8" else None),
                    mask=(m if case == "mask" else None),
                    guard=(GuardSpec() if case == "guard" else None))
            f = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P("data")),
                                  out_specs=specs, check_rep=False))
            res = f(tree, jnp.asarray(C.SYNC_MASK))
            for path, x in jax.tree_util.tree_flatten_with_path(res)[0]:
                names = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
                out["/".join([case, str(step)] + names)] = np.asarray(x)
        if case == "guard":
            g = jax.jit(shard_map(
                lambda t: sharded_guard_health(t, 2, GuardSpec(), ("data",))[0],
                mesh=mesh, in_specs=(specs,), out_specs=P("data"), check_rep=False))
            out["health"] = np.asarray(g(tree))
    np.savez(sys.argv[1], **out)
    print("JAX-SHARDED-SYNC-OK")
""")


@pytest.fixture(scope="module")
def p0():
    """JAX's REDUCED smollm-135m init (``PRNGKey(0)``) as NumPy."""
    return params_to_numpy(JaxModel(jax_reduced(C.ARCH)).init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def p0_moe():
    """JAX's REDUCED granite-moe-1b-a400m init (``PRNGKey(0)``) as NumPy."""
    return params_to_numpy(JaxModel(jax_reduced(C.MOE_ARCH)).init_params(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def spawned(p0, p0_moe, tmp_path_factory):
    """The JAX package's sharded sync and guard on 4 forced host devices
    (a subprocess) while every port case runs on 4 gloo ranks, each
    started once."""
    path = str(tmp_path_factory.mktemp("jaxsync") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, "..", "src"), HERE])
    jax_ref = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, path], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = run_on_ranks(C.rank_cases, 4, device="cpu", args=(p0, p0_moe))
        out, err = jax_ref.communicate(timeout=300)
    finally:
        jax_ref.kill()
    assert jax_ref.returncode == 0, err[-3000:]
    assert "JAX-SHARDED-SYNC-OK" in out
    return port, dict(np.load(path))


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def jax_sync(spawned):
    return spawned[1]


@pytest.fixture(scope="module")
def unsharded(p0):
    """The port's unsharded engine on the same cases."""
    runs = {c: C.run_engine(c, p0) for c in C.ENGINE_CASES}
    runs["local"] = C.run_engine("plain", p0, C.LOCAL_PLAN, rounds=1)
    runs["plain2"] = C.run_engine("plain", p0, rounds=2)
    return runs


def _jax_engine(case, p0):
    spec = jax_reduced(C.ARCH)
    model, opt = JaxModel(spec), jsgd(C.LR)
    plan = jax_plan(spec.n_units, C.N, **C.PLAN)
    kw = {"plain": {}, "mask": dict(with_mask=True),
          "int8": dict(compressor=JInt8(tile=C.SYNC_TILE)),
          "guard+mask": dict(with_mask=True, guard=JGuard())}[case]
    state = jax_init_a(model, plan, opt, jax.random.PRNGKey(0))  # p0, replicated
    step = jax.jit(jax_step_a(model, plan, opt, **kw))
    losses = []
    for r, b in enumerate(C.engine_batches(spec.vocab_size)):
        args = (jnp.asarray(C.engine_masks()[r]),) if kw.get("with_mask") else ()
        state, loss = step(state, jax.tree.map(jnp.asarray, b), *args)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def _leaves(tree):
    return [np.asarray(x) for x in tree_leaves(tree)]


def _by_path(tree, prefix=()):
    """{"a/0/w": leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _by_path(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _by_path(sub, prefix + (str(i),)).items()}
    return {"/".join(prefix): np.asarray(tree)}


def _close(got, ref, rtol, atol, what):
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(ref))):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what}: leaf {i}")


@pytest.mark.parametrize("step", C.SYNC_STEPS)
@pytest.mark.parametrize("case", C.SYNC_CASES)
def test_sharded_sync_matches_jax_sharded_and_port_unsharded(case, step, ranks, jax_sync):
    """``sharded_synchronize`` on 4 ranks against JAX's over 4 devices and
    the port's ``synchronize``: plain, a mask with a silent group, the int8
    wire (a step of 2e-3) and the guard with a NaN row and a blow-up row;
    step 0 runs the entity levels only, step 1 every fed level too."""
    got, _ = ranks["sync"][(case, step)]
    ref = {k: jax_sync[f"{case}/{step}/{k}"] for k in _by_path(got)}
    got = _by_path(got)
    one, _ = C.run_sync_case(case, step)
    one = _by_path(one)
    got, ref, one = ([d[k] for k in sorted(got)] for d in (got, ref, one))
    atol = Q8_ATOL if case == "int8" else ATOL
    _close(got, ref, RTOL, atol, f"{case} step {step} vs JAX sharded")
    _close(got, one, RTOL, atol, f"{case} step {step} vs port unsharded")
    if case == "guard":  # quarantined rows are healed with finite values
        assert all(np.isfinite(x).all() for x in _leaves(got))


def test_sharded_guard_health_matches_jax(ranks, jax_sync):
    _, health = ranks["sync"][("guard", 0)]
    _, one = C.run_sync_case("guard", 0)
    expect = np.ones(C.SN, np.float32)
    expect[[C.NAN_ROW, C.BLOWUP_ROW]] = 0.0
    np.testing.assert_array_equal(health, jax_sync["health"])
    np.testing.assert_array_equal(health, one)
    np.testing.assert_array_equal(health, expect)


@pytest.mark.parametrize("case", C.ENGINE_CASES)
def test_sharded_engine_matches_port_unsharded(case, ranks, unsharded):
    """4 ranks against one process: losses rtol 2e-5, params rtol 2e-5 /
    atol 2e-6 (int8 atol 2e-3); round 0's loss, taken before any sync from
    the same per-client losses, bit for bit."""
    (sl, sp), (ul, up) = ranks["engine"][case], unsharded[case]
    np.testing.assert_allclose(sl, ul, rtol=RTOL)
    assert sl[0] == ul[0]
    _close(sp, up, RTOL, Q8_ATOL if case == "int8" else ATOL, case)


@pytest.mark.parametrize("case", C.ENGINE_CASES)
def test_sharded_engine_matches_jax_unsharded(case, ranks, p0):
    """4 ranks against the JAX package's unsharded engine from the same
    init and batches, at the port's standing Engine-A tolerance (losses
    rtol 1e-4, params atol 1e-5); over int8 a value may flip by one
    quantization step (2e-3) and losses agree to rtol 1e-3."""
    (sl, sp), (jl, jp) = ranks["engine"][case], _jax_engine(case, p0)
    q8 = case == "int8"
    np.testing.assert_allclose(sl, jl, rtol=1e-3 if q8 else JAX_LOSS_RTOL)
    sp, jp = _by_path(sp), _by_path(jp)
    assert sorted(sp) == sorted(jp)
    for k in sp:
        np.testing.assert_allclose(sp[k], jp[k], rtol=0.0,
                                   atol=Q8_ATOL if q8 else JAX_ATOL, err_msg=f"{case}: {k}")


def test_device_local_levels_are_bit_for_bit(ranks, unsharded):
    """Entities (8, 4, 1) over 4 ranks: tier 1's groups are device-local.
    After round 0 (no fed level due below the top) tier 0's and tier 1's
    slices equal the unsharded run bit for bit; the top tier's spanning
    levels agree at the sharded tolerance."""
    (sl, sp), (ul, up) = ranks["local"], unsharded["local"]
    assert sl == ul
    hi = C.LOCAL_PLAN["cuts"][1]
    for a, b in zip(_leaves(sp["units"]), _leaves(up["units"])):
        np.testing.assert_array_equal(a[:, :hi], b[:, :hi])
        np.testing.assert_allclose(a[:, hi:], b[:, hi:], rtol=RTOL, atol=ATOL)
    for a, b in zip(_leaves(sp["frontend"]), _leaves(up["frontend"])):
        np.testing.assert_array_equal(a, b)
    _close(sp["head"], up["head"], RTOL, ATOL, "head")


def test_world_size_one_is_the_unsharded_engine(unsharded, p0):
    """A one-rank group (in this process, on a FileStore): every case's
    losses and params equal the unsharded engine's bit for bit."""
    one = run_on_ranks(C.rank_engine_cases, 1, device="cpu", args=(p0,))
    for case in C.ENGINE_CASES:
        (sl, sp), (ul, up) = one[case], unsharded[case]
        assert sl == ul, case
        for a, b in zip(_leaves(sp), _leaves(up)):
            np.testing.assert_array_equal(a, b, err_msg=case)


def test_async_staleness_zero_is_the_sharded_dispatch(ranks):
    """Staleness 0 over the mesh runs the same sharded steps in the same
    order: params equal the sharded synchronous dispatch bit for bit."""
    pending, params = ranks["async0"]
    assert pending == []
    for a, b in zip(_leaves(params), _leaves(ranks["engine"]["plain"][1])):
        np.testing.assert_array_equal(a, b)


def test_async_staleness_one_drained_matches_the_sharded_dispatch(ranks, unsharded):
    """Staleness 1: both gated tiers defer at round 1 and are drained; the
    deferred (spanning, delta-retaining) fed levels equal the in-step ones
    at rtol 2e-5 / atol 2e-6, against the sharded and the unsharded run."""
    pending, params = ranks["async1"]
    assert pending == [0, 1]
    _close(params, ranks["plain2"][1], RTOL, ATOL, "vs sharded dispatch")
    _close(params, unsharded["plain2"][1], RTOL, ATOL, "vs unsharded dispatch")


@pytest.mark.parametrize("mesh", ["pods", "model"])
def test_other_meshes_match_the_unsharded_engine(mesh, ranks, unsharded):
    """The masked case on a (pod=2, data=2, model=1) mesh, clients over the
    client axes (pod, data) — four shards in one enumerated group — and on a
    (data=2, model=2) mesh, whose two model ranks of each shard hold equal
    copies: both at the sharded tolerance of the unsharded run."""
    (sl, sp), (ul, up) = ranks[mesh], unsharded["mask"]
    np.testing.assert_allclose(sl, ul, rtol=RTOL)
    _close(sp, up, RTOL, ATOL, mesh)


def test_moe_engine_at_two_shards_matches_the_unsharded_engine(ranks, p0_moe):
    """REDUCED granite (MoE, each client's tokens dispatched in a group of
    their own) over D = 2 client shards of a (data=2, model=2) mesh: losses
    and params at the sharded tolerance of the unsharded port's run."""
    (sl, sp), (ul, up) = ranks["moe"], C.run_engine("plain", p0_moe, arch=C.MOE_ARCH)
    np.testing.assert_allclose(sl, ul, rtol=RTOL)
    _close(sp, up, RTOL, ATOL, "moe")
