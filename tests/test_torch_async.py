"""Bounded-staleness async aggregation in the port (``core.async_agg``)
against the JAX package's: the staleness normalisation and the round-time
model equal JAX's with ``==``; ``fed_level_apply`` (fresh, masked, over the
int8 wire, stale) at rtol 1e-5 / atol 1e-6 on B1's, B2's and B1m's plain
versions; the trainer's queue; Engine A at staleness 1 against JAX's losses
from a carried init; staleness 0 against the synchronous dispatch bit for
bit; ``launch.train --staleness``."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.async_agg as ja
import repro_torch.core.async_agg as ta
from repro.compress import Int8Stochastic as JaxInt8
from repro.configs.vgg16_cifar10 import REDUCED as JAX_REDUCED
from repro.core.engine import init_state_a as jax_init
from repro.core.tiers import default_plan as jax_default_plan
from repro.models.vgg import VggModel as JaxVgg
from repro.optim import sgd as jsgd
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.compress import Int8Stochastic
from repro_torch.configs.vgg16_cifar10 import REDUCED
from repro_torch.core import TrainState, default_plan
from repro_torch.kernels.tiered_aggregate import launches, reset_launches
from repro_torch.launch import train
from repro_torch.models import VggModel, params_from_numpy, params_to_numpy
from repro_torch.optim import sgd

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
N = 8


def make_plans(intervals=(4, 2, 1)):
    kw = dict(cuts=(1, 2), intervals=intervals, entities=(N, 4, 1))
    return jax_default_plan(4, N, **kw), default_plan(4, N, **kw)


def toy_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"frontend": {"e": rng.normal(size=(N, 3)).astype(np.float32)},
            "units": {"w": rng.normal(size=(N, 4, 2)).astype(np.float32)},
            "head": {"h": rng.normal(size=(N, 2)).astype(np.float32)}}


def _close(got, ref):
    for k, v in (("frontend", "e"), ("units", "w"), ("head", "h")):
        np.testing.assert_allclose(got[k][v].numpy(), np.asarray(ref[k][v]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{k}/{v}")


@pytest.mark.parametrize("intervals", [(4, 1, 1), (4, 2, 1)])
@pytest.mark.parametrize("staleness", [None, 0, 2, (1, 0, 0), (1, 1, 0), (1, 0),
                                       (-1, 0, 0), (0, 0, 1), (0, 1, 0)])
def test_normalize_staleness_equals_jax(intervals, staleness):
    jp, tp = make_plans(intervals)
    try:
        want = ja.normalize_staleness(staleness, jp)
    except ValueError as err:
        with pytest.raises(ValueError) as terr:
            ta.normalize_staleness(staleness, tp)
        assert str(terr.value) == str(err)
        return
    assert ta.normalize_staleness(staleness, tp) == want


@pytest.mark.parametrize("m", [0, 1])
@pytest.mark.parametrize("kind", ["fresh", "masked", "all-zero mask", "int8", "masked int8",
                                  "stale", "stale masked"])
def test_fed_level_apply_matches_jax(m, kind):
    """Tier m's fed level alone: fresh (B1, ``do_entity=0, do_global=1``),
    under a mask (B1m, keep = the source), over the int8 wire (B2; B1m's
    int8 load under a mask), and stale (the snapshot's mean plus the local
    progress since) — against JAX at rtol 1e-5 / atol 1e-6, tiers other
    than m bit for bit."""
    jp, tp = make_plans()
    snap_np, delta_np = toy_np(0), toy_np(1)
    now_np = jax.tree.map(lambda a, d: (a + 0.25 * d).astype(np.float32), snap_np, delta_np)
    mask = np.array([1, 1, 0, 1, 0, 0, 1, 1], np.float32)
    if kind == "all-zero mask":
        mask = np.zeros(N, np.float32)
    masked = "mask" in kind
    codec = 64 if "int8" in kind else None
    snapshot = "stale" in kind
    jc = JaxInt8(tile=codec) if codec else None
    ref = ja.fed_level_apply(
        jax.tree.map(jnp.asarray, now_np), jp, m,
        snapshot=jax.tree.map(jnp.asarray, snap_np) if snapshot else None,
        compress_fn=(lambda x: jax.vmap(jc.transform)(x)) if codec else None,
        mask=jnp.asarray(mask) if masked else None)
    reset_launches()
    got = ta.fed_level_apply(
        params_from_numpy(now_np, CPU), tp, m,
        snapshot=params_from_numpy(snap_np, CPU) if snapshot else None,
        compressor=Int8Stochastic(codec) if codec else None,
        mask=torch.from_numpy(mask) if masked else None)
    assert sum(launches.values()) == 0  # the plain versions count nothing
    _close(got, ref)
    now = params_from_numpy(now_np, CPU)
    if m == 0:
        assert torch.equal(got["head"]["h"], now["head"]["h"])
        assert torch.equal(got["units"]["w"][:, 1:], now["units"]["w"][:, 1:])
    if kind == "all-zero mask":
        for k, v in (("frontend", "e"), ("units", "w"), ("head", "h")):
            assert torch.equal(got[k][v], now[k][v])
    with pytest.raises(ValueError, match="top tier"):
        ta.fed_level_apply(now, tp, tp.M - 1)


def _fake_builder(fed):
    def step(state, batch):
        params = tree_map(lambda x: x + batch, state.params)
        return TrainState(params, state.opt_state, state.step + 1), torch.tensor(0.0), \
            torch.ones(N)

    return step


def test_trainer_defers_and_folds_in_the_snapshot_mean():
    _, plan = make_plans((2, 1, 1))
    tr = ta.AsyncTrainer(plan, _fake_builder, staleness=1)
    assert tr.async_tiers == [0]
    state = TrainState(params_from_numpy(toy_np(), CPU), (), 0)
    state, _ = tr.run_round(state, 1.0, 0)
    assert not tr.pending                      # (0+1) % 2 != 0: nothing due
    state, _ = tr.run_round(state, 1.0, 1)
    assert [p.tier for p in tr.pending] == [0] and tr.pending[0].apply_round == 2
    snap = tr.pending[0].snapshot
    state, _ = tr.run_round(state, 1.0, 2)
    assert not tr.pending                      # applied at its due round
    want = ta.fed_level_apply(tree_map(lambda x: x + 1.0, snap), plan, 0, snapshot=snap)
    assert torch.equal(state.params["frontend"]["e"], want["frontend"]["e"])


def test_trainer_drain_and_fed_tuple():
    _, plan = make_plans((2, 2, 1))
    tr = ta.AsyncTrainer(plan, _fake_builder, staleness=3)
    state = TrainState(params_from_numpy(toy_np(), CPU), (), 0)
    for r in range(2):
        state, _ = tr.run_round(state, 1.0, r)
    assert {p.tier for p in tr.pending} == {0, 1}
    state = tr.drain(state)
    assert not tr.pending
    assert all(torch.isfinite(x).all() for x in tree_leaves(state.params))
    tr = ta.AsyncTrainer(plan, _fake_builder, staleness=(1, 0, 0))
    assert tr._fed_tuple(0) == (False, False, True)
    assert tr._fed_tuple(1) == (False, True, True)
    assert ta.AsyncTrainer(plan, _fake_builder, staleness=0)._fed_tuple(1) == (True, True, True)


def test_round_time_equals_jax_and_sharding_is_refused(monkeypatch):
    for args in ((2.0, [4.0, 1.0, 0.0], (2, 4, 1), (0, 0, 0)),
                 (2.0, [4.0, 1.0, 0.0], (2, 4, 1), (1, 1, 0)),
                 (2.0, [4.0, 1.0, 0.0], (2, 4, 1), (2, 1, 0)),
                 (0.37, [1.3, 0.2, 0.0], (3, 5, 1), (2, 0, 0))):
        assert ta.async_round_time(*args) == ja.async_round_time(*args)
    # the sharded engine is ported (ROADMAP A13): a mesh is no longer
    # refused, it builds the sharded steps and routes the deferred fed
    # levels over the mesh (tests/test_torch_sharded.py runs them)
    _, plan = make_plans()
    mesh = object()
    built = {}

    def fake_build(model, plan_, opt, mesh_, **kw):
        built.update(mesh=mesh_, **kw)
        return _fake_builder(kw["fed_round"])

    monkeypatch.setattr(ta, "build_sharded_train_step_a", fake_build)
    tr = ta.make_async_trainer(VggModel(REDUCED), plan, sgd(0.1), staleness=1,
                               mesh=mesh, client_axes=("pod", "data"))
    tr._get_step((False, False, True))
    assert built["mesh"] is mesh and built["client_axes"] == ("pod", "data")
    assert built["with_sync_weights"] and built["fed_round"] == (False, False, True)
    assert tr._mesh is mesh and tr._client_axes == ("pod", "data")


EN, EB = 4, 2
ECUTS, EENT = (1, 3), (4, 2, 1)


def _batches(rounds, seed=0):
    rng = np.random.default_rng(seed)
    hw = REDUCED.image_size
    return [{"images": rng.normal(size=(EN, EB, hw, hw, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (EN, EB)).astype(np.int32)}
            for _ in range(rounds)]


def _port_async(init, intervals, staleness, rounds, masks=None):
    plan = default_plan(REDUCED.n_units, EN, cuts=ECUTS, intervals=intervals, entities=EENT)
    params = params_from_numpy(init, CPU)
    opt = sgd(0.01)
    tr = ta.make_async_trainer(VggModel(REDUCED), plan, opt, staleness=staleness,
                               with_mask=masks is not None)
    state = TrainState(params, opt.init(params), 0)
    losses = []
    for r, batch in enumerate(_batches(rounds)):
        args = () if masks is None else (torch.from_numpy(masks[r]),)
        state, loss = tr.run_round(state, train.to_device(batch, CPU), r, *args)
        losses.append(float(loss))
    return tr.drain(state), losses, tr


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_engine_a_async_matches_jax(masked):
    """REDUCED VGG, N=4, intervals (2, 2, 1), staleness 1, 6 rounds plus
    the drain, from JAX's init (masked: random masks): losses at rtol 1e-4
    and params at atol 1e-5 against JAX's ``AsyncTrainer``."""
    jmodel, jopt = JaxVgg(JAX_REDUCED), jsgd(0.01)
    jplan = jax_default_plan(REDUCED.n_units, EN, cuts=ECUTS, intervals=(2, 2, 1),
                             entities=EENT)
    state = jax_init(jmodel, jplan, jopt, jax.random.PRNGKey(0))
    init = params_to_numpy(state.params)
    masks = None
    if masked:
        masks = (np.random.default_rng(3).random((6, EN)) < 0.7).astype(np.float32)
        masks[:, 0] = 1.0
    jtr = ja.make_async_trainer(jmodel, jplan, jopt, staleness=1, with_mask=masked)
    jl = []
    for r, batch in enumerate(_batches(6)):
        args = () if masks is None else (jnp.asarray(masks[r]),)
        state, loss = jtr.run_round(state, jax.tree.map(jnp.asarray, batch), r, *args)
        jl.append(float(loss))
    state = jtr.drain(state)
    tstate, tl, _ = _port_async(init, (2, 2, 1), 1, 6, masks)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(params_to_numpy(state.params)),
                    [x.numpy() for x in tree_leaves(tstate.params)]):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5)


def _init_np():
    from repro_torch.core import replicate_for_clients

    p0 = VggModel(REDUCED).init_params(torch.Generator().manual_seed(2), CPU)
    return params_to_numpy(replicate_for_clients(p0, EN))


def test_staleness_zero_is_the_synchronous_dispatch_bit_for_bit():
    """All-zero staleness: no tier enters the queue, and every loss and
    param equals ``launch.train.make_dispatch``'s bit for bit."""
    init = _init_np()
    astate, al, tr = _port_async(init, (3, 2, 1), 0, 6)
    assert tr.async_tiers == [] and not tr.pending
    plan = default_plan(REDUCED.n_units, EN, cuts=ECUTS, intervals=(3, 2, 1), entities=EENT)
    params = params_from_numpy(init, CPU)
    opt = sgd(0.01)
    dispatch = train.make_dispatch(VggModel(REDUCED), plan, opt)
    state, sl = TrainState(params, opt.init(params), 0), []
    for r, batch in enumerate(_batches(6)):
        state, loss = dispatch(state, train.to_device(batch, CPU), r)
        sl.append(float(loss))
    assert al == sl
    for a, b in zip(tree_leaves(astate.params), tree_leaves(state.params)):
        assert torch.equal(a, b)


def test_drain_at_the_due_round_equals_the_in_step_fed_level():
    """Two rounds at staleness 1 (tiers snapshot on round 2) then the
    drain: the synchronous run's params at f32 tolerance (the in-step sync
    fuses the entity and fed means into one launch; the deferred path
    applies them one after the other, as JAX does both)."""
    init = _init_np()
    astate, _, _ = _port_async(init, (2, 2, 1), 1, 2)
    plan = default_plan(REDUCED.n_units, EN, cuts=ECUTS, intervals=(2, 2, 1), entities=EENT)
    params = params_from_numpy(init, CPU)
    opt = sgd(0.01)
    dispatch = train.make_dispatch(VggModel(REDUCED), plan, opt)
    state = TrainState(params, opt.init(params), 0)
    for r, batch in enumerate(_batches(2)):
        state, _ = dispatch(state, train.to_device(batch, CPU), r)
    for a, b in zip(tree_leaves(astate.params), tree_leaves(state.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def _cli_losses(capsys, *extra):
    rc = train.main(["--device", "cpu", "--arch", "smollm-135m", "--clients", "4",
                     "--edges", "2", "--batch", "1", "--rounds", "3", "--log-every", "1",
                     "--intervals", "2", "2", *extra])
    assert rc == 0
    out = capsys.readouterr().out
    return out, [line.split("loss")[1].split()[0] for line in out.splitlines()
                 if line.startswith("round")]


def test_train_cli_staleness(capsys):
    """``--staleness 0`` prints the synchronous run's losses; ``--staleness
    1`` trains on the async schedule (round 2's fed levels folded back in
    round 3), drains, and its losses stay finite."""
    _, sync = _cli_losses(capsys)
    out0, zero = _cli_losses(capsys, "--staleness", "0")
    assert zero == sync and "async staleness=0" not in out0
    out1, stale = _cli_losses(capsys, "--staleness", "1")
    assert "[async staleness=1]" in out1
    assert len(stale) == 3 and all(np.isfinite(float(v)) for v in stale)
    assert stale[0] == sync[0]
    with pytest.raises(ValueError, match="top tier"):
        _cli_losses(capsys, "--staleness", "0", "0", "1")
