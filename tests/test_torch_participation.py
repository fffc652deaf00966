"""Partial participation in the port: the masked sync on B1m's plain
version and Engine A's ``with_mask`` step, against the JAX package's
``synchronize(mask=)`` and masked step, and the port's own contracts
(all-zero mask a no-op bit for bit; all-ones mask == unmasked at the
ragged-collapse tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import Int8Stochastic as JaxInt8
from repro.configs.vgg16_cifar10 import REDUCED as JAX_REDUCED
from repro.core import build_train_step_a as jax_build_step, init_state_a as jax_init
from repro.core.tiers import (
    _group_mean_masked as jax_group_mean_masked, default_plan as jax_default_plan,
    synchronize as jax_synchronize,
)
from repro.models.vgg import VggModel as JaxVgg
from repro.optim import adam as jadam, sgd as jsgd
from repro_torch.compress import Int8Stochastic
from repro_torch.compress.quantize import q8_quantize
from repro_torch.configs.vgg16_cifar10 import REDUCED
from repro_torch.core import TrainState, build_train_step_a, default_plan, synchronize
from repro_torch.core.engine import masked_mean_loss
from repro_torch.kernels.tiered_aggregate import (
    launches, masked_aggregate_tree, masked_quantized_tiered_aggregate,
    masked_quantized_tiered_aggregate_ref, masked_tiered_aggregate, reset_launches,
)
from repro_torch.launch import train
from repro_torch.models import VggModel, params_from_numpy, params_to_numpy
from repro_torch.optim import adam, sgd

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6  # f32 sums in another order (the dense sync's)
BF16_ULPS = 2  # bf16: one rounding here, two in JAX (see the test below)
N, B, ROUNDS = 4, 2, 4
CUTS, INTERVALS, ENTITIES = (1, 3), (2, 2, 1), (4, 2, 1)
MASKS = {
    "random": np.array([1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 1], bool),
    "zero groups": np.array([0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 1, 1], bool),
    "all zero": np.zeros(12, bool),
    "all ones": np.ones(12, bool),
}


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_levels(x, w, keep, J, de, dg):
    """The JAX synchronize's level chain for one [N, P] leaf."""
    y = jnp.asarray(x)
    wj = jnp.asarray(w, jnp.float32)
    keep = jnp.asarray(keep)
    if de:
        y = jax_group_mean_masked(y, J, wj, keep=keep)
    if dg:
        y = jax_group_mean_masked(y, 1, wj, keep=y if de else keep)
    return np.asarray(y)


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("de,dg", [(1, 1), (1, 0), (0, 1)])
@pytest.mark.parametrize("J", [3, 1])
def test_plain_version_matches_group_mean_masked(name, de, dg, J):
    """B1m's plain version (what a CPU tensor runs) against the JAX level
    chain, with an independent ``keep``; zero-participant groups keep it
    exactly."""
    w = MASKS[name]
    x, keep = _x((12, 300), 1), _x((12, 300), 2)
    ref = _jax_levels(x, w, keep, J, de, dg)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    mask = torch.from_numpy(w.astype(np.float32))
    got = masked_tiered_aggregate(t(x), mask, t(keep), de, dg, J).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    silent = ~w.reshape(J, -1).any(axis=1).repeat(12 // J) if de else (
        np.full(12, not w.any()))
    assert np.array_equal(got[silent], keep[silent])
    # bf16 against the JAX level chain on the same bf16 inputs.  The port
    # sums both levels in f32 and rounds once; JAX also rounds the entity
    # mean to bf16 before the fed level.  Each of the three roundings is
    # within half a bf16 ulp of the column's largest |x|, so the two agree
    # to BF16_ULPS = 2 ulps of it; silent groups keep ``keep`` exactly.
    xb, kb = t(x).bfloat16(), t(keep).bfloat16()
    got_b = masked_tiered_aggregate(xb, mask, kb, de, dg, J)
    assert got_b.dtype == torch.bfloat16
    ref_b = _jax_levels(jnp.asarray(x, jnp.bfloat16), w, jnp.asarray(keep, jnp.bfloat16),
                        J, de, dg).astype(np.float32)
    got_b = got_b.float().numpy()
    colmax = np.abs(xb.float().numpy()).max(axis=0)
    ulp = 2.0 ** (np.floor(np.log2(colmax)) - 7)  # bf16 keeps 8 significant bits
    assert np.all(np.abs(got_b - ref_b) <= BF16_ULPS * ulp)
    assert np.array_equal(got_b[silent], kb.float().numpy()[silent])


@pytest.mark.parametrize("name", list(MASKS))
def test_q8_plain_version_keeps_the_pre_compression_tree(name):
    """The compressed fed level: the fed mean of the decoded uploads, a
    silent fleet keeps ``keep`` (the pre-compression entity result), as
    JAX's ``level_mean`` passes ``keep=original``."""
    w = MASKS[name]
    x = _x((12, 1000), 3)
    q, s = q8_quantize(torch.from_numpy(x), 256)
    keep = torch.from_numpy(_x((12, 1000), 4))
    mask = torch.from_numpy(w.astype(np.float32))
    got = masked_quantized_tiered_aggregate(q, s, mask, keep, 0, 1, 1, 256)
    decoded = (q.reshape(12, -1, 256).float() * s[..., None]).reshape(12, -1)[:, :1000]
    ref = _jax_levels(decoded.numpy(), w, keep.numpy(), 1, 0, 1)
    assert got.shape == (12, 1000)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, masked_quantized_tiered_aggregate_ref(q, s, mask, keep, 0, 1, 1, 256))
    if not w.any():
        assert torch.equal(got, keep)


def test_wrappers_count_no_plain_launch_and_check_arguments():
    reset_launches()
    x = torch.zeros(4, 8)
    masked_tiered_aggregate(x, torch.ones(4), x, 1, 1, 2)
    masked_aggregate_tree({"a": torch.zeros(4, 2, 3)}, torch.ones(4), 1, 1, 2, quantized=True)
    assert launches["masked_tiered_aggregate"] == launches["masked_tiered_aggregate_q8"] == 0
    with pytest.raises(ValueError, match="mask must be f32"):
        masked_tiered_aggregate(x, torch.ones(4, dtype=torch.bool), x, 1, 1, 2)
    with pytest.raises(ValueError, match="keep must be"):
        masked_tiered_aggregate(x, torch.ones(4), x.bfloat16(), 1, 1, 2)
    with pytest.raises(ValueError, match="divisible"):
        masked_tiered_aggregate(x, torch.ones(4), x, 1, 1, 3)


def _tree(seed, n=N):
    rng = np.random.default_rng(seed)
    shapes = [((3, 3, 3, 16), 16), ((3, 3, 16, 16), 16), ((3, 3, 16, 32), 32),
              ((512, 64), 64), ((64, 10), 10)]
    return {"frontend": {}, "head": {}, "units": [
        {"w": rng.normal(size=(n, *ws)).astype(np.float32),
         "b": rng.normal(size=(n, bs)).astype(np.float32)} for ws, bs in shapes]}


SYNC_MASKS = {"random": [1, 0, 1, 1, 0, 1, 1, 0], "zero group": [0, 0, 1, 0, 0, 0, 1, 1],
              "all zero": [0] * 8, "all ones": [1] * 8}


@pytest.mark.parametrize("name", list(SYNC_MASKS))
@pytest.mark.parametrize("codec", [None, 128], ids=["dense", "int8"])
@pytest.mark.parametrize("fed", [None, True, (False, True, True)],
                         ids=["by-step", "all-fed", "tier1-fed"])
def test_masked_synchronize_matches_jax(name, codec, fed):
    """``synchronize(mask=)`` on N=8, J2=4 against the JAX package's, with
    zero-participant groups and the int8 fed wire (key-less, as the engines
    run it): rtol 1e-5 / atol 1e-6; an all-zero mask returns every leaf."""
    n = 8
    tree = _tree(5, n)
    w = np.asarray(SYNC_MASKS[name], np.float32)
    jp = jax_default_plan(5, n, cuts=(1, 3), intervals=(2, 2, 1), entities=(n, 4, 1))
    cf = None
    if codec:
        jc = JaxInt8(tile=codec)
        cf = lambda x: jax.vmap(jc.transform)(x)  # noqa: E731
    ref = jax_synchronize(jax.tree.map(jnp.asarray, tree), jp, jnp.asarray(2), fed_round=fed,
                          compress_fn=cf, mask=jnp.asarray(w))
    tp = default_plan(5, n, cuts=(1, 3), intervals=(2, 2, 1), entities=(n, 4, 1))
    got = synchronize(params_from_numpy(tree, CPU), tp, 2, fed_round=fed,
                      compressor=Int8Stochastic(codec) if codec else None,
                      mask=torch.from_numpy(w))
    for u in range(5):
        for k in ("w", "b"):
            g = got["units"][u][k].numpy()
            np.testing.assert_allclose(g, np.asarray(ref["units"][u][k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{u}/{k}")
            if not w.any():
                assert np.array_equal(g, tree["units"][u][k])


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    hw = REDUCED.image_size
    return [{"images": rng.normal(size=(N, B, hw, hw, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (N, B)).astype(np.int32)}
            for _ in range(ROUNDS)]


def _round_masks(seed=7):
    m = np.random.default_rng(seed).random((ROUNDS, N)) < 0.6
    m[1, :2] = False  # a silent entity group in round 2
    return m.astype(np.float32)


def _flat(tree):
    return {f"units/{u}/{k}": v for u, unit in enumerate(tree["units"]) for k, v in unit.items()}


@pytest.mark.parametrize("opt_name,codec", [("sgd", None), ("adam", None), ("sgd", 128)],
                         ids=["sgd", "adam", "sgd-int8"])
def test_engine_a_masked_step_matches_jax(opt_name, codec):
    """REDUCED VGG, N=4, J2=2, 4 rounds with random masks (one silent
    group) through the per-round dispatch: losses at rtol 1e-4 (1e-3 over
    the int8 wire, as the unmasked engine), params at atol 1e-5 (one LSB of
    the int8 wire)."""
    lr = 0.05 if opt_name == "sgd" else 1e-3
    jopt = {"sgd": jsgd, "adam": jadam}[opt_name](lr)
    topt = {"sgd": sgd, "adam": adam}[opt_name](lr)
    masks = _round_masks()
    jmodel = JaxVgg(JAX_REDUCED)
    jplan = jax_default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS,
                             entities=ENTITIES)
    state = jax_init(jmodel, jplan, jopt, jax.random.PRNGKey(0))
    init = params_to_numpy(state.params)
    cache, jl = {}, []
    for r, batch in enumerate(_batches()):
        fed = tuple((r + 1) % I == 0 if I > 1 else True for I in jplan.intervals)
        if fed not in cache:
            cache[fed] = jax.jit(jax_build_step(
                jmodel, jplan, jopt, fed_round=fed, with_mask=True, sync_opt_state=True,
                compressor=JaxInt8(tile=codec) if codec else None))
        state, loss = cache[fed](state, jax.tree.map(jnp.asarray, batch), jnp.asarray(masks[r]))
        jl.append(float(loss))
    jp = params_to_numpy(state.params)

    plan = default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS, entities=ENTITIES)
    params = params_from_numpy(init, CPU)
    tstate = TrainState(params, topt.init(params), 0)
    model = VggModel(REDUCED)
    cache, tl = {}, []
    for r, batch in enumerate(_batches()):
        fed = tuple((r + 1) % I == 0 if I > 1 else True for I in plan.intervals)
        if fed not in cache:
            cache[fed] = build_train_step_a(
                model, plan, topt, fed_round=fed, with_mask=True, sync_opt_state=True,
                compressor=Int8Stochastic(codec) if codec else None)
        tstate, loss = cache[fed](tstate, train.to_device(batch, CPU), torch.from_numpy(masks[r]))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3 if codec else 1e-4)
    for k, v in _flat(jp).items():
        atol = float(np.abs(v).max()) / 127.0 if codec else 1e-5
        np.testing.assert_allclose(_flat(params_to_numpy(tstate.params))[k], v, atol=atol,
                                   err_msg=k)


def _port_run(masks, with_mask=True, opt_name="adam", codec=None, rounds=ROUNDS):
    init = params_to_numpy(VggModel(REDUCED).init_params(torch.Generator().manual_seed(3), CPU))
    from repro_torch.core import replicate_for_clients

    params = replicate_for_clients(params_from_numpy(init, CPU), N)
    opt = {"sgd": sgd, "adam": adam}[opt_name](1e-3)
    state = TrainState(params, opt.init(params), 0)
    plan = default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS, entities=ENTITIES)
    dispatch = train.make_dispatch(VggModel(REDUCED), plan, opt,
                                   compressor=Int8Stochastic(codec) if codec else None)
    states, losses = [state], []
    for r, batch in enumerate(_batches()[:rounds]):
        m = torch.from_numpy(masks[r]) if with_mask else None
        state, loss = dispatch(state, train.to_device(batch, CPU), r, m)
        states.append(state)
        losses.append(loss)
    return states, losses


@pytest.mark.parametrize("codec", [None, 128], ids=["dense", "int8"])
def test_all_zero_mask_is_an_exact_no_op(codec):
    """Every param and optimizer moment bit for bit as it was, loss exactly
    0.0 — over the int8 fed wire too (a silent fleet keeps its
    pre-compression params)."""
    states, losses = _port_run(np.zeros((ROUNDS, N), np.float32), codec=codec)
    for s in states[1:]:
        for a, b in zip(_flat(params_to_numpy(s.params)).values(),
                        _flat(params_to_numpy(states[0].params)).values()):
            assert np.array_equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(
            s.opt_state["m"]["units"][0].values(), states[0].opt_state["m"]["units"][0].values()))
    assert all(float(v) == 0.0 for v in losses)
    assert masked_mean_loss(torch.ones(4), torch.zeros(4)).item() == 0.0


def test_all_ones_mask_equals_unmasked_at_the_ragged_collapse_tolerance():
    """B1m divides Σ x by the participant count where B1 sums x/N: equal
    to f32 rounding (rtol 1e-5 / atol 1e-6), as the ragged collapse."""
    ones = np.ones((ROUNDS, N), np.float32)
    masked, ml = _port_run(ones, opt_name="sgd")
    plain, pl = _port_run(ones, with_mask=False, opt_name="sgd")
    np.testing.assert_allclose([float(v) for v in ml], [float(v) for v in pl], rtol=RTOL)
    for k, v in _flat(params_to_numpy(plain[-1].params)).items():
        np.testing.assert_allclose(_flat(params_to_numpy(masked[-1].params))[k], v,
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_masked_ragged_sync_raises_naming_a11():
    from repro_torch.core import class_tier_members

    plan = default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS, entities=ENTITIES)
    members = class_tier_members(REDUCED.n_units, [CUTS], [0] * N, CPU)
    step = build_train_step_a(VggModel(REDUCED), plan, sgd(0.1), with_mask=True,
                              class_members=members)
    params = VggModel(REDUCED).init_params(torch.Generator().manual_seed(0), CPU)
    from repro_torch.core import replicate_for_clients

    params = replicate_for_clients(params, N)
    with pytest.raises(NotImplementedError, match="A11"):
        step(TrainState(params, (), 0), train.to_device(_batches()[0], CPU), torch.ones(N))
