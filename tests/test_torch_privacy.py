"""DP uplinks in the port, against the JAX package's ``repro.privacy``: the
accountant (a verbatim NumPy copy) equal with ``==``; the mechanism's clip at
z = 0 at f32 tolerance; its noise (torch cannot draw ``jax.random``'s
numbers) held on its statistics and its reproducibility; the ε budget
through BCD equal with ``==``; Engine A's DP fed wire at z = 0 against JAX's
losses, and at z > 0 reproducible from one seed."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.privacy as jp
import repro_torch.privacy as tp
from repro.compress import Int8Stochastic as JaxInt8
from repro.configs.vgg16_cifar10 import REDUCED as JAX_REDUCED, SPEC as JAX_VGG
from repro.core import (
    HsflProblem as JaxProblem, SystemSpec as JaxSystem, build_profile as jax_profile,
    build_train_step_a as jax_build_step, init_state_a as jax_init, solve_bcd as jax_bcd,
    synthetic_hyperspec as jax_hyper,
)
from repro.core.convergence import theorem1_bound as jax_bound
from repro.core.tiers import default_plan as jax_default_plan
from repro.models.vgg import VggModel as JaxVgg
from repro.optim import sgd as jsgd
from repro_torch._tree import tree_leaves
from repro_torch.compress import Int8Stochastic
from repro_torch.configs.vgg16_cifar10 import REDUCED, SPEC as VGG
from repro_torch.core import (
    HsflProblem, SystemSpec, TrainState, build_profile, build_train_step_a, default_plan,
    solve_bcd, synthetic_hyperspec, synchronize,
)
from repro_torch.core.convergence import theorem1_bound
from repro_torch.core.tiers import FedWire
from repro_torch.launch import train
from repro_torch.models import VggModel, params_from_numpy, params_to_numpy
from repro_torch.optim import sgd

CPU = torch.device("cpu")
ORACLE_GRID = [(0.8, 1.00, 1), (1.2, 0.50, 10), (2.0, 0.25, 100), (4.0, 0.05, 1000),
               (8.0, 1.00, 37), (16.0, 0.75, 500), (0.0, 1.0, 3)]


@pytest.mark.parametrize("z,q,R", ORACLE_GRID)
def test_accountant_equals_jax(z, q, R):
    """ε, the RDP vector and its ε, the oracle and the round cap: ``==``."""
    ja, ta = jp.Accountant(noise_multiplier=z, sampling_rate=q), tp.Accountant(
        noise_multiplier=z, sampling_rate=q)
    assert ta.epsilon(R) == ja.epsilon(R)
    assert ta.epsilon(0) == ja.epsilon(0)
    if z > 0:
        assert np.array_equal(tp.rdp_vector(z, q), jp.rdp_vector(z, q))
        for alpha in (2, 7, 64):
            assert tp.rdp_epsilon(alpha, z, q) == jp.rdp_epsilon(alpha, z, q)
        assert tp.epsilon_oracle(z, q, R, 1e-5) == jp.epsilon_oracle(z, q, R, 1e-5)
        for budget in (1.0, 10.0, 80.0, math.inf):
            assert tp.rounds_for_budget(z, q, 1e-5, budget) == jp.rounds_for_budget(
                z, q, 1e-5, budget)
            assert ta.max_rounds(budget) == ja.max_rounds(budget)


def test_privacy_spec_equals_jax():
    for kw in (dict(noise_multiplier=3.0, clip=0.5, dim=1000),
               dict(noise_multiplier=0.0, clip=1.0),
               dict(noise_multiplier=2.0, clip=0.1, epsilon_budget=5.0, delta=1e-6)):
        js, ts = jp.PrivacySpec(**kw), tp.PrivacySpec(**kw)
        assert ts.dp_sigma2 == js.dp_sigma2
        assert ts.max_rounds(0.5) == js.max_rounds(0.5)
        assert ts.accountant(0.5).epsilon(7) == js.accountant(0.5).epsilon(7)
    for kw, match in ((dict(noise_multiplier=-1.0, clip=1.0), "noise_multiplier"),
                      (dict(noise_multiplier=1.0, clip=0.0), "clip"),
                      (dict(noise_multiplier=1.0, clip=1.0, delta=1.0), "delta"),
                      (dict(noise_multiplier=1.0, clip=1.0, epsilon_budget=0.0), "epsilon"),
                      (dict(noise_multiplier=1.0, clip=1.0, dim=0), "dim")):
        with pytest.raises(ValueError, match=match):
            tp.PrivacySpec(**kw)
    with pytest.raises(ValueError, match="clip"):
        tp.DPMechanism(clip=0.0, noise_multiplier=1.0)


@pytest.mark.parametrize("clip", [0.5, 3.0, 1e-4])
def test_mechanism_clip_at_zero_noise_matches_jax(clip):
    """z = 0: per-row L2 clipping at f32 tolerance against JAX; a row
    inside the clip ball comes back bit for bit; bf16 keeps its dtype."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 4, 3)).astype(np.float32)
    x[0] *= 1e-6
    ref = np.asarray(jp.DPMechanism(clip=clip, noise_multiplier=0.0).transform(
        jnp.asarray(x), 3, salt=1))
    mech = tp.DPMechanism(clip=clip, noise_multiplier=0.0)
    got = mech.transform(torch.from_numpy(x), 3, salt=1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-9)
    if clip > 1e-3:
        assert np.array_equal(got.numpy()[0], x[0])
    xb = torch.from_numpy(x).bfloat16()
    assert mech.transform(xb, 3).dtype == torch.bfloat16


def test_mechanism_noise_reproducible_salted_and_gaussian():
    """Same (seed, step, salt): the same draw; another step, salt or seed:
    another.  The noise is N(0, (z·C)²): over 2·10⁵ coordinates its mean is
    within 5 standard errors of 0 and its std within 1% of z·C; the row
    inside the clip ball is its own value plus the noise."""
    x = torch.ones((4, 50_000), dtype=torch.float32) * 1e-9
    mech = tp.DPMechanism(clip=0.5, noise_multiplier=2.0, seed=7)
    a = mech.transform(x, 5, salt=0)
    assert torch.equal(a, mech.transform(x, 5, salt=0))
    for other in (mech.transform(x, 6, salt=0), mech.transform(x, 5, salt=1),
                  tp.DPMechanism(clip=0.5, noise_multiplier=2.0, seed=8).transform(x, 5)):
        assert not torch.equal(a, other)
    noise = (a - x).double()
    sd = 2.0 * 0.5
    assert abs(noise.mean().item()) < 5 * sd / math.sqrt(noise.numel())
    assert abs(noise.std().item() / sd - 1.0) < 0.01
    # rows drawn from one generator per leaf: rows are not copies of each other
    assert not torch.equal(noise[0], noise[1])


def _problems(eps_scale):
    jprof = jax_profile(JAX_VGG, batch=16)
    jsys = JaxSystem.paper_three_tier(seed=0)
    jh = jax_hyper(JAX_VGG.n_units, 20, beta=3.0, seed=0)
    jprob = JaxProblem(jprof, jsys, jh, eps=eps_scale * jax_bound(jh, 10**9, [1, 1, 1], (3, 8)))
    tprof = build_profile(VGG, batch=16)
    tsys = SystemSpec.paper_three_tier(seed=0)
    th = synthetic_hyperspec(VGG.n_units, 20, beta=3.0, seed=0)
    tprob = HsflProblem(tprof, tsys, th,
                        eps=eps_scale * theorem1_bound(th, 10**9, [1, 1, 1], (3, 8)))
    return jprob, tprob


@pytest.mark.parametrize("budget", ["none", "zero-noise", "tight"])
def test_privacy_budget_through_bcd_equals_jax(budget):
    """The ε budget as a denominator floor: BCD's optimum, Θ′ and d_min
    equal JAX's with ``==`` — unconstrained, at z = 0 (collapse) and under
    a budget that moves the optimum."""
    jprob, tprob = _problems(8.0)
    if budget == "zero-noise":
        kw = dict(noise_multiplier=0.0, clip=1.0, dim=10**6)
    elif budget == "tight":
        res0 = jax_bcd(jprob)
        r_star = jprob.rounds(res0.intervals, res0.cuts)
        r_min = jprob.rounds((1,) * jprob.M, res0.cuts)
        eps_b = jp.Accountant(noise_multiplier=16.0, sampling_rate=1.0).epsilon(
            int(0.3 * r_min + 0.7 * r_star))
        kw = dict(noise_multiplier=16.0, clip=0.1, dim=1, epsilon_budget=eps_b)
    if budget != "none":
        jprob = jprob.with_privacy(jp.PrivacySpec(**kw))
        tprob = tprob.with_privacy(tp.PrivacySpec(**kw))
    a, b = jax_bcd(jprob), solve_bcd(tprob)
    assert (b.cuts, tuple(b.intervals), b.theta) == (a.cuts, tuple(a.intervals), a.theta)
    assert tprob.d_min() == jprob.d_min() and tprob.dp_sigma2 == jprob.dp_sigma2
    if budget == "tight":
        assert tprob.d_min() > 0.0


def _vgg_tree(seed, n=8):
    rng = np.random.default_rng(seed)
    shapes = [((3, 3, 3, 16), 16), ((3, 3, 16, 16), 16), ((3, 3, 16, 32), 32),
              ((512, 64), 64), ((64, 10), 10)]
    return {"frontend": {}, "head": {}, "units": [
        {"w": rng.normal(size=(n, *ws)).astype(np.float32),
         "b": rng.normal(size=(n, bs)).astype(np.float32)} for ws, bs in shapes]}


@pytest.mark.parametrize("codec", [None, 128], ids=["dp", "dp-int8"])
@pytest.mark.parametrize("mask", [None, [1, 1, 0, 1, 0, 0, 1, 1]], ids=["full", "masked"])
def test_dp_fed_wire_at_zero_noise_matches_jax_synchronize(codec, mask):
    """``synchronize`` with the DP wire at z = 0 (clip only, then the codec)
    against JAX's composed ``compress_fn``: rtol 1e-5 / atol 1e-6 (one
    quantization step over the int8 wire)."""
    tree = _vgg_tree(3)
    jm = jp.DPMechanism(clip=2.0, noise_multiplier=0.0)
    salt = iter(range(10**6))
    jc = None if codec is None else JaxInt8(tile=codec)

    def cf(x):
        y = jm.transform(x, 1, salt=next(salt))
        return y if jc is None else jax.vmap(jc.transform)(y)

    jplan = jax_default_plan(5, 8, cuts=(1, 3), intervals=(2, 2, 1), entities=(8, 4, 1))
    from repro.core.tiers import synchronize as jax_sync

    ref = jax_sync(jax.tree.map(jnp.asarray, tree), jplan, jnp.asarray(1), compress_fn=cf,
                   mask=None if mask is None else jnp.asarray(mask, jnp.float32))
    plan = default_plan(5, 8, cuts=(1, 3), intervals=(2, 2, 1), entities=(8, 4, 1))
    wire = FedWire(tp.DPMechanism(clip=2.0, noise_multiplier=0.0), 1,
                   None if codec is None else Int8Stochastic(codec))
    got = synchronize(params_from_numpy(tree, CPU), plan, 1, compressor=wire,
                      mask=None if mask is None else torch.tensor(mask, dtype=torch.float32))
    for u in range(5):
        for k in ("w", "b"):
            a = np.asarray(ref["units"][u][k])
            atol = float(np.abs(a).max()) / 127.0 if codec else 1e-6
            np.testing.assert_allclose(got["units"][u][k].numpy(), a, rtol=1e-5, atol=atol)
    # the fed levels of tiers 0 and 1 cross the DP wire (tier 2 has one
    # entity): unit 0's two leaves, then units 1-2's four, salted 0..5
    assert wire._salt == 6


N, B, ROUNDS = 4, 2, 4
CUTS, INTERVALS, ENTITIES = (1, 3), (2, 2, 1), (4, 2, 1)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    hw = REDUCED.image_size
    return [{"images": rng.normal(size=(N, B, hw, hw, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (N, B)).astype(np.int32)}
            for _ in range(ROUNDS)]


@pytest.mark.parametrize("codec", [None, 128], ids=["dp", "dp-int8"])
def test_engine_a_privacy_at_zero_noise_matches_jax(codec):
    """Engine A with ``privacy=`` a z = 0 mechanism whose clip binds:
    losses at rtol 1e-4 (1e-3 over the int8 wire) over 4 REDUCED rounds,
    from JAX's init."""
    jmodel, jopt = JaxVgg(JAX_REDUCED), jsgd(0.01)
    jplan = jax_default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS,
                             entities=ENTITIES)
    state = jax_init(jmodel, jplan, jopt, jax.random.PRNGKey(0))
    init = params_to_numpy(state.params)
    step = jax.jit(jax_build_step(jmodel, jplan, jopt,
                                  privacy=jp.DPMechanism(clip=1.0, noise_multiplier=0.0),
                                  compressor=JaxInt8(tile=codec) if codec else None))
    jl = []
    for batch in _batches():
        state, loss = step(state, jax.tree.map(jnp.asarray, batch))
        jl.append(float(loss))
    plan = default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS, entities=ENTITIES)
    params = params_from_numpy(init, CPU)
    opt = sgd(0.01)
    tstate = TrainState(params, opt.init(params), 0)
    tstep = build_train_step_a(VggModel(REDUCED), plan, opt,
                               privacy=tp.DPMechanism(clip=1.0, noise_multiplier=0.0),
                               compressor=Int8Stochastic(codec) if codec else None)
    tl = []
    for batch in _batches():
        tstate, loss = tstep(tstate, train.to_device(batch, CPU))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3 if codec else 1e-4)


def _noisy_run(seed):
    init = VggModel(REDUCED).init_params(torch.Generator().manual_seed(0), CPU)
    from repro_torch.core import replicate_for_clients

    plan = default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=(1, 1, 1), entities=ENTITIES)
    params = replicate_for_clients(init, N)
    opt = sgd(0.01)
    step = build_train_step_a(VggModel(REDUCED), plan, opt,
                              privacy=tp.DPMechanism(clip=1.0, noise_multiplier=1.0, seed=seed))
    state = TrainState(params, opt.init(params), 0)
    for batch in _batches()[:2]:
        state, _ = step(state, train.to_device(batch, CPU))
    return state


def test_engine_a_noise_reproducible_and_replicas_agree():
    """z = 1: one seed reproduces the run bit for bit, another seed does
    not; with every fed level due each round, every client holds one value
    of every leaf after the round (the noised mean is broadcast)."""
    a, b, c = _noisy_run(3), _noisy_run(3), _noisy_run(4)
    la, lb, lc = (tree_leaves(s.params) for s in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not all(torch.equal(x, y) for x, y in zip(la, lc))
    for x in la:
        assert torch.equal(x, x[:1].expand_as(x))
