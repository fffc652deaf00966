"""Per-tier energy pricing in the port, against the JAX package's
``repro.energy``: the verbatim NumPy tables, the scalar chain, the problem's
round energy and budget mask, the per-class energy and the BCD / MA optima
under a binding budget all equal JAX's with ``==`` — on NumPy and on the
port's float64 tensors on the CPU (``torch:cpu``)."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import itertools

import numpy as np
import pytest

import repro.energy as je
import repro_torch.energy as te
from repro.configs.vgg16_cifar10 import SPEC as JAX_VGG
from repro.core import (
    ClassBatchedEvaluator as JaxClassEval, CutClassSpec as JaxClasses,
    HsflProblem as JaxProblem, SystemSpec as JaxSystem, build_profile as jax_profile,
    solve_bcd as jax_bcd, solve_bcd_classes as jax_bcd_classes, solve_ma as jax_ma,
    synthetic_hyperspec as jax_hyper,
)
from repro.core.classes import class_round_energy as jax_class_round_energy
from repro.core.convergence import theorem1_bound as jax_bound
from repro_torch.configs.vgg16_cifar10 import SPEC as VGG
from repro_torch.core import (
    ClassBatchedEvaluator, CutClassSpec, HsflProblem, SystemSpec, build_profile, solve_bcd,
    solve_bcd_classes, solve_ma, synthetic_hyperspec,
)
from repro_torch.core.classes import class_round_energy
from repro_torch.core.convergence import theorem1_bound

BACKENDS = ["numpy", "torch:cpu"]


def _problems(seed=0, energy_kw=None, eps_scale=8.0):
    jprof = jax_profile(JAX_VGG, batch=16)
    jsys = JaxSystem.paper_three_tier(seed=seed)
    jh = jax_hyper(JAX_VGG.n_units, 20, beta=3.0, seed=seed)
    tprof = build_profile(VGG, batch=16)
    tsys = SystemSpec.paper_three_tier(seed=seed)
    th = synthetic_hyperspec(VGG.n_units, 20, beta=3.0, seed=seed)
    jen = None if energy_kw is None else je.default_energy_spec(3, **energy_kw)
    ten = None if energy_kw is None else te.default_energy_spec(3, **energy_kw)
    jp = JaxProblem(jprof, jsys, jh, eps=eps_scale * jax_bound(jh, 10**9, [1, 1, 1], (3, 8)),
                    energy=jen)
    tp = HsflProblem(tprof, tsys, th,
                     eps=eps_scale * theorem1_bound(th, 10**9, [1, 1, 1], (3, 8)), energy=ten)
    return jp, tp


@pytest.mark.parametrize("seed", range(3))
def test_energy_tables_and_scalar_chain_equal_jax(seed):
    """split / agg lattice tables, the scalar chain and the round energy of
    random price vectors: the port's floats are JAX's."""
    rng = np.random.default_rng(seed)
    jp, tp = _problems(seed=seed)
    kw = dict(compute_j_per_flop=tuple(rng.uniform(1e-12, 1e-10, 3)),
              act_j_per_byte=tuple(rng.uniform(1e-8, 1e-6, 2)),
              model_j_per_byte=tuple(rng.uniform(1e-8, 1e-6, 2)))
    jspec, tspec = je.EnergySpec(**kw), te.EnergySpec(**kw)
    lattice = tp.cut_lattice()
    assert np.array_equal(lattice, jp.cut_lattice())
    assert np.array_equal(te.split_energy_lattice(tp.profile, tp.system, tspec, lattice),
                          je.split_energy_lattice(jp.profile, jp.system, jspec, lattice))
    assert np.array_equal(te.agg_energy_lattice(tp.profile, tp.system, tspec, lattice),
                          je.agg_energy_lattice(jp.profile, jp.system, jspec, lattice))
    assert np.array_equal(te.stage_energy_prices(tspec, tp.system, 3),
                          je.stage_energy_prices(jspec, jp.system, 3))
    for k in rng.choice(lattice.shape[0], size=8, replace=False):
        cuts = tuple(int(c) for c in lattice[k])
        iv = tuple(int(v) for v in rng.integers(1, 9, 3))
        assert te.split_energy(tp.profile, tp.system, tspec, cuts) == je.split_energy(
            jp.profile, jp.system, jspec, cuts)
        assert te.round_energy(tp.profile, tp.system, tspec, cuts, iv) == je.round_energy(
            jp.profile, jp.system, jspec, cuts, iv)
        for m in range(2):
            assert te.agg_energy(tp.profile, tp.system, tspec, cuts, m) == je.agg_energy(
                jp.profile, jp.system, jspec, cuts, m)


@pytest.mark.parametrize("backend", BACKENDS)
def test_problem_round_energy_and_mask_equal_jax(backend):
    """``HsflProblem.round_energy`` / ``energy_feasible`` and the batched
    evaluator's round-energy rows equal JAX's with ``==``."""
    jp, tp = _problems(seed=1, energy_kw=dict(budget_j_per_round=2e3))
    jev, tev = jp.evaluator("numpy"), tp.evaluator(backend)
    rng = np.random.default_rng(1)
    for _ in range(4):
        iv = tuple(int(v) for v in rng.integers(1, 9, 3))
        assert np.array_equal(tev.round_energy(iv), jev.round_energy(iv))
        for k in rng.choice(tev.lattice.shape[0], size=4, replace=False):
            cuts = tuple(int(c) for c in tev.lattice[k])
            assert tp.round_energy(iv, cuts) == jp.round_energy(iv, cuts)
            assert tp.energy_feasible(iv, cuts) == jp.energy_feasible(iv, cuts)


@pytest.mark.parametrize("backend", BACKENDS)
def test_class_energy_equals_jax(backend):
    jp, tp = _problems(seed=2, energy_kw={})
    jm, tm = JaxClasses.uniform(20, 2, (2, 4)), CutClassSpec.uniform(20, 2, (2, 4))
    jev = JaxClassEval(jp, jm, backend="numpy")
    tev = ClassBatchedEvaluator(tp, tm, backend=backend)
    assign = np.random.default_rng(0).integers(0, tev.lattice.shape[0], size=(10, 2))
    iv = (2, 3, 1)
    assert np.array_equal(tev.round_energy_rows(assign, iv), jev.round_energy_rows(assign, iv))
    for r in range(3):
        cuts = tuple(tuple(int(c) for c in tev.lattice[assign[r, c]]) for c in range(2))
        assert class_round_energy(tp, CutClassSpec(class_of=tm.class_of, cuts=cuts), iv) == (
            jax_class_round_energy(jp, JaxClasses(class_of=jm.class_of, cuts=cuts), iv))


def test_energy_spec_validation_matches_jax():
    cases = [(((1e-11, -1.0, 1e-11), (0.0, 0.0), (0.0, 0.0)), {}, None),
             (((0.0,) * 3, (0.0,) * 2, (0.0,) * 2), dict(budget_j_per_round=0.0), None),
             (((0.0,) * 2, (0.0,) * 2, (0.0,) * 2), {}, 3)]
    for args, kw, M in cases:
        with pytest.raises(ValueError) as jerr:
            s = je.EnergySpec(*args, **kw)
            if M:
                s.validate_for(M)
        with pytest.raises(ValueError) as terr:
            s = te.EnergySpec(*args, **kw)
            if M:
                s.validate_for(M)
        assert str(terr.value) == str(jerr.value)
    assert te.default_energy_spec(3) == te.EnergySpec(
        **{f: getattr(je.default_energy_spec(3), f) for f in
           ("compute_j_per_flop", "act_j_per_byte", "model_j_per_byte",
            "budget_j_per_round")})


def _binding_budget(prob, res0):
    e_opt = prob.round_energy(res0.intervals, res0.cuts)
    ev = prob.evaluator("numpy")
    floor = np.inf
    for I in itertools.product((1, 2, 4, 8, 16, 32, 64), repeat=prob.M - 1):
        iv = I + (1,)
        ok = ev.mem_ok & (ev.denominator(iv) > ev.d_min)
        if ok.any():
            floor = min(floor, float(ev.round_energy(iv)[ok].min()))
    return 0.5 * (floor + e_opt)


@pytest.mark.parametrize("backend", BACKENDS + ["scalar"])
def test_binding_budget_bcd_and_ma_optima_equal_jax(backend):
    """Free, priced-unbudgeted and binding-budget specs: BCD's optimum and
    Θ′ equal JAX's with ``==`` (the binding one moves it), and MA under
    the budget picks JAX's intervals."""
    jp0, _ = _problems(seed=0, energy_kw={})
    budget = _binding_budget(jp0, jax_bcd(jp0))
    for kw in (None, {}, dict(budget_j_per_round=budget)):
        jp, tp = _problems(seed=0, energy_kw=kw)
        a, b = jax_bcd(jp), solve_bcd(tp, backend=backend)
        assert (b.cuts, tuple(b.intervals), b.theta) == (a.cuts, tuple(a.intervals), a.theta)
        for cuts in (a.cuts, (3, 8)):
            ma, mb = jax_ma(jp, cuts, backend="numpy"), solve_ma(tp, cuts, backend=backend)
            assert tuple(mb.intervals) == tuple(ma.intervals) and mb.theta == ma.theta


def test_class_solve_under_budget_equals_jax():
    """The per-class BCD under a budget of twice what the single-cut
    optimum spends: the class solve's energy mask runs, JAX's optimum."""
    jp0, _ = _problems(seed=0, energy_kw={})
    r0 = jax_bcd(jp0)
    budget = 2.0 * jp0.round_energy(r0.intervals, r0.cuts)
    jp, tp = _problems(seed=0, energy_kw=dict(budget_j_per_round=budget))
    jm, tm = JaxClasses.uniform(20, 2, (3, 8)), CutClassSpec.uniform(20, 2, (3, 8))
    a = jax_bcd_classes(jp, jm, backend="numpy")
    b = solve_bcd_classes(tp, tm, backend="numpy")
    assert (b.spec.cuts, tuple(b.intervals), b.theta) == (a.spec.cuts, tuple(a.intervals),
                                                          a.theta)
