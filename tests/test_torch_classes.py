"""The port's per-class cut solve (``core/classes.py``) against the JAX
package: the spec and its constructors, the scalar oracle, the product
evaluator on both backends, and ``solve_ms_classes`` / ``solve_ma_classes``
/ ``solve_bcd_classes``, all NumPy float64 compared with ``==``."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro.core.classes as jclasses
import repro_torch.core as tcore
import repro_torch.core.classes as tclasses
from repro.configs.vgg16_cifar10 import SPEC as JAX_VGG
from repro_torch.configs.vgg16_cifar10 import SPEC as VGG

N_CLIENTS = 20
PKGS = {"jax": (jcore, jclasses, JAX_VGG), "torch": (tcore, tclasses, VGG)}


def make_problem(pkg, seed=0, eps_scale=10.0, hetero=0.0):
    """``tests/test_classes.py::make_problem`` built from either package:
    the paper's three tiers, N=20, J2=5, VGG-16 at batch 16, the odd half
    of the fleet's access links ``hetero`` times slower."""
    core, _, vgg = PKGS[pkg]
    prof = core.build_profile(vgg, batch=16)
    system = core.SystemSpec.paper_three_tier(seed=seed)
    if hetero:
        slow = np.ones(N_CLIENTS)
        slow[1::2] = 1.0 / float(hetero)

        def scaled(tiers):
            return (tiers[0] * slow,) + tuple(tiers[1:])

        system = dataclasses.replace(
            system, act_up=scaled(system.act_up), act_down=scaled(system.act_down),
            model_up=scaled(system.model_up), model_down=scaled(system.model_down))
    hp = core.synthetic_hyperspec(vgg.n_units, N_CLIENTS, beta=3.0, seed=seed)
    floor = core.theorem1_bound(hp, 10**9, [1, 1, 1], (3, 8))
    return core.HsflProblem(prof, system, hp, eps=eps_scale * floor)


def _spec(pkg, class_of, cuts):
    return PKGS[pkg][1].CutClassSpec(class_of=tuple(class_of), cuts=tuple(cuts))


def test_spec_and_assignment_match_jax():
    rates = np.array([5.0, 1.0, 5.0, 3.0, 2.0])
    for C in (1, 2, 3, 5):
        np.testing.assert_array_equal(tcore.banded_assignment(rates, C),
                                      jcore.banded_assignment(rates, C))
    for bad in (0, 6):
        with pytest.raises(ValueError, match="num_classes"):
            tcore.banded_assignment(rates, bad)
    t = tcore.CutClassSpec.from_rates([9.0, 1.0, 5.0, 7.0], 2, (2, 5))
    j = jcore.CutClassSpec.from_rates([9.0, 1.0, 5.0, 7.0], 2, (2, 5))
    assert (t.class_of, t.cuts) == (j.class_of, j.cuts)
    spec = tcore.CutClassSpec(class_of=(0, 1, 1, 0), cuts=((1, 3), (2, 4)))
    assert spec.class_sizes() == (2, 2) and spec.weights().sum() == 1.0
    np.testing.assert_array_equal(spec.client_cuts(), [[1, 3], [2, 4], [2, 4], [1, 3]])
    assert tcore.CutClassSpec.uniform(6, 3, (2, 5)).is_uniform()
    for kw, msg in ((dict(class_of=(), cuts=()), "at least one class"),
                    (dict(class_of=(0, 2), cuts=((1, 2),) * 3), "contiguous"),
                    (dict(class_of=(0, 1), cuts=((1, 2), (1,))), "same number of cuts"),
                    (dict(class_of=(0,), cuts=((4, 2),)), "non-decreasing")):
        with pytest.raises(ValueError, match=msg):
            tcore.CutClassSpec(**kw)
    np.testing.assert_array_equal(tclasses.product_assignments(3, 2),
                                  jclasses.product_assignments(3, 2))


@pytest.mark.parametrize("class_cuts", [((3, 8), (3, 8)), ((2, 6), (4, 9)),
                                        ((4, 5), (1, 2)), ((1, 15), (7, 7))])
def test_scalar_oracle_matches_jax(class_cuts):
    t, j = make_problem("torch", hetero=8.0), make_problem("jax", hetero=8.0)
    class_of = [c % 2 for c in range(N_CLIENTS)]
    ts, js = _spec("torch", class_of, class_cuts), _spec("jax", class_of, class_cuts)
    assert tclasses.class_split_T(t, ts) == jclasses.class_split_T(j, js)
    np.testing.assert_array_equal(tclasses.class_agg_T(t, ts), jclasses.class_agg_T(j, js))
    np.testing.assert_array_equal(tclasses.class_tier_d(t, ts), jclasses.class_tier_d(j, js))
    assert tclasses.class_memory_ok(t, ts) == jclasses.class_memory_ok(j, js)
    for iv in ((3, 2, 1), (1, 1, 1), (6, 3, 1)):
        assert t.class_theta(ts, iv) == j.class_theta(js, iv)
        assert tclasses.class_total_T(t, ts, iv, 100) == jclasses.class_total_T(j, js, iv, 100)
        assert tclasses.class_rounds(t, ts, iv) == jclasses.class_rounds(j, js, iv)


@pytest.mark.parametrize("backend", ["numpy", "torch:cpu"])
def test_product_evaluator_matches_jax_numpy(backend):
    """The product evaluator's tables (``split_class`` from the per-client
    ``chain_matrix``) and row prices equal JAX's NumPy evaluator, on either
    backend of the port."""
    t, j = make_problem("torch", seed=1), make_problem("jax", seed=1)
    rng = np.random.default_rng(7)
    class_of = (0, 1) + tuple(int(x) for x in rng.integers(0, 2, N_CLIENTS - 2))
    ts, js = _spec("torch", class_of, ((3, 8),) * 2), _spec("jax", class_of, ((3, 8),) * 2)
    ev_t = tcore.ClassBatchedEvaluator(t, ts, backend=backend)
    ev_j = jcore.ClassBatchedEvaluator(j, js, backend="numpy")
    assert ev_t.backend == backend
    np.testing.assert_array_equal(ev_t.split_class, ev_j.split_class)
    np.testing.assert_array_equal(ev_t.d_tab, ev_j.d_tab)
    rows = rng.integers(0, ev_t.K, size=(40, 2))
    for iv in ((3, 2, 1), (1, 1, 1)):
        np.testing.assert_array_equal(ev_t.theta_rows(rows, iv), ev_j.theta_rows(rows, iv))
        np.testing.assert_array_equal(ev_t.numerator(rows, iv), ev_j.numerator(rows, iv))
        np.testing.assert_array_equal(ev_t.denominator(rows, iv), ev_j.denominator(rows, iv))
    np.testing.assert_array_equal(ev_t.agg_T(rows), ev_j.agg_T(rows))


def _same(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "spec":
            x, y = (x.cuts, tuple(x.class_of)), (y.cuts, tuple(y.class_of))
        assert x == y, (f.name, x, y)


@pytest.mark.parametrize("backend", ["numpy", "torch:cpu"])
def test_solve_bcd_classes_heterogeneous_fleet_matches_jax(backend):
    """The heterogeneous problem ``make_problem(seed=0, hetero=8.0)``.  Single-cut
    BCD gives cuts (4, 5) and intervals (3, 1, 1); C=2 banded by fed uplink
    splits into class cuts ((4, 5), (1, 2)) with intervals (3, 2, 1) — every
    number equal to JAX's, Θ′ with ``==``."""
    t, j = make_problem("torch", hetero=8.0), make_problem("jax", hetero=8.0)
    single_t = tcore.solve_bcd(t, backend=backend)
    single_j = jcore.solve_bcd(j, backend="numpy")
    _same(single_t, single_j)
    ts = tcore.CutClassSpec.from_rates(t.system.model_up[0], 2, single_t.cuts)
    js = jcore.CutClassSpec.from_rates(j.system.model_up[0], 2, single_j.cuts)
    assert ts.class_of == js.class_of == tuple([1, 0] * 10)
    res_t = tcore.solve_bcd_classes(t, ts, backend=backend)
    res_j = jcore.solve_bcd_classes(j, js, backend="numpy")
    _same(res_t, res_j)
    assert res_t.class_cuts == ((4, 5), (1, 2))
    assert tuple(res_t.intervals) == (3, 2, 1)
    assert res_t.theta == res_j.theta < single_t.theta


def test_ms_and_ma_classes_match_jax():
    t, j = make_problem("torch", seed=3, hetero=8.0), make_problem("jax", seed=3, hetero=8.0)
    single = jcore.solve_ms(j, (2, 2, 1), backend="numpy")
    ts = tcore.CutClassSpec.from_rates(t.system.model_up[0], 2, single.cuts)
    js = jcore.CutClassSpec.from_rates(j.system.model_up[0], 2, single.cuts)
    for kw in (dict(), dict(product_budget=1)):
        _same(tcore.solve_ms_classes(t, ts, (2, 2, 1), backend="torch:cpu", **kw),
              jcore.solve_ms_classes(j, js, (2, 2, 1), backend="numpy", **kw))
    mixed_t = ts.with_cuts(((4, 5), (1, 2)))
    mixed_j = js.with_cuts(((4, 5), (1, 2)))
    _same(tcore.solve_ma_classes(t, mixed_t), jcore.solve_ma_classes(j, mixed_j))


def test_bcd_classes_uniform_fleet_collapses():
    """On the homogeneous tpu-pod fleet every class lands on the single-cut
    optimum, as in JAX."""
    results = {}
    for pkg in ("torch", "jax"):
        core, _, vgg = PKGS[pkg]
        system = core.SystemSpec.tpu_pod_mapping()
        N = system.num_clients
        hp = core.synthetic_hyperspec(vgg.n_units, N, beta=3.0, seed=0)
        floor = core.theorem1_bound(hp, 10**9, [1] * system.M, (3, 8))
        p = core.HsflProblem(core.build_profile(vgg, batch=16), system, hp, eps=10 * floor)
        single = core.solve_bcd(p, backend="numpy")
        res = core.solve_bcd_classes(p, core.CutClassSpec.uniform(N, 2, single.cuts),
                                     backend="torch:cpu" if pkg == "torch" else "numpy")
        assert res.theta == single.theta
        assert all(c == single.cuts for c in res.class_cuts)
        results[pkg] = (res.theta, res.intervals, res.class_cuts)
    assert results["torch"] == results["jax"]


def test_latency_model_pricing_rejected():
    p = dataclasses.replace(make_problem("torch"), latency_model=object())
    spec = tcore.CutClassSpec.uniform(N_CLIENTS, 2, (3, 8))
    with pytest.raises(ValueError, match="nominally"):
        tclasses.class_split_T(p, spec)
    with pytest.raises(ValueError, match="nominally"):
        tcore.ClassBatchedEvaluator(p, spec)
