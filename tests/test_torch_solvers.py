"""The port's analytic solve path against the JAX package: the VGG analytic
counts, ``latency``, ``convergence``, ``problem``, the batched evaluator,
and the MA/MS/BCD solvers.  These are NumPy float64 ported verbatim, so
every table and every optimum is compared with ``==``.  The port's
``torch`` backend is held to the NumPy backends of both packages (the JAX
package's own ``jax`` float64 backend does not run on this jax build)."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core as jcore
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
from repro.compress import CompressionSpec as JaxCompressionSpec
from repro.configs.vgg16_cifar10 import REDUCED as JAX_REDUCED, SPEC as JAX_VGG
from repro.core.convergence import (
    bound_constants as jax_bound_constants, tier_G2_sums as jax_tier_G2_sums,
)
from repro.core.latency import LayerProfile as JaxLayerProfile
from repro_torch.compress import CompressionSpec
from repro_torch.configs.vgg16_cifar10 import REDUCED, SPEC as VGG
from repro_torch.core.batched import AUTO_TORCH_MIN_ELEMS, resolve_backend
from repro_torch.core.convergence import bound_constants, tier_G2_sums
from repro_torch.core.latency import LayerProfile

PKGS = {"jax": (jcore, JaxCompressionSpec, JaxLayerProfile),
        "torch": (tcore, CompressionSpec, LayerProfile)}
BACKENDS = ["numpy", "torch:cpu", "scalar"]


@pytest.mark.parametrize("variant", ["SPEC", "REDUCED"])
def test_vgg_spec_analytic_methods_match_jax(variant):
    t, j = {"SPEC": (VGG, JAX_VGG), "REDUCED": (REDUCED, JAX_REDUCED)}[variant]
    for u in range(t.n_units):
        for b in (1, 16):
            assert t.unit_flops_fwd(u, b) == j.unit_flops_fwd(u, b)
            assert t.unit_act_bytes_at(u, b) == j.unit_act_bytes_at(u, b)
            assert t.unit_act_bytes_at(u, b, 2) == j.unit_act_bytes_at(u, b, 2)
        assert t.unit_param_count(u) == j.unit_param_count(u)
    assert t.unit_act_bytes(16) == j.unit_act_bytes(16)
    assert t.frontend_param_count() == j.frontend_param_count() == 0
    assert t.head_param_count() == j.head_param_count() == 0
    assert t.active_param_count() == j.active_param_count() == t.total_param_count()


def _spec(pkg, arch):
    configs = jconfigs if pkg == "jax" else tconfigs
    if arch == "vgg16-cifar10":
        return JAX_VGG if pkg == "jax" else VGG
    return configs.get_reduced(arch)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("arch", ["vgg16-cifar10", "smollm-135m", "qwen3-32b"])
def test_build_profile_tables_match_jax(arch, optimizer):
    kw = dict(batch=16, optimizer=optimizer, **({} if arch == "vgg16-cifar10" else {"seq": 64}))
    t = tcore.build_profile(_spec("torch", arch), **kw)
    j = jcore.build_profile(_spec("jax", arch), **kw)
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
    for f in dataclasses.fields(j.prefix):
        np.testing.assert_array_equal(getattr(t.prefix, f.name), getattr(j.prefix, f.name))


def _paper_problem(pkg, seed=0, hetero=0.0, compression=None, participation=None):
    """``tests/test_classes.py::make_problem`` built from either package."""
    core, Comp, _ = PKGS[pkg]
    N = 20
    prof = core.build_profile(JAX_VGG if pkg == "jax" else VGG, batch=16)
    system = core.SystemSpec.paper_three_tier(seed=seed)
    if hetero:
        slow = np.ones(N)
        slow[1::2] = 1.0 / float(hetero)

        def scaled(tiers):
            return (tiers[0] * slow,) + tuple(tiers[1:])

        system = dataclasses.replace(
            system, act_up=scaled(system.act_up), act_down=scaled(system.act_down),
            model_up=scaled(system.model_up), model_down=scaled(system.model_down))
    hp = core.synthetic_hyperspec(16, N, beta=3.0, seed=seed)
    floor = core.theorem1_bound(hp, 10**9, [1, 1, 1], (3, 8))
    p = core.HsflProblem(prof, system, hp, eps=10.0 * floor)
    if compression:
        p = p.with_compression(Comp.uniform(3, model_ratio=compression,
                                            act_ratio=compression, omega=0.05))
    if participation:
        p = p.with_participation(core.ParticipationSpec(q=participation))
    return p


def _pod_problem(pkg):
    core = PKGS[pkg][0]
    prof = core.build_profile(JAX_VGG if pkg == "jax" else VGG, batch=16)
    system = core.SystemSpec.tpu_pod_mapping()
    N = system.num_clients
    hp = core.synthetic_hyperspec(16, N, beta=3.0, seed=0)
    floor = core.theorem1_bound(hp, 10**9, [1] * system.M, (3, 8))
    return core.HsflProblem(prof, system, hp, eps=10 * floor)


def _random_problem(pkg, seed):
    """test_batched.py's random problem generator, from either package."""
    core, Comp, Profile = PKGS[pkg]
    rng = np.random.default_rng(seed)
    M = 2 + seed % 2
    U = int(rng.integers(6, 14))
    N = int(rng.integers(3, 9))
    params = rng.uniform(1e3, 1e7, U)
    prof = Profile(
        n_units=U, flops_fwd=rng.uniform(1e8, 1e12, U), flops_bwd=rng.uniform(1e8, 2e12, U),
        act_bytes=rng.uniform(1e2, 1e6, U), grad_act_bytes=rng.uniform(1e2, 1e6, U),
        param_bytes=params, opt_bytes=params * rng.uniform(0.0, 2.0),
        frontend_param_bytes=float(rng.uniform(0.0, 1e6)),
        head_param_bytes=float(rng.uniform(0.0, 1e6)), batch=int(rng.integers(1, 32)))
    J2 = int(rng.integers(1, N + 1))
    mem = tuple(np.full(N if m == 0 else (J2 if m == 1 else 1),
                        float(rng.choice([1e9, 1e12, 1e15]))) for m in range(M))
    system = core.SystemSpec(
        M=M, num_clients=N, entities=(N, J2) if M == 2 else (N, J2, 1),
        compute=tuple(rng.uniform(1e11, 1e13, N) for _ in range(M)),
        act_up=tuple(rng.uniform(1e7, 1e9, N) for _ in range(M - 1)),
        act_down=tuple(rng.uniform(1e7, 1e9, N) for _ in range(M - 1)),
        model_up=tuple(rng.uniform(1e7, 1e9, N if m == 0 else J2) for m in range(M - 1)),
        model_down=tuple(rng.uniform(1e7, 1e9, N if m == 0 else J2) for m in range(M - 1)),
        memory=mem)
    hp = core.synthetic_hyperspec(U, N, beta=float(rng.uniform(1, 10)),
                                  g2_scale=float(rng.uniform(1, 30)), seed=seed)
    even = tuple(max(1, (m + 1) * U // M) for m in range(M - 1))
    floor = core.theorem1_bound(hp, 10**9, [1] * M, even)
    comp = None
    if seed % 3 == 0:
        comp = Comp(act_ratio=tuple(rng.uniform(0.05, 1.0, M - 1)),
                    model_ratio=tuple(rng.uniform(0.05, 1.0, M - 1)),
                    omega=float(rng.uniform(0.0, 0.5)))
    return core.HsflProblem(prof, system, hp, eps=float(rng.uniform(1.5, 10)) * floor,
                            compression=comp)


def test_convergence_matches_jax():
    for seed in range(3):
        t = tcore.synthetic_hyperspec(16, 20, beta=3.0, seed=seed)
        j = jcore.synthetic_hyperspec(16, 20, beta=3.0, seed=seed)
        np.testing.assert_array_equal(t.G2, j.G2)
        assert t.sigma2_sum == j.sigma2_sum
        for cuts in ((3, 8), (1, 2), (4, 5)):
            np.testing.assert_array_equal(tier_G2_sums(t.G2, cuts),
                                          jax_tier_G2_sums(j.G2, cuts))
            for iv in ([1, 1, 1], [3, 2, 1], [8, 4, 1]):
                assert tcore.theorem1_bound(t, 500, iv, cuts) == \
                    jcore.theorem1_bound(j, 500, iv, cuts)
                assert tcore.corollary1_rounds(t, 0.5, iv, cuts) == \
                    jcore.corollary1_rounds(j, 0.5, iv, cuts)
        assert bound_constants(t, 0.5, omega=0.1) == jax_bound_constants(j, 0.5, omega=0.1)
        w = np.array([0.25, 0.75])
        np.testing.assert_array_equal(
            tcore.class_weighted_G2_sums(t.G2, [(3, 8), (1, 2)], w),
            jcore.class_weighted_G2_sums(j.G2, [(3, 8), (1, 2)], w))


@pytest.mark.parametrize("kw", [dict(), dict(hetero=8.0), dict(compression=0.25),
                                dict(participation=(0.9, 0.8, 1.0))],
                         ids=["paper", "hetero", "compressed", "participation"])
def test_problem_terms_match_jax_on_the_whole_lattice(kw):
    """Θ′, N, D, T_S, T_A, tier_d and C5 on every cut vector, with ``==``."""
    t, j = _paper_problem("torch", **kw), _paper_problem("jax", **kw)
    assert t.constants() == j.constants()
    np.testing.assert_array_equal(t.cut_lattice(), j.cut_lattice())
    for cuts in t.iter_cut_vectors():
        assert t.split_T(cuts) == j.split_T(cuts)
        np.testing.assert_array_equal(t.agg_T(cuts), j.agg_T(cuts))
        np.testing.assert_array_equal(t.tier_d(cuts), j.tier_d(cuts))
        assert t.memory_feasible(cuts) == j.memory_feasible(cuts)
        for iv in ([1, 1, 1], [3, 2, 1], [6, 2, 1]):
            assert t.theta(iv, cuts) == j.theta(iv, cuts)
            assert t.numerator(iv, cuts) == j.numerator(iv, cuts)
            assert t.denominator(iv, cuts) == j.denominator(iv, cuts)


@pytest.mark.parametrize("kw", [dict(), dict(hetero=8.0), dict(compression=0.25),
                                dict(participation=(0.9, 0.8, 1.0))],
                         ids=["paper", "hetero", "compressed", "participation"])
def test_batched_evaluator_torch_backend_bit_equal_numpy(kw):
    """The torch backend (float64 on the CPU here; on the card in
    ``chip_smoke.py``) builds the same tables as NumPy, bit for bit, and
    both equal the JAX package's NumPy tables."""
    t, j = _paper_problem("torch", **kw), _paper_problem("jax", **kw)
    ev_n, ev_t, ev_j = t.evaluator("numpy"), t.evaluator("torch:cpu"), j.evaluator("numpy")
    assert ev_t.backend == "torch:cpu" and ev_n.backend == "numpy"
    for name in ("split", "agg", "d", "mem_ok"):
        np.testing.assert_array_equal(getattr(ev_t, name), getattr(ev_n, name), err_msg=name)
        np.testing.assert_array_equal(getattr(ev_n, name), getattr(ev_j, name), err_msg=name)
    for iv in ([1, 1, 1], [3, 2, 1], [8, 4, 1]):
        np.testing.assert_array_equal(ev_t.theta(iv), ev_j.theta(iv))


def _same(a, b):
    """Two solver results of the two packages, field by field with ``==``."""
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if hasattr(y, "cuts") and hasattr(y, "class_of"):  # a CutClassSpec
            x, y = (x.cuts, tuple(x.class_of)), (y.cuts, tuple(y.class_of))
        assert x == y, (f.name, x, y)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("which", ["paper", "hetero", "pod"])
def test_solvers_match_jax(which, backend):
    if which == "pod":
        t, j = _pod_problem("torch"), _pod_problem("jax")
    else:
        kw = dict(hetero=8.0) if which == "hetero" else {}
        t, j = _paper_problem("torch", **kw), _paper_problem("jax", **kw)
    res_t = tcore.solve_bcd(t, backend=backend)
    res_j = jcore.solve_bcd(j, backend="numpy")
    _same(res_t, res_j)
    for iv in (list(res_j.intervals), [2, 2, 1]):
        _same(tcore.solve_ms(t, iv, backend=backend), jcore.solve_ms(j, iv, backend="numpy"))
    for cuts in (res_j.cuts, (2, 2), (3, 8)):
        _same(tcore.solve_ma(t, cuts, backend=backend), jcore.solve_ma(j, cuts, backend="numpy"))
    if which == "hetero":  # the single-cut BCD optimum of this problem
        assert res_t.cuts == (4, 5) and res_t.intervals == (3, 1, 1)
        assert res_t.theta == res_j.theta


@pytest.mark.parametrize("seed", range(6))
def test_bcd_matches_jax_on_random_problems(seed):
    t, j = _random_problem("torch", seed), _random_problem("jax", seed)
    _same(tcore.solve_bcd(t, backend="torch:cpu"), jcore.solve_bcd(j, backend="numpy"))
    _same(tcore.solve_bcd(t, backend="numpy"), jcore.solve_bcd(j, backend="scalar"))


def test_bruteforce_oracles_match_jax():
    t, j = _paper_problem("torch"), _paper_problem("jax")
    _same(tcore.solve_ms_bruteforce(t, [3, 2, 1]), jcore.solve_ms_bruteforce(j, [3, 2, 1]))
    _same(tcore.solve_ma_bruteforce(t, (3, 8), i_max=12),
          jcore.solve_ma_bruteforce(j, (3, 8), i_max=12))
    assert tcore.total_latency(t.profile, t.system, (3, 8), [3, 2, 1], 100) == \
        jcore.total_latency(j.profile, j.system, (3, 8), [3, 2, 1], 100)


def test_resolve_backend():
    assert resolve_backend("numpy") == "numpy"
    assert resolve_backend("torch:cpu") == "torch:cpu"
    for bad in ("jax", "cuda", "numpy:cpu", "scaler"):
        with pytest.raises(ValueError, match="unknown batched backend"):
            resolve_backend(bad)
    assert resolve_backend("auto", work_elems=10) == "numpy"
    assert resolve_backend("auto", work_elems=AUTO_TORCH_MIN_ELEMS - 1) == "numpy"
    big = AUTO_TORCH_MIN_ELEMS
    assert resolve_backend("auto", work_elems=big) == (
        "torch" if torch.cuda.is_available() else "numpy")
    with pytest.raises(ValueError, match="unknown batched backend"):
        tcore.solve_ma(_paper_problem("torch"), (3, 8), backend="scaler")


def test_torch_backend_runs_on_the_card_unless_named():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_backend("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _paper_problem("torch").evaluator("torch")
