"""The port's online control loop (``repro_torch.control`` and the API's
``mode="control"``) against the JAX package's, on the same inputs.

The control modules are NumPy float64 in both packages, so the window's
tables, the telemetry, the drift reports, the piecewise bound and every
controller decision equal JAX's with ``==``; only the re-solve's wall clock
(``solve_seconds``, ``solve_ms``) is never compared.  The API's control
mode trains REDUCED VGG (at the loader's 32x32 images) from JAX's init
carried through NumPy: its decisions, segments and bounds equal JAX's, its
losses agree to rtol 1e-4 and every migrated state and the final params to
atol 1e-5.
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.vgg16_cifar10 as jax_vgg_config
import repro_torch.configs.vgg16_cifar10 as vgg_config
from repro import api as J
from repro import control as JC
from repro.configs.vgg16_cifar10 import SPEC as JAX_VGG
from repro.core import HsflProblem as JProblem
from repro.core import SystemSpec as JSystem
from repro.core import build_profile as jax_profile
from repro.core import synthetic_hyperspec as jax_hyper
from repro.core import theorem1_bound as jax_thm1
from repro.core.engine import TrainState as JTrainState
from repro.core.engine import replicate_for_clients as jax_replicate
from repro.sim import make_trace as jax_trace
from repro_torch import api as T
from repro_torch import control as TC
from repro_torch.api.build import check_capabilities
from repro_torch.configs.vgg16_cifar10 import SPEC as VGG
from repro_torch.core import (
    HsflProblem, SystemSpec, build_profile, solve_bcd, synthetic_hyperspec, theorem1_bound,
)
from repro_torch.models import params_to_numpy
from repro_torch.models.vgg import build_model
from repro_torch.sim import TraceLatency, make_trace
from repro_torch.sim.scenarios import SystemTrace

CPU = torch.device("cpu")
CUTS = (3, 8)


def _problems(seed=0, N=8, J_=2):
    """``tests/test_control.py``'s small problem, built in both packages."""
    out = []
    for vgg, prof, sysm, hyp, thm, prob in (
            (JAX_VGG, jax_profile, JSystem, jax_hyper, jax_thm1, JProblem),
            (VGG, build_profile, SystemSpec, synthetic_hyperspec, theorem1_bound, HsflProblem)):
        p = prof(vgg, batch=2)
        system = sysm.paper_three_tier(num_clients=N, num_edges=J_, seed=seed)
        hp = hyp(VGG.n_units, N, seed=seed)
        out.append(prob(p, system, hp, thm(hp, 500, (2, 2, 1), CUTS)))
    return out


def _states_equal(a, b):
    assert np.array_equal(a.available, b.available)
    for f in ("compute_mult", "link_up_mult", "link_down_mult", "fed_up_mult",
              "fed_down_mult"):
        x, y = getattr(a, f), getattr(b, f)
        assert len(x) == len(y), f
        for u, v in zip(x, y):
            assert np.array_equal(u, v), f


# --------------------------------------------------------------------------- #
# the window, the telemetry, the drift report and the bound: == JAX's
# --------------------------------------------------------------------------- #


def test_windowed_tables_equal_jax_after_every_push_across_an_eviction_wrap():
    """Window 3, 6 pushes of flaky-wan: after every push the whole-lattice
    split/agg tables, the scalar lookups, ``q_tiers`` and ``version`` equal
    JAX's; the wrap really moves the tables."""
    jp, tp = _problems()
    W, R = 3, 6
    jt = jax_trace("flaky-wan", jp.profile, jp.system, rounds=R, seed=5)
    tt = make_trace("flaky-wan", tp.profile, tp.system, rounds=R, seed=5)
    jw = JC.WindowedLatency(jp.profile, jp.system, jp.cut_lattice(), window=W)
    tw = TC.WindowedLatency(tp.profile, tp.system, tp.cut_lattice(), window=W)
    lat = tp.cut_lattice()
    assert np.array_equal(lat, jp.cut_lattice())
    probe = [tuple(int(c) for c in lat[k]) for k in (0, len(lat) // 2, len(lat) - 1)]
    tables = []
    for r in range(R):
        js, ts = jt.round_state(r), tt.round_state(r)
        _states_equal(ts, js)
        jw.push(js)
        tw.push(ts)
        assert tw.version == jw.version == r + 1
        assert tw.n_obs == jw.n_obs == min(r + 1, W)
        split, agg = tw.split_T_batch(lat), tw.agg_T_batch(lat)
        assert np.array_equal(split, jw.split_T_batch(lat))
        assert np.array_equal(agg, jw.agg_T_batch(lat))
        for cuts in probe:
            assert tw.split_T(cuts) == jw.split_T(cuts)
            for m in range(tp.M - 1):
                assert tw.agg_T(cuts, m) == jw.agg_T(cuts, m)
        assert np.array_equal(tw.q_tiers(), jw.q_tiers())
        tables.append(split)
    assert not np.array_equal(tables[W - 1], tables[W]), "the wrap moved nothing"


@pytest.mark.parametrize("scenario", ["flaky-wan", "diurnal-churn"])
def test_windowed_equals_trace_latency_bit_for_bit(scenario):
    """The port's window fed a trace's rounds prices the lattice as the
    port's ``TraceLatency`` over those rounds, bit for bit (batch and
    scalar paths), also past a wrap."""
    _, p = _problems()
    trace = make_trace(scenario, p.profile, p.system, rounds=7, seed=1)
    win = TC.WindowedLatency(p.profile, p.system, p.cut_lattice(), window=4)
    for r in range(7):
        win.push(trace.round_state(r))
    states = list(win.states())
    mini = SystemTrace("window", p.profile, p.system, 4, 0, lambda r: states[r])
    tl = TraceLatency(mini, quantile=0.5, backend="numpy")
    lat = p.cut_lattice()
    assert np.array_equal(win.split_T_batch(lat), tl.split_T_batch(lat))
    assert np.array_equal(win.agg_T_batch(lat), tl.agg_T_batch(lat))
    for k in (0, len(lat) - 1):
        cuts = tuple(int(c) for c in lat[k])
        assert win.split_T(cuts) == tl.split_T(cuts)
        for m in range(p.M - 1):
            assert win.agg_T(cuts, m) == tl.agg_T(cuts, m)


def test_windowed_guards_raise_as_jax():
    _, p = _problems()
    win = TC.WindowedLatency(p.profile, p.system, p.cut_lattice(), window=4)
    with pytest.raises(ValueError, match="no observed rounds"):
        win.split_T(CUTS)
    with pytest.raises(ValueError, match="window must be"):
        TC.WindowedLatency(p.profile, p.system, p.cut_lattice(), window=0)
    win.push(make_trace("flaky-wan", p.profile, p.system, rounds=1, seed=0).round_state(0))
    with pytest.raises(KeyError, match="not on the priced lattice"):
        win.split_T((0, 0))
    with pytest.raises(ValueError, match="lattice mismatch"):
        win.split_T_batch(p.cut_lattice()[:3])


def _nan_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def test_observe_round_and_reconstruct_state_equal_jax_field_by_field():
    """Eight diurnal-churn rounds (absent clients report NaN) with a mask,
    a loss and a fault count: every field of the observation and of the
    reconstructed ``RoundState`` equals JAX's."""
    jp, tp = _problems()
    jt = jax_trace("diurnal-churn", jp.profile, jp.system, rounds=8, seed=3, p_min=0.4)
    tt = make_trace("diurnal-churn", tp.profile, tp.system, rounds=8, seed=3, p_min=0.4)
    rng = np.random.default_rng(0)
    saw_absent = False
    for r in range(8):
        mask = rng.random(tp.system.num_clients) < 0.7
        kw = dict(mask=mask, loss=float(r) + 0.25, n_faulty=r % 3)
        jo, to = JC.observe_round(jt, r, CUTS, **kw), TC.observe_round(tt, r, CUTS, **kw)
        saw_absent |= not to.available.all()
        for f in ("round_index", "cuts", "loss", "n_faulty"):
            assert getattr(to, f) == getattr(jo, f), f
        for f in ("available", "mask"):
            assert np.array_equal(getattr(to, f), getattr(jo, f)), f
        for f in ("stage_durations", "fed_up", "fed_down"):
            x, y = getattr(to, f), getattr(jo, f)
            assert len(x) == len(y) and all(_nan_equal(u, v) for u, v in zip(x, y)), f
        _states_equal(TC.reconstruct_state(to, tp.profile, tp.system),
                      JC.reconstruct_state(jo, jp.profile, jp.system))
    assert saw_absent, "the scenario dropped no client"


@pytest.mark.parametrize("case", range(6))
def test_detect_drift_equals_jax(case):
    rng = np.random.default_rng(case)
    agg_p = rng.uniform(0.5, 2.0, 2)
    agg_o = agg_p * rng.uniform(0.6, 1.4, 2)
    if case % 3 == 0:
        agg_o[0] = agg_p[0] = 0.0  # a single-entity tier: skipped
    args = (rng.uniform(1, 2), rng.uniform(1, 2), agg_o, agg_p, rng.uniform(0.5, 1),
            rng.uniform(0.5, 1), [0.05, 0.25, 0.5][case % 3])
    kw = dict(fault_rate_obs=0.3 * (case % 2), fault_tol=[1.0, 0.2][case % 2])
    got, ref = TC.detect_drift(*args, **kw), JC.detect_drift(*args, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


SEGMENTS = [
    [((200,), (4, 2, 1), (3, 8), 0.0, None, 0.0)],
    [((120,), (4, 2, 1), (3, 8), 0.0, None, 0.0), ((30,), (1, 1, 1), (2, 4), 0.1, 0.7, 0.0),
     ((150,), (8, 4, 1), (5, 9), 0.0, (0.8, 0.9, 1.0), 1e-3)],
    [((7,), (2, 2, 1), (1, 2), 0.05, 0.75, 0.0), ((9,), (3, 5, 1), (1, 3), 0.05, 0.9, 0.0)],
]


@pytest.mark.parametrize("segs", range(len(SEGMENTS)))
def test_piecewise_bound_and_progress_equal_jax(segs):
    hp_j = jax_hyper(VGG.n_units, 8, seed=segs)
    hp_t = synthetic_hyperspec(VGG.n_units, 8, seed=segs)
    make = lambda B: [B(r[0], i, c, omega=o, participation=q, dp_sigma2=d)  # noqa: E731
                      for r, i, c, o, q, d in SEGMENTS[segs]]
    assert TC.piecewise_bound(hp_t, make(TC.BoundSegment)) == JC.piecewise_bound(
        hp_j, make(JC.BoundSegment))
    assert TC.progress_target(hp_t) == JC.progress_target(hp_j)
    eps = theorem1_bound(hp_t, 500, (2, 2, 1), CUTS)
    for _, i, c, o, q, _ in SEGMENTS[segs]:
        assert TC.progress_per_round(hp_t, eps, i, c, o, q) == JC.progress_per_round(
            hp_j, eps, i, c, o, q)


@pytest.mark.parametrize("schedule", [((1, 1, 1), (3, 8), 10), ((4, 2, 1), (3, 8), 200),
                                      ((2, 5, 1), (5, 9), 1000)])
def test_one_segment_is_theorem1_bit_for_bit(schedule):
    intervals, cuts, R = schedule
    hp = synthetic_hyperspec(VGG.n_units, 8, seed=0)
    seg = TC.BoundSegment(R, intervals, cuts)
    assert TC.piecewise_bound(hp, [seg]) == theorem1_bound(hp, R, intervals, cuts)
    with pytest.raises(ValueError, match="at least one segment"):
        TC.piecewise_bound(hp, [])
    with pytest.raises(ValueError, match="positive"):
        TC.BoundSegment(0, (1, 1, 1), CUTS)


def test_warm_resolve_finds_the_cold_optimum():
    """Warm-seeded BCD on the windowed problem equals a cold solve on a
    ``TraceLatency`` over the same rounds, from the default anchor."""
    _, p = _problems()
    trace = make_trace("flaky-wan", p.profile, p.system, rounds=8, seed=4)
    win = TC.WindowedLatency(p.profile, p.system, p.cut_lattice(), window=8)
    for r in range(8):
        win.push(trace.round_state(r))
    wp = dataclasses.replace(p, latency_model=win)
    anchor = solve_bcd(wp, backend="numpy")
    warm = solve_bcd(wp, init_cuts=anchor.cuts,
                     init_intervals=tuple(max(1, i - 1) for i in anchor.intervals),
                     backend="numpy", warm_start=True)
    states = list(win.states())
    mini = SystemTrace("window", p.profile, p.system, 8, 0, lambda r: states[r])
    cold = solve_bcd(dataclasses.replace(
        p, latency_model=TraceLatency(mini, quantile=0.5, backend="numpy")), backend="numpy")
    assert (warm.cuts, tuple(warm.intervals)) == (cold.cuts, tuple(cold.intervals))
    assert warm.theta == cold.theta


# --------------------------------------------------------------------------- #
# the controller and the replay
# --------------------------------------------------------------------------- #

# PERF.md §4's VGG-16 control configuration, on the host only
CONTROL_SPEC = J.paper_spec(eps_scale=20.0).replace(
    name="control-vgg16",
    scenario=J.ScenarioCfg(name="flaky-wan", rounds=16, seed=0, quantile=0.5),
    participation=J.ParticipationCfg(target_rate=0.9),
    solver=J.SolverCfg(kind="fixed", cuts=(3, 8), intervals=(2, 2, 1)),
    run=J.RunCfg(mode="control", rounds=16, lr=5e-4),
    control=J.ControlCfg(window=4, min_window=4, cooldown=2, rel_tol=0.1, backend="numpy"),
)


def _port(spec):
    return T.ExperimentSpec.from_dict(json.loads(json.dumps(spec.to_dict())))


def _drive(pkg, built, backend):
    """The control loop's host half (``_control`` without the engine): the
    trace's masks at the current cuts, one observation a round, the
    decisions; masks re-sampled at each switch's cuts."""
    run_mod = sys.modules[f"{pkg.__name__}.api.run"]
    ctl = built.spec.control
    cuts, intervals = tuple(built.spec.solver.cuts), tuple(built.spec.solver.intervals)
    c = pkg.control.Controller(
        built.problem, cuts, intervals, window=ctl.window, check_every=ctl.check_every,
        rel_tol=ctl.rel_tol, cooldown=ctl.cooldown, min_window=ctl.min_window,
        quantile=ctl.quantile, warm_start=ctl.warm_start, backend=backend,
        max_switches=ctl.max_switches, fault_tol=ctl.fault_tol)
    masks = run_mod._participation_masks(built, cuts)
    for r in range(built.spec.run.rounds):
        mrow = np.asarray(masks[r % masks.shape[0]], dtype=bool)
        c.observe(pkg.control.observe_round(built.trace, r % built.trace.rounds, c.cuts,
                                            mask=mrow, loss=1.0))
        d = c.maybe_replan(r)
        if d is not None and d.switched:
            masks = run_mod._participation_masks(built, d.new_cuts)
    return c


def _decision(d):
    """A decision less its wall clock."""
    return (d.round_index, d.trigger, d.old_cuts, d.old_intervals, d.new_cuts,
            d.new_intervals, d.switched, dataclasses.asdict(d.drift))


@pytest.mark.parametrize("backend", ["numpy", "torch:cpu", "scalar"])
def test_controller_decides_as_jax(backend):
    """VGG-16's control configuration (flaky-wan, participation at the
    0.9 deadline), 16 rounds: the port's decision list on NumPy, on
    ``torch:cpu`` float64 tables and on the scalar walk equals JAX's on
    NumPy, drift reports included; it switches cuts at least once."""
    ref = _drive(sys.modules["repro"], J.build(CONTROL_SPEC), "numpy")
    got = _drive(sys.modules["repro_torch"], T.build(_port(CONTROL_SPEC)), backend)
    assert [_decision(d) for d in got.decisions] == [_decision(d) for d in ref.decisions]
    assert got.n_switches == ref.n_switches >= 1
    assert any(d.switched and d.new_cuts != d.old_cuts for d in got.decisions)
    assert len(got.resolve_seconds) == len(ref.resolve_seconds)
    assert got.fault_rate() == ref.fault_rate()


def test_controller_reads_a_spec_backend_as_the_port_names_it():
    _, p = _problems()
    assert TC.Controller(p, CUTS, (2, 2, 1), backend="jax").backend == "torch"
    assert TC.Controller(p, CUTS, (2, 2, 1), backend="auto").backend == "auto"
    with pytest.raises(ValueError, match="not on the problem's cut lattice"):
        TC.Controller(p, (0, 0), (2, 2, 1))


class _Clock:
    """A host clock that ticks 2^-10 s a read, the same in both packages."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 2.0 ** -10
        return self.t


def _slowed(state, factor):
    return dataclasses.replace(state, compute_mult=tuple(c * factor for c in state.compute_mult))


@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
def test_replay_equals_jax(adaptive, monkeypatch):
    """``replay`` over a trace whose compute slows 4x from round 6, static
    and under a controller: time-to-ε, rounds-to-ε, the switch count, the
    per-round wall and progress ledgers equal JAX's, on one deterministic
    clock in both controllers."""
    monkeypatch.setattr(sys.modules["repro.control.controller"], "time", _Clock())
    monkeypatch.setattr(sys.modules["repro_torch.control.controller"], "time", _Clock())
    out = []
    for pkg, (vgg, prof, sysm, hyp, thm, prob, trace) in (
            (JC, (JAX_VGG, jax_profile, JSystem, jax_hyper, jax_thm1, JProblem, jax_trace)),
            (TC, (VGG, build_profile, SystemSpec, synthetic_hyperspec, theorem1_bound,
                  HsflProblem, make_trace))):
        hp = hyp(VGG.n_units, 8, seed=0)
        eps = thm(hp, 40, (2, 2, 1), CUTS)
        p = prob(prof(vgg, batch=2), sysm.paper_three_tier(num_clients=8, num_edges=2, seed=0),
                 hp, eps)
        base = trace("homogeneous-paper", p.profile, p.system, rounds=60, seed=0)
        tr = type(base)("slow", p.profile, p.system, 60, 0,
                        lambda r, b=base: _slowed(b.round_state(r), 0.25 if r >= 6 else 1.0))
        ctl = (pkg.Controller(p, CUTS, (2, 2, 1), window=4, min_window=4, cooldown=3,
                              rel_tol=0.25, backend="numpy") if adaptive else None)
        out.append(pkg.replay(tr, p.hyper, eps, CUTS, (2, 2, 1), controller=ctl))
    ref, got = out
    assert ref.reached and got.reached
    assert got.time_to_eps == ref.time_to_eps
    assert got.rounds_to_eps == ref.rounds_to_eps
    assert got.n_switches == ref.n_switches
    assert np.array_equal(got.wall, ref.wall) and np.array_equal(got.progress, ref.progress)
    assert got.solve_overhead == ref.solve_overhead
    assert got.schedule_log == ref.schedule_log
    if adaptive:
        assert got.n_switches >= 1


def test_control_exports_are_the_jax_ones():
    """The whole ``__all__``, Engine B's migration included as the
    function ``control.migrate`` defines (``tests/test_torch_migrate.py``
    holds it to JAX's)."""
    from repro_torch.control import migrate as port_migrate

    assert TC.__all__ == JC.__all__
    assert all(callable(getattr(TC, name)) for name in TC.__all__)
    for name in ("migrate_params_b", "migrate_state_b"):
        assert getattr(TC, name) is getattr(port_migrate, name)


# --------------------------------------------------------------------------- #
# the API's mode="control"
# --------------------------------------------------------------------------- #


def _api_spec(case):
    """REDUCED VGG (at 32x32 images), N=4, J2=2, batch 2, flaky-wan, 4
    rounds from cuts (1, 3) and intervals (2, 2, 1): it switches cuts at
    round 1.  ``participation``: the deadline at the 0.75 finish-time
    quantile; ``faults``: crashes and ``nan`` corruption under the guard."""
    spec = J.paper_spec().replace(
        name="control-reduced",
        model=J.ModelCfg(arch="vgg16-cifar10", variant="reduced", batch=2),
        system=J.SystemCfg(preset="paper-three-tier", num_clients=4, num_edges=2),
        scenario=J.ScenarioCfg(name="flaky-wan", rounds=16, seed=0, quantile=0.5),
        participation=J.ParticipationCfg(target_rate=0.75) if case == "participation" else None,
        solver=J.SolverCfg(kind="fixed", cuts=(1, 3), intervals=(2, 2, 1)),
        run=J.RunCfg(mode="control", rounds=4, lr=0.01, dataset_size=64, log_every=0),
        control=J.ControlCfg(window=4, min_window=2, cooldown=1, rel_tol=0.1,
                             backend="numpy"),
    )
    if case == "faults":
        spec = spec.replace(faults=J.FaultsCfg(crash_rate=0.2, corrupt_rate=0.2, seed=1))
    return spec


@pytest.fixture
def vgg32(monkeypatch):
    """Both packages' REDUCED VGG at the loader's 32x32 images."""
    monkeypatch.setattr(jax_vgg_config, "REDUCED",
                        dataclasses.replace(jax_vgg_config.REDUCED, image_size=32))
    monkeypatch.setattr(vgg_config, "REDUCED",
                        dataclasses.replace(vgg_config.REDUCED, image_size=32))


def _record(monkeypatch, pkg_name, seen):
    """Wrap a package's ``_make_step`` and ``control.migrate_state`` to keep
    every step's output state and every migrated state."""
    run_mod = sys.modules[f"{pkg_name}.api.run"]
    ctl = sys.modules[f"{pkg_name}.control"]
    make_step, migrate = run_mod._make_step, ctl.migrate_state

    def hooked(*a, **k):
        step = make_step(*a, **k)

        def wrapped(*x):
            seen["state"], loss = step(*x)
            return seen["state"], loss

        return wrapped

    def migrated(*a, **k):
        out = migrate(*a, **k)
        seen.setdefault("migrated", []).append(out.params)
        return out

    monkeypatch.setattr(run_mod, "_make_step", hooked)
    monkeypatch.setattr(ctl, "migrate_state", migrated)


def _leaves_close(a, b):
    x = jax.tree.leaves(params_to_numpy(a))
    y = jax.tree.leaves(jax.tree.map(np.asarray, b))
    assert len(x) == len(y)
    for u, v in zip(x, y):
        np.testing.assert_allclose(u, v, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["plain", "participation", "faults"])
def test_control_mode_matches_jax_from_a_carried_init(case, vgg32, monkeypatch):
    """``run(mode="control")`` on the CPU against JAX's from one init (the
    port's, from ``run.seed``, carried to JAX through NumPy): switches
    (less ``solve_ms``), segments, final schedule and both bounds with
    ``==``; losses at rtol 1e-4; every migrated state and the final params
    at atol 1e-5."""
    js = _api_spec(case)
    ts = _port(js)
    model = T.build(ts).model_spec
    p0 = params_to_numpy(build_model(model).init_params(
        torch.Generator().manual_seed(ts.run.seed), CPU))

    def carried(model, plan, opt, key):
        params = jax_replicate(jax.tree.map(jnp.asarray, p0), plan.num_clients)
        return JTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))

    monkeypatch.setattr(sys.modules["repro.core.engine"], "init_state_a", carried)
    jseen, tseen = {}, {}
    _record(monkeypatch, "repro", jseen)
    _record(monkeypatch, "repro_torch", tseen)
    ref = J.run(js)
    got = T.run(ts, device="cpu")
    a, b = got.control, ref.control
    assert a.keys() == b.keys()
    assert b["n_switches"] >= 1 and any(s["old_cuts"] != s["new_cuts"] for s in b["switches"])
    for k in ("n_switches", "n_resolves", "segments", "final_cuts", "final_intervals",
              "initial_cuts", "initial_intervals", "piecewise_bound", "static_bound",
              "n_faulty_total", "windowed_fault_rate", "engine", "rounds"):
        assert a[k] == b[k], k
    strip = lambda ss: [{k: v for k, v in s.items() if k != "solve_ms"} for s in ss]  # noqa: E731
    assert strip(a["switches"]) == strip(b["switches"])
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-4)
    assert len(tseen["migrated"]) == len(jseen["migrated"]) == b["n_switches"]
    for t, j in zip(tseen["migrated"], jseen["migrated"]):
        _leaves_close(t, j)
    _leaves_close(tseen["state"].params, jseen["state"].params)
    for k in ("theta", "cuts", "intervals", "latency", "provenance"):
        assert got.to_dict()[k] == ref.to_dict()[k], k
    back = T.ExperimentResult.from_dict(json.loads(json.dumps(got.to_dict())))
    assert back.control["n_switches"] == a["n_switches"]


def test_control_mode_runs_on_the_card_or_raises(vgg32):
    """The default device is the card: without one ``run`` raises; with
    ``device="cpu"`` it trains there.  No switch: one segment, and the
    piecewise bound is the static bound bit for bit."""
    js = _port(_api_spec("plain")).replace(
        control=T.ControlCfg(window=4, min_window=4, rel_tol=10.0, backend="numpy"),
        run=T.RunCfg(mode="control", rounds=2, lr=0.01, dataset_size=64, log_every=0))
    check_capabilities(js)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.run(js)
    res = T.run(js, device="cpu").control
    assert res["n_switches"] == 0 and len(res["segments"]) == 1
    assert res["piecewise_bound"] == res["static_bound"]
    assert all(np.isfinite(res["losses"]))
