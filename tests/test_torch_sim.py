"""The port's fleet simulator (scenarios, event core, fleet fast path on
NumPy and on float64 tensors, robust pricing) against the JAX package's
NumPy paths, compared with ``==``.  The JAX package's own ``"jax"`` fleet
backend fails on this tree (no ``enable_x64`` in its jax), so the port's
device backend is held to JAX's NumPy backend."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.configs.vgg16_cifar10 import SPEC as JAX_VGG
from repro.core import (
    HsflProblem as JaxProblem, SystemSpec as JaxSystem, build_profile as jax_profile,
    solve_bcd as jax_solve_bcd, synthetic_hyperspec as jax_hyper,
)
from repro.core.batched import cut_lattice
from repro_torch import sim
from repro_torch.configs.vgg16_cifar10 import SPEC as VGG
from repro_torch.core.batched import spec_backend
from repro_torch.core import (
    HsflProblem, SystemSpec, build_profile, solve_bcd, synthetic_hyperspec,
)
from repro_torch.sim import fleet

CUTS, INTERVALS = (3, 8), (2, 3, 1)
EPS = 0.5
BACKENDS = ["numpy", "torch:cpu"]


def _setup(pkg, N=20, J=5, seed=0, batch=2):
    if pkg == "jax":
        return jax_profile(JAX_VGG, batch=batch), JaxSystem.paper_three_tier(
            num_clients=N, num_edges=J, seed=seed)
    return build_profile(VGG, batch=batch), SystemSpec.paper_three_tier(
        num_clients=N, num_edges=J, seed=seed)


def _traces(name, N=20, J=5, rounds=6, seed=3):
    return (jsim.make_trace(name, *_setup("jax", N, J), rounds=rounds, seed=seed),
            sim.make_trace(name, *_setup("torch", N, J), rounds=rounds, seed=seed))


def _states_equal(a, b):
    assert np.array_equal(a.available, b.available)
    for f in ("compute_mult", "link_up_mult", "link_down_mult", "fed_up_mult",
              "fed_down_mult"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            assert np.array_equal(x, y), f


@pytest.mark.parametrize("name", sorted(jsim.SCENARIOS))
def test_scenario_draws_equal_jax(name):
    jt, tt = _traces(name)
    assert sorted(sim.SCENARIOS) == sorted(jsim.SCENARIOS)
    assert sim.scenario_params(name) == jsim.scenario_params(name)
    for r in range(jt.rounds):
        _states_equal(jt.round_state(r), tt.round_state(r))


@pytest.mark.parametrize("name", sorted(jsim.SCENARIOS))
def test_events_equal_jax_and_fleet_equals_events(name):
    """The event core equals JAX's; within the port, the fleet path equals
    the event core bit for bit on NumPy and on float64 tensors."""
    jt, tt = _traces(name)
    ref = jsim.simulate(jt, CUTS, INTERVALS)
    ev = sim.simulate(tt, CUTS, INTERVALS)
    for f in ("split", "agg", "fired", "total", "participants"):
        assert np.array_equal(getattr(ev, f), getattr(ref, f)), f
    jr, tr = jsim.simulate_round(jt, 2, CUTS), sim.simulate_round(tt, 2, CUTS)
    assert [dataclasses.astuple(e) for e in tr.events] == [
        dataclasses.astuple(e) for e in jr.events]
    for be in BACKENDS:
        fl = sim.simulate_rounds(tt, CUTS, INTERVALS, backend=be)
        for f in ("split", "agg", "fired", "total", "participants"):
            assert np.array_equal(getattr(fl, f), getattr(ev, f)), (be, f)
        rl, jl = sim.round_latency(tt, 1, CUTS, backend=be), jsim.round_latency(
            jt, 1, CUTS, backend="numpy")
        np.testing.assert_array_equal(rl.per_client, jl.per_client)
        assert (rl.split, rl.n_participants) == (jl.split, jl.n_participants)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("deadline", [None, 0.5], ids=["full", "deadline"])
def test_lattice_rounds_equal_jax_numpy(backend, deadline):
    jt, tt = _traces("straggler-tail", rounds=4)
    lat = cut_lattice(VGG.n_units, 3)
    js, ja = jsim.simulate_lattice_rounds(jt, lat, backend="numpy", deadline=deadline)
    ts, ta = sim.simulate_lattice_rounds(tt, lat, backend=backend, deadline=deadline)
    assert np.array_equal(ts, js) and np.array_equal(ta, ja)


@pytest.mark.parametrize("backend", BACKENDS)
def test_quantiles_equal_numpy(backend):
    x = np.random.default_rng(0).lognormal(size=257)
    qs = (0.0, 0.1, 0.5, 0.95, 0.99, 1.0)
    assert np.array_equal(fleet.quantiles(x, qs, backend=backend),
                          jsim.fleet.quantiles(x, qs, backend="numpy"))


@pytest.mark.parametrize("name", ["straggler-tail", "diurnal-churn"])
def test_participation_masks_equal_jax(name):
    jt, tt = _traces(name, rounds=8)
    deadline = jsim.deadline_for_rate(jt, CUTS, 0.6)
    assert sim.deadline_for_rate(tt, CUTS, 0.6) == deadline
    ref = jsim.participation_masks(jt, CUTS, deadline)
    got = sim.participation_masks(tt, CUTS, deadline)
    for f in ("masks", "round_time", "rates", "q_tier"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert (got.deadline, got.cuts) == (ref.deadline, ref.cuts)


def _problem(pkg, N=20, J=5, seed=0):
    prof, system = _setup(pkg, N, J, seed, batch=16)
    hyper = (jax_hyper if pkg == "jax" else synthetic_hyperspec)(
        VGG.n_units, N, beta=3.0, seed=seed)
    return (JaxProblem if pkg == "jax" else HsflProblem)(prof, system, hyper, eps=EPS)


@pytest.mark.parametrize("backend", BACKENDS)
def test_robust_and_participation_problems_solve_as_jax(backend):
    """Trace-quantile and deadline-expectation pricing: the tables and the
    BCD optimum equal JAX's (NumPy) with ``==``."""
    jp, tp = _problem("jax"), _problem("torch")
    jt, tt = _traces("straggler-tail", rounds=8, seed=0)
    jr = jsim.robust_problem(jp, jt, quantile=0.9)
    tr = sim.robust_problem(tp, tt, quantile=0.9, backend=backend)
    assert tr.split_T(CUTS) == jr.split_T(CUTS)
    assert [tr.agg_T(CUTS)[m] for m in range(2)] == [jr.agg_T(CUTS)[m] for m in range(2)]
    a, b = jax_solve_bcd(jr, backend="numpy"), solve_bcd(tr, backend="numpy")
    assert (b.cuts, tuple(b.intervals), b.theta) == (a.cuts, tuple(a.intervals), a.theta)
    jq = jsim.participation_problem(jp, jt, target_rate=0.75)
    tq = sim.participation_problem(tp, tt, target_rate=0.75, backend=backend)
    assert dataclasses.astuple(tq.participation) == dataclasses.astuple(jq.participation)
    a, b = jax_solve_bcd(jq, backend="numpy"), solve_bcd(tq, backend="numpy")
    assert (b.cuts, tuple(b.intervals), b.theta) == (a.cuts, tuple(a.intervals), a.theta)


def test_backend_names():
    """``jax`` (what spec files carry) reads as the port's device backend:
    the card, never NumPy in its place; ``auto`` picks NumPy without a card,
    below the lattice crossover and for a round's [N] chain."""
    assert (spec_backend("jax"), spec_backend("numpy"), spec_backend("auto")) == (
        "torch", "numpy", "auto")
    assert fleet._resolve_backend("numpy") == "numpy"
    assert fleet._resolve_backend("torch:cpu") == "torch:cpu"
    assert fleet._resolve_backend("auto", 10) == "numpy"
    assert fleet._resolve_backend("auto", fleet.AUTO_TORCH_MIN_ELEMS - 1) == "numpy"
    assert fleet._resolve_backend("auto") == "numpy"
    for bad in ("jnp", "numpy:cpu", "scalar"):
        with pytest.raises(ValueError, match="unknown fleet backend"):
            fleet._resolve_backend(bad)
    if torch.cuda.is_available():
        assert fleet._resolve_backend("jax") == "torch"
        assert fleet._resolve_backend("auto", fleet.AUTO_TORCH_MIN_ELEMS) == "torch"
    else:
        assert fleet._resolve_backend("auto", fleet.AUTO_TORCH_MIN_ELEMS) == "numpy"
        for name in ("jax", "torch"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fleet._resolve_backend(name)
        tt = _traces("homogeneous-paper", rounds=2)[1]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim.simulate_rounds(tt, CUTS, backend="jax")


def test_trace_dataclasses_are_the_jax_ones():
    for a, b in ((jsim.RoundState, sim.RoundState), (jsim.FleetResult, sim.FleetResult),
                 (jsim.ParticipationResult, sim.ParticipationResult)):
        assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
