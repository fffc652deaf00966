"""The port's declarative API (``ExperimentSpec`` → ``build`` → ``run``)
against the JAX package's: one spec JSON drives both; solve and simulate
results equal field for field; train-mode losses agree from a carried-over
init; sections whose modules are not ported are refused naming their item."""
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro import api as J
from repro.api.registry import resolve_model as jax_resolve_model
from repro.api.spec import ShardingCfg as JShardingCfg
from repro.models.vgg import build_model as jax_build_model
from repro_torch import api as T
from repro_torch.api.build import check_capabilities
from repro_torch.core import TrainState, replicate_for_clients
from repro_torch.models import params_from_numpy, params_to_numpy

PRESETS = sorted(J.EXPERIMENTS)
SOLVED = {
    "paper": lambda: J.paper_spec(),
    "robust": lambda: J.robust_spec("straggler-tail"),
    "participation": lambda: J.participation_spec(),
    "compressed": lambda: J.compressed_spec("int8"),
    "hetcuts": lambda: J.hetcuts_spec(),
    "two-tier": lambda: J.two_tier_spec("client-edge"),
    "tpu-pod": lambda: J.tpu_pod_spec(),
    "four-tier": lambda: J.paper_spec().replace(
        system=J.SystemCfg(preset="four-tier-wan")),
    "ma": lambda: J.paper_spec().replace(solver=J.SolverCfg(kind="ma", cuts=(3, 8))),
    "ms": lambda: J.paper_spec().replace(
        solver=J.SolverCfg(kind="ms", intervals=(4, 2, 1))),
}


def _port(spec):
    return T.ExperimentSpec.from_dict(json.loads(json.dumps(spec.to_dict())))


@pytest.mark.parametrize("name", PRESETS)
def test_presets_and_their_json_are_the_jax_ones(name):
    """Each preset equals JAX's, and its JSON round-trips both ways."""
    js, ts = J.get_experiment(name), T.get_experiment(name)
    assert ts.to_dict() == js.to_dict()
    assert _port(js) == ts
    assert J.ExperimentSpec.from_dict(json.loads(json.dumps(ts.to_dict()))) == js
    assert T.ExperimentSpec.from_dict(ts.to_dict()) == ts


def test_registries_are_the_jax_ones():
    assert T.MODEL_IDS == J.MODEL_IDS
    assert sorted(T.SYSTEMS) == sorted(J.SYSTEMS)
    assert sorted(T.CODECS) == sorted(J.CODECS)
    assert T.scenario_names() == J.scenario_names()
    assert sorted(T.EXPERIMENTS) == sorted(J.EXPERIMENTS)


@pytest.mark.parametrize("name", ["paper", "robust", "participation", "compressed",
                                  "four-tier"])
def test_build_problem_tables_equal_jax(name):
    """``build(...).problem``: the whole-lattice split / agg / memory tables,
    ε and the hyper constants equal JAX's with ``==``."""
    jb, tb = J.build(SOLVED[name]()), T.build(_port(SOLVED[name]()))
    assert tb.eps == jb.eps
    assert np.array_equal(tb.hyper.G2, jb.hyper.G2)
    je, te = jb.problem.evaluator("numpy"), tb.problem.evaluator("numpy")
    assert np.array_equal(te.lattice, je.lattice)
    for f in ("split", "agg", "mem_ok"):
        assert np.array_equal(getattr(te, f), getattr(je, f)), f
    if jb.participation is not None:
        assert tb.participation.q == jb.participation.q
        assert tb.participation.deadline == jb.participation.deadline


@pytest.mark.parametrize("name", list(SOLVED))
def test_solve_results_equal_jax(name):
    """The whole result — schedule, Θ′, R, T, latency breakdown, classes,
    provenance — equals JAX's field by field."""
    js = SOLVED[name]()
    assert T.run(_port(js)).to_dict() == J.run(js).to_dict()


@pytest.mark.parametrize("name", ["robust", "participation"])
def test_simulate_results_equal_jax(name):
    js = SOLVED[name]().replace(run=J.RunCfg(mode="simulate"))
    got, ref = T.run(_port(js)), J.run(js)
    assert got.sim is not None and got.to_dict() == ref.to_dict()


def test_evaluate_schedule_equals_jax():
    js = J.participation_spec()
    jb, tb = J.build(js), T.build(_port(js))
    for cuts, intervals in (((3, 8), (8, 4, 1)), ((2, 10), (2, 2, 1))):
        assert (T.evaluate_schedule(tb, cuts, intervals).to_dict()
                == J.evaluate_schedule(jb, cuts, intervals).to_dict())


def _train_spec(base):
    """REDUCED smollm-135m (the quickstart's 4 layers), N=4, J2=2, batch 2,
    seq 32, 3 rounds, the quickstart's fixed schedule."""
    return base.replace(
        model=J.ModelCfg(arch="smollm-135m", variant="reduced", num_layers=4, batch=2, seq=32),
        system=J.SystemCfg(num_clients=4, num_edges=2),
        solver=J.SolverCfg(kind="fixed", cuts=(1, 3), intervals=(2, 2, 1)),
        run=J.RunCfg(mode="train", rounds=3, dataset_size=64, lr=0.1),
    )


@pytest.mark.parametrize("base", ["paper", "compressed", "participation"])
def test_train_mode_matches_jax_from_a_carried_init(base, monkeypatch):
    """Losses within rtol 1e-4 over 3 rounds (the int8 wire within 1e-3, as
    the engine), every other result field equal; the JAX init is carried
    over by replacing the port's ``init_state_a`` in ``repro_torch.api.run``."""
    js = _train_spec(SOLVED[base]())
    ref = J.run(js)
    p0 = params_to_numpy(jax_build_model(jax_resolve_model(js.model)).init_params(
        jax.random.PRNGKey(js.run.seed)))

    def carried(model, plan, opt, generator, device=None):
        params = replicate_for_clients(params_from_numpy(p0, device), plan.num_clients)
        return TrainState(params, opt.init(params), 0)

    monkeypatch.setattr(sys.modules["repro_torch.api.run"], "init_state_a", carried)
    got = T.run(_port(js), device="cpu")
    np.testing.assert_allclose(got.train["losses"], ref.train["losses"],
                               rtol=1e-3 if base == "compressed" else 1e-4)
    a, b = got.to_dict(), ref.to_dict()
    assert a.keys() == b.keys() and a["train"].keys() == b["train"].keys()
    for k in b:
        if k != "train":
            assert a[k] == b[k], k
    for k in b["train"]:
        if k not in ("losses", "first_loss", "final_loss"):
            assert a["train"][k] == b["train"][k], k


def test_train_mode_runs_on_the_card_or_raises():
    js = _port(_train_spec(J.paper_spec()))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run(js)
    res = T.run(js.replace(run=js.run.__class__(mode="train", rounds=1, dataset_size=64)),
                device="cpu")
    assert len(res.train["losses"]) == 1 and np.isfinite(res.train["final_loss"])


def test_jax_backend_names_read_as_the_card():
    """A spec's ``"jax"`` backend (solver or scenario) is the port's device
    backend: without a card it raises, never running NumPy in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    solver = J.paper_spec().replace(solver=J.SolverCfg(backend="jax"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run(_port(solver))
    sc = J.robust_spec("straggler-tail")
    sc = sc.replace(scenario=J.ScenarioCfg(name="straggler-tail", backend="jax"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run(_port(sc))


UNPORTED = {
    "privacy": (lambda s: s.replace(privacy=J.PrivacyCfg(noise_multiplier=1.0)), "A11"),
    "energy": (lambda s: s.replace(energy=J.EnergyCfg()), "A11"),
    "faults": (lambda s: s.replace(faults=J.FaultsCfg(crash_rate=0.1)), "A11"),
    "control": (lambda s: s.replace(run=J.RunCfg(mode="control"),
                                    scenario=J.ScenarioCfg(name="flaky-wan")), "A11"),
    "staleness": (lambda s: s.replace(run=J.RunCfg(mode="train", staleness=1)), "A11"),
    "engine-b": (lambda s: s.replace(run=J.RunCfg(mode="train", engine="b")), "A12"),
    "sharding": (lambda s: s.replace(run=J.RunCfg(mode="train", sharding=JShardingCfg())),
                 "A13"),
    "arch": (lambda s: s.replace(model=J.ModelCfg(arch="mamba2-1.3b", variant="reduced")),
             "A14"),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_sections_raise_naming_their_item(name):
    edit, item = UNPORTED[name]
    js = edit(J.paper_spec())
    J.build(js) if name != "arch" else None  # the JAX package accepts each
    ts = _port(js)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}") as err:
        check_capabilities(ts)
    assert str(err.value).startswith("unsupported spec combination: ")
    with pytest.raises(NotImplementedError, match=item):
        T.run(ts)


def test_capability_combinations_fail_as_in_jax():
    """A combination the JAX package refuses is refused with its message."""
    js = J.hetcuts_spec().replace(run=J.RunCfg(mode="train", engine="b"))
    with pytest.raises(ValueError) as jerr:
        J.build(js)
    with pytest.raises(ValueError) as terr:
        T.build(_port(js))
    assert str(terr.value) == str(jerr.value)
    js = J.hetcuts_spec().replace(run=J.RunCfg(mode="train"))
    with pytest.raises(ValueError, match='supports run mode="solve"'):
        T.run(_port(js))


def test_result_dataclass_and_json_are_the_jax_ones():
    res = T.run(_port(J.paper_spec()))
    assert T.ExperimentResult.from_dict(res.to_dict()) == res
    assert list(res.to_dict()) == list(J.run(J.paper_spec()).to_dict())
    json.dumps(res.to_dict())
