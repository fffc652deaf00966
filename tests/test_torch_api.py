"""The port's declarative API (``ExperimentSpec`` → ``build`` → ``run``)
against the JAX package's: one spec JSON drives both; solve and simulate
results equal field for field; train-mode losses agree from a carried-over
init, also on Engine B (train and control modes); sections whose modules are
not ported are refused naming their item."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro import api as J
from repro.api.registry import resolve_model as jax_resolve_model
from repro.api.spec import ShardingCfg as JShardingCfg
from repro.models.model import SplittableModel as jax_split_model
from repro.models.vgg import build_model as jax_build_model
from repro_torch import api as T
from repro_torch.api.build import check_capabilities
from repro_torch.core import TrainState, init_state_b, replicate_for_clients
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
    "privacy-energy": lambda: J.privacy_energy_spec(),
    "privacy-energy-budgets": lambda: J.privacy_energy_spec(
        epsilon_budget=3e4, budget_j_per_round=25.0),
    "fault-storm": lambda: J.fault_storm_spec().replace(run=J.RunCfg(mode="solve")),
    "faults-nominal": lambda: J.paper_spec().replace(
        faults=J.FaultsCfg(crash_rate=0.1, corrupt_rate=0.05, link_fail_rate=0.2,
                           outage_cells=(1,), outage_tier=1, outage_len=2)),
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
                                  "four-tier", "privacy-energy", "fault-storm"])
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
    assert tb.problem.dp_sigma2 == jb.problem.dp_sigma2
    assert tb.problem.d_min() == jb.problem.d_min()
    assert tb.problem.retry_mult == jb.problem.retry_mult
    for f in ("privacy", "energy", "faults"):
        j, t = getattr(jb, f), getattr(tb, f)
        assert (t is None) == (j is None), f
        if j is not None:
            assert t.to_dict() == j.to_dict() if hasattr(j, "to_dict") else vars(t) == vars(j)
    assert (tb.dp_mechanism is None) == (jb.dp_mechanism is None)
    assert (tb.guard is None) == (jb.guard is None)


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
    "arch": (lambda s: s.replace(model=J.ModelCfg(arch="whisper-large-v3", variant="reduced")),
             "A14.5"),
}


PORTED = {
    "privacy": lambda s: s.replace(privacy=J.PrivacyCfg(noise_multiplier=1.0)),
    "energy": lambda s: s.replace(energy=J.EnergyCfg()),
    "faults": lambda s: s.replace(faults=J.FaultsCfg(crash_rate=0.1)),
    "staleness": lambda s: s.replace(run=J.RunCfg(mode="train", staleness=1)),
    "sharding": lambda s: s.replace(run=J.RunCfg(mode="train", sharding=JShardingCfg())),
    "fault-storm": lambda s: J.fault_storm_spec(),
    "privacy-energy": lambda s: J.privacy_energy_spec(),
}


@pytest.mark.parametrize("name", list(PORTED))
def test_ported_sections_pass_the_capability_check(name):
    """Privacy, energy, faults, staleness > 0 and a sharding section build
    in the port as in the JAX package: the capability check lets them
    through."""
    js = PORTED[name](J.paper_spec())
    J.build(js)
    check_capabilities(_port(js))
    T.build(_port(js))


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_sections_raise_naming_their_item(name):
    """The sections once unported, by ROADMAP item, now pass the port's
    capability check and fail where the JAX package's run fails: whisper
    (A14.5) on the LM stream's missing ``frames``."""
    edit, item = UNPORTED[name]
    js = edit(J.paper_spec())
    check_capabilities(_port(js))
    js = js.replace(
        model=J.ModelCfg(arch="whisper-large-v3", variant="reduced", batch=2, seq=8),
        solver=J.SolverCfg(kind="fixed", cuts=(1, 2), intervals=(2, 2, 1)),
        run=J.RunCfg(mode="train", rounds=1, dataset_size=64, lr=0.1))
    with pytest.raises(KeyError, match="frames"):
        J.run(js)
    with pytest.raises(KeyError, match="frames"):
        T.run(_port(js), device="cpu")


ENGINE_B = {
    "engine-b": (lambda s: s.replace(run=J.RunCfg(mode="train", engine="b")),
                 lambda: _train_spec(J.paper_spec()).replace(
                     run=J.RunCfg(mode="train", rounds=3, dataset_size=64, lr=0.1,
                                  engine="b"))),
    "control-engine-b": (lambda s: s.replace(run=J.RunCfg(mode="control", engine="b"),
                                             scenario=J.ScenarioCfg(name="flaky-wan")),
                         lambda: _control_b_spec()),
}


def _control_b_spec():
    """REDUCED smollm-135m with 5 layers, N=4, J2=2, batch 2, seq 16, 4
    rounds under flaky-wan with the 0.75 participation deadline: both
    packages switch the cuts (2, 3) -> (1, 2) at round 1 (the migration)
    and the intervals at round 3, every step masked."""
    return J.paper_spec().replace(
        name="control-engine-b",
        model=J.ModelCfg(arch="smollm-135m", variant="reduced", num_layers=5, batch=2,
                         seq=16),
        system=J.SystemCfg(preset="paper-three-tier", num_clients=4, num_edges=2),
        scenario=J.ScenarioCfg(name="flaky-wan", rounds=16, seed=0, quantile=0.5),
        participation=J.ParticipationCfg(target_rate=0.75),
        solver=J.SolverCfg(kind="fixed", cuts=(2, 3), intervals=(2, 2, 1)),
        run=J.RunCfg(mode="control", rounds=4, lr=0.1, dataset_size=64, log_every=0,
                     engine="b"),
        control=J.ControlCfg(window=4, min_window=2, cooldown=1, rel_tol=0.1,
                             backend="numpy"))


@pytest.mark.parametrize("name", list(ENGINE_B))
def test_engine_b_specs_build_and_run_as_in_jax(name, monkeypatch):
    """``engine="b"`` passes the capability check and builds as in the JAX
    package (train and control modes); on REDUCED smollm-135m from the
    carried JAX init it runs as JAX's: losses rtol 1e-4, every other result
    field equal (decisions, segments and bounds ``==`` in control mode, less
    the re-solves' wall clock), ``"engine": "b"`` reported."""
    edit, reduced = ENGINE_B[name]
    js = edit(J.paper_spec())
    J.build(js)
    check_capabilities(_port(js))
    T.build(_port(js))
    js = reduced()
    p0 = params_to_numpy(jax_split_model(jax_resolve_model(js.model)).init_params(
        jax.random.PRNGKey(js.run.seed)))

    class Carried:
        def init_params(self, generator, device=None):
            return params_from_numpy(p0, device)

    monkeypatch.setattr(sys.modules["repro_torch.api.run"], "init_state_b",
                        lambda model, plan, opt, generator, device=None:
                        init_state_b(Carried(), plan, opt, generator, device))
    ref = J.run(js)
    got = T.run(_port(js), device="cpu")
    mode = js.run.mode
    a, b = getattr(got, mode), getattr(ref, mode)
    assert a.keys() == b.keys() and a["engine"] == b["engine"] == "b"
    assert np.all(np.isfinite(a["losses"]))
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-4)
    clock = ("solve_ms", "resolve_p50_s", "resolve_p95_s", "switch_log")
    strip = lambda ss: [{k: v for k, v in s.items() if k not in clock} for s in ss]  # noqa: E731
    for k in b:
        if k in ("switches", "segments"):
            assert strip(a[k]) == strip(b[k]), k
        elif k not in ("losses", "first_loss", "final_loss") + clock:
            assert a[k] == b[k], k
    if mode == "control":
        assert any(s["old_cuts"] != s["new_cuts"] for s in b["switches"])
    for k in ("theta", "cuts", "intervals", "latency", "provenance"):
        assert got.to_dict()[k] == ref.to_dict()[k], k


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


def _carried(p0):
    def carried(model, plan, opt, generator, device=None):
        params = replicate_for_clients(params_from_numpy(p0, device), plan.num_clients)
        return TrainState(params, opt.init(params), 0)

    return carried


TRAIN_EXTRA = {
    "fault-storm": lambda: J.fault_storm_spec(
        rounds=6, corrupt_rate=0.2, checkpoint_every=2, engine_crash_round=3).replace(
        model=J.ModelCfg(arch="smollm-135m", variant="reduced", num_layers=4, batch=2,
                         seq=32),
        run=J.RunCfg(mode="train", rounds=6, dataset_size=64, lr=0.1)),
    "privacy-zero-noise": lambda: _train_spec(J.privacy_energy_spec(noise_multiplier=0.0)),
    "staleness": lambda: _train_spec(J.paper_spec()).replace(
        run=J.RunCfg(mode="train", rounds=3, dataset_size=64, lr=0.1, staleness=1)),
}


@pytest.mark.parametrize("name", list(TRAIN_EXTRA))
def test_fault_privacy_async_train_modes_match_jax(name, monkeypatch, tmp_path):
    """Train mode under the fault storm (corruption before the step, the
    guard, crashed clients masked, the cell outage rerouted, the engine
    crash resumed from a checkpoint), with a z = 0 privacy section and
    energy pricing, and at staleness 1: losses at rtol 1e-4 from the
    carried JAX init, every other result field (the fault and privacy
    sections included) equal."""
    js = TRAIN_EXTRA[name]()
    if js.faults is not None and js.faults.checkpoint_every:
        js = js.replace(faults=dataclasses.replace(js.faults, checkpoint_dir=str(tmp_path)))
    ref = J.run(js)
    p0 = params_to_numpy(jax_build_model(jax_resolve_model(js.model)).init_params(
        jax.random.PRNGKey(js.run.seed)))
    monkeypatch.setattr(sys.modules["repro_torch.api.run"], "init_state_a", _carried(p0))
    got = T.run(_port(js), device="cpu")
    assert np.all(np.isfinite(got.train["losses"]))
    np.testing.assert_allclose(got.train["losses"], ref.train["losses"], rtol=1e-4)
    a, b = got.to_dict(), ref.to_dict()
    assert a.keys() == b.keys() and a["train"].keys() == b["train"].keys()
    for k in b:
        if k != "train":
            assert a[k] == b[k], k
    for k in b["train"]:
        if k not in ("losses", "first_loss", "final_loss"):
            assert a["train"][k] == b["train"][k], k
    if name == "fault-storm":
        assert a["train"]["faults"]["recovered_round"] == 3
        assert a["train"]["faults"]["checkpoints"] == 3
        assert a["train"]["faults"]["n_faulty_total"] > 0


SHARDING_REFUSED = {
    "engine-b": lambda s: s.replace(run=dataclasses.replace(s.run, engine="b")),
    "privacy": lambda s: s.replace(privacy=J.PrivacyCfg(noise_multiplier=1.0)),
    "classes": lambda s: J.hetcuts_spec().replace(run=s.run),
    "faults": lambda s: s.replace(faults=J.FaultsCfg(crash_rate=0.1)),
    "control": lambda s: s.replace(scenario=J.ScenarioCfg(name="flaky-wan"),
                                   run=dataclasses.replace(s.run, mode="control")),
}


@pytest.mark.parametrize("name", list(SHARDING_REFUSED))
def test_sharding_refusals_equal_jax(name):
    """A sharding section with Engine B, DP noise, per-class cuts, faults or
    control mode is refused at build time with JAX's message."""
    js = SHARDING_REFUSED[name](_train_spec(J.paper_spec()).replace(
        run=J.RunCfg(mode="train", rounds=3, dataset_size=64, lr=0.1,
                     sharding=JShardingCfg(data=2))))
    with pytest.raises(ValueError) as ref:
        J.build(js)
    with pytest.raises(ValueError) as got:
        T.build(_port(js))
    assert str(got.value) == str(ref.value)
    assert "sharding" in str(got.value) or "engine" in str(got.value)


JAX_SHARDED_RUN = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
from repro import api as J
spec = J.ExperimentSpec.from_dict(json.loads(sys.argv[1]))
print("RESULT" + json.dumps(J.run(spec).train["sharding"]))
"""


def _sharded_spec():
    """The REDUCED smollm train spec with ``ShardingCfg(data=2)``."""
    base = _train_spec(J.paper_spec())
    return base.replace(run=dataclasses.replace(base.run, sharding=JShardingCfg(data=2)))


@pytest.fixture(scope="module")
def sharded_entry_points(tmp_path_factory):
    """``--shard-data 2`` and ``api.run`` with a sharding section on 2 gloo
    ranks spawned once, while JAX's ``api.run`` of the same spec runs over
    2 forced host devices in a subprocess."""
    import os
    import subprocess

    import torch_sharded_cases as C
    from repro_torch.launch.mesh import run_on_ranks

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(here, "..", "src"), here])
    spec = _sharded_spec()
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SHARDED_RUN, json.dumps(spec.to_dict())], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ckpt = str(tmp_path_factory.mktemp("sharded") / "ckpt.npz")
    try:
        port = run_on_ranks(C.rank_entry_points, 2, device="cpu",
                            args=(ckpt, _port(spec).to_dict()))
        out, err = jax_run.communicate(timeout=300)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0, err[-3000:]
    jax_sharding = json.loads(out.split("RESULT")[1])
    return port, jax_sharding, ckpt


def _cli_losses(text):
    return [float(line.split("loss")[1].split()[0])
            for line in text.splitlines() if line.startswith("round")]


def test_shard_data_cli_matches_the_unsharded_cli(sharded_entry_points, tmp_path, monkeypatch):
    """``--shard-data 2 --device cpu`` on REDUCED VGG (N=4, J2=2, 3 rounds,
    intervals 2 2): tier 1's entity groups are device-local, the fed levels
    span the two ranks.  Losses equal the unsharded CLI's at rtol 2e-5, the
    first bit for bit; rank 0's checkpoint is the gathered state, within
    rtol 2e-5 / atol 2e-6 of the unsharded run's; ``--auto-optimize`` over
    the shards picks the unsharded CLI's plan."""
    import torch_sharded_cases as C

    (rc, text), ckpt = sharded_entry_points[0]["train"], sharded_entry_points[2]
    assert rc == 0 and "[sharded over ('data',) (2 ranks, gloo)]" in text
    assert "saved checkpoint" in text
    from repro_torch.configs import vgg16_cifar10 as vgg_config

    monkeypatch.setattr(vgg_config, "SPEC",
                        dataclasses.replace(vgg_config.REDUCED, image_size=32))
    ref_ckpt = str(tmp_path / "ref.npz")
    rc0, ref = C.cli_output(C.CLI_ARGV + ["--checkpoint", ref_ckpt])
    got_l, ref_l = _cli_losses(text), _cli_losses(ref)
    assert rc0 == 0 and len(got_l) == 3 and got_l[0] == ref_l[0]
    np.testing.assert_allclose(got_l, ref_l, rtol=2e-5)
    a, b = np.load(ckpt), np.load(ref_ckpt)
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-6, err_msg=k)
    (rc, auto) = sharded_entry_points[0]["auto"]
    _, ref_auto = C.cli_output(C.CLI_ARGV + ["--rounds", "0", "--auto-optimize",
                                             "--probe-rounds", "2"])
    pick = [line for line in auto.splitlines() if line.startswith("[bcd]")]
    ref_pick = [line for line in ref_auto.splitlines() if line.startswith("[bcd]")]
    assert rc == 0 and len(pick) == 1 and pick == ref_pick, (pick, ref_pick)


def test_api_run_with_a_sharding_section(sharded_entry_points):
    """``api.run`` with ``ShardingCfg(data=2)`` on 2 ranks: losses equal the
    unsharded port run's at rtol 2e-5 (the first bit for bit), every other
    result field equal, and the ``"sharding"`` entry equals JAX's field by
    field."""
    got, jax_sharding, _ = sharded_entry_points
    got = got["api"]
    spec = _port(_sharded_spec())
    ref = T.run(spec.replace(run=dataclasses.replace(spec.run, sharding=None)),
                device="cpu").to_dict()
    assert got["train"]["sharding"] == jax_sharding
    assert jax_sharding == {"data": 2, "model": 1, "pods": 0, "client_shards": 2}
    np.testing.assert_allclose(got["train"]["losses"], ref["train"]["losses"], rtol=2e-5)
    assert got["train"]["losses"][0] == ref["train"]["losses"][0]
    for k in ref["train"]:
        if k not in ("losses", "first_loss", "final_loss"):
            assert got["train"][k] == ref["train"][k], k
    for k in ref:
        if k not in ("train", "provenance"):
            assert got[k] == ref[k], k
