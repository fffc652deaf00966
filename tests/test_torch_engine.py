"""The slice end to end: the port's Engine A and training entry point
against the JAX package's, from one carried-over init and the same batches."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.compress import Int8Stochastic as JaxInt8
from repro.configs.vgg16_cifar10 import REDUCED as JAX_REDUCED, SPEC as JAX_SPEC
from repro.core import build_train_step_a as jax_build_step, init_state_a as jax_init
from repro.core.engine import replicate_for_clients as jax_replicate
from repro.core.tiers import default_plan as jax_default_plan
from repro.models.vgg import VggModel as JaxVgg
from repro.optim import adam as jadam, momentum as jmomentum, sgd as jsgd
from repro_torch.compress import Int8Stochastic
from repro_torch.configs.vgg16_cifar10 import REDUCED
from repro_torch.core import (
    TrainState, build_train_step_a, default_plan, init_state_a,
    replicate_for_clients, unreplicate,
)
from repro_torch.launch import train
from repro_torch.models import VggModel, params_from_numpy, params_to_numpy
from repro_torch.optim import adam, momentum, sgd

N, B, ROUNDS = 4, 2, 4
CUTS, INTERVALS, ENTITIES = (1, 3), (2, 2, 1), (4, 2, 1)
OPTS = {"sgd": (jsgd, sgd), "momentum": (jmomentum, momentum), "adam": (jadam, adam)}
CPU = torch.device("cpu")


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    hw = REDUCED.image_size
    return [{"images": rng.normal(size=(N, B, hw, hw, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (N, B)).astype(np.int32)}
            for _ in range(ROUNDS)]


def _run_jax(opt_name, codec, sync_opt_state):
    model = JaxVgg(JAX_REDUCED)
    plan = jax_default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS,
                            entities=ENTITIES)
    opt = OPTS[opt_name][0](0.05 if opt_name != "adam" else 1e-3)
    state = jax_init(model, plan, opt, jax.random.PRNGKey(0))
    init = params_to_numpy(state.params)
    cache, losses = {}, []
    for r, batch in enumerate(_batches()):
        fed = tuple((r + 1) % I == 0 if I > 1 else True for I in plan.intervals)
        if fed not in cache:
            cache[fed] = jax.jit(jax_build_step(
                model, plan, opt, fed_round=fed, sync_opt_state=sync_opt_state,
                compressor=JaxInt8(tile=codec) if codec else None))
        state, loss = cache[fed](state, jax.tree.map(jnp.asarray, batch))
        losses.append(float(loss))
    return init, losses, params_to_numpy(state.params)


def _run_port(init, opt_name, codec, sync_opt_state):
    model = VggModel(REDUCED)
    plan = default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS,
                        entities=ENTITIES)
    opt = OPTS[opt_name][1](0.05 if opt_name != "adam" else 1e-3)
    params = params_from_numpy(init, CPU)
    state = TrainState(params, opt.init(params), 0)
    cache, losses = {}, []
    for r, batch in enumerate(_batches()):
        fed = tuple((r + 1) % I == 0 if I > 1 else True for I in plan.intervals)
        if fed not in cache:
            cache[fed] = build_train_step_a(
                model, plan, opt, fed_round=fed, sync_opt_state=sync_opt_state,
                compressor=Int8Stochastic(codec) if codec else None)
        state, loss = cache[fed](state, train.to_device(batch, torch.device("cpu")))
        losses.append(float(loss))
    assert state.step == ROUNDS
    return losses, params_to_numpy(state.params)


def _flat(tree):
    return {f"units/{u}/{k}": v for u, unit in enumerate(tree["units"])
            for k, v in unit.items()}


@pytest.mark.parametrize("opt_name,sync_opt_state", [
    ("sgd", False), ("momentum", True), ("adam", True),
])
def test_engine_a_matches_jax(opt_name, sync_opt_state):
    """REDUCED VGG, N=4, J2=2, batch 2, cuts (1, 3), intervals (2, 2, 1),
    4 rounds through the per-round-type dispatch on both sides.  Conv sums
    run in another order, so losses agree to rtol 1e-4 and params to 1e-5."""
    init, jl, jp = _run_jax(opt_name, None, sync_opt_state)
    tl, tp = _run_port(init, opt_name, None, sync_opt_state)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for k, v in _flat(jp).items():
        np.testing.assert_allclose(_flat(tp)[k], v, atol=1e-5, err_msg=k)


def test_engine_a_int8_fed_wire_matches_jax():
    """The int8 codec on the fed wire: a sum that rounds differently can
    flip one quantized value by one step, which moves a loss by ~1e-4."""
    init, jl, jp = _run_jax("sgd", 128, False)
    tl, tp = _run_port(init, "sgd", 128, False)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for k, v in _flat(jp).items():
        lsb = float(np.abs(v).max()) / 127.0
        np.testing.assert_allclose(_flat(tp)[k], v, atol=lsb, err_msg=k)


def test_init_state_and_replication():
    plan = default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS,
                        entities=ENTITIES)
    model = VggModel(REDUCED)
    state = init_state_a(model, plan, sgd(0.1), torch.Generator().manual_seed(0), CPU)
    assert state.step == 0 and state.opt_state == ()
    assert state.params["units"][0]["w"].device == CPU
    w = state.params["units"][0]["w"]
    assert w.shape == (N, 3, 3, 3, 16) and w.is_contiguous()
    assert torch.equal(w, w[:1].expand_as(w))
    single = unreplicate(state.params)
    again = replicate_for_clients(single, N)
    assert torch.equal(again["units"][4]["b"], state.params["units"][4]["b"])
    ref = jax_replicate(params_to_numpy(single), N)
    np.testing.assert_array_equal(params_to_numpy(again)["units"][1]["w"],
                                  np.asarray(ref["units"][1]["w"]))


def test_train_main_runs_on_cpu_and_checkpoint_loads_in_jax(tmp_path, capsys):
    """The entry point on request of the CPU, at full VGG-16 width with two
    clients; its checkpoint restores in the JAX package."""
    ckpt = tmp_path / "vgg.npz"
    rc = train.main(["--device", "cpu", "--rounds", "2", "--clients", "2",
                     "--edges", "1", "--batch", "2", "--log-every", "1",
                     "--non-iid", "--checkpoint", str(ckpt)])
    assert rc == 0
    out = capsys.readouterr().out
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.startswith("round")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    template = jax_replicate(JaxVgg(JAX_SPEC).init_params(jax.random.PRNGKey(1)), 2)
    tree, step, meta = jax_load_checkpoint(str(ckpt), template,
                                           expect_cuts=(3, 8), expect_intervals=(8, 4, 1))
    assert step == 2 and meta == {"cuts": [3, 8], "intervals": [8, 4, 1]}
    w = np.asarray(tree["units"][15]["w"])
    assert w.shape == (2, 512, 10) and np.all(w[0] == w[1])  # top tier synced


def test_train_main_refuses_to_fall_back_to_cpu():
    """Without --device cpu the entry point runs on CUDA or raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.resolve_device("cuda:0")
    assert train.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["init_state_a", "init_params", "params_from_numpy"])
def test_entry_points_refuse_to_fall_back_to_cpu(entry):
    """Called without a device, the public constructors put their tensors on
    CUDA or raise; they build on the CPU only when asked to."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    model = VggModel(REDUCED)
    plan = default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS,
                        entities=ENTITIES)
    gen = torch.Generator().manual_seed(0)
    call = {
        "init_state_a": lambda *d: init_state_a(model, plan, sgd(0.1), gen, *d).params,
        "init_params": lambda *d: model.init_params(gen, *d),
        "params_from_numpy": lambda *d: params_from_numpy(
            {"units": [{"w": np.ones((2, 3), np.float32)}]}, *d),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call("cuda")
    assert call("cpu")["units"][0]["w"].device == CPU


def test_train_cli_has_only_the_ported_flags():
    args = train.parse_args([])
    assert args.device == "cuda" and args.arch == "vgg16-cifar10"
    with pytest.raises(SystemExit):  # --shard-data takes the shard count
        train.parse_args(["--shard-data"])
    args = train.parse_args(["--shard-data", "2", "--shard-pods", "2"])
    assert args.shard_data == 2 and args.shard_pods == 2
    assert train.parse_args([]).shard_data == 0
    assert train.parse_args(["--staleness", "2"]).staleness == [2]
    assert train.parse_args(["--staleness", "1", "0", "0"]).staleness == [1, 0, 0]
    args = train.parse_args(["--auto-optimize"])
    assert args.auto_optimize and args.probe_rounds == 8 and args.eps_scale == 4.0
    # --arch takes any id, as the JAX CLI does; the audio id exits as JAX's
    # (its stream carries no frames)
    assert train.parse_args(["--arch", "smollm-135m"]).arch == "smollm-135m"
    with pytest.raises(SystemExit, match="whisper-large-v3: frontend is a stub"):
        train.setup(train.parse_args(["--arch", "whisper-large-v3", "--device", "cpu"]))
