"""Cases of the port's sharded engine that run on every rank of a
``torch.distributed`` group, and the seeded inputs they share with the
tests that compare them (``tests/test_torch_sharded.py``) and with the JAX
reference script those tests start.

This module imports only NumPy at import time, so the spawned ranks and
the JAX subprocess load it cheaply; PyTorch and the port are imported
inside the functions that need them.
"""
import numpy as np

# --- the sync cases: seeded trees, entities (8, 2, 1) over D = 4 --------- #
SN = 8
SYNC_PLAN = dict(n_units=4, num_clients=SN, cuts=(1, 3), intervals=(2, 2, 1),
                 entities=(SN, 2, 1))
SYNC_CASES = ("plain", "mask", "int8", "guard")
SYNC_STEPS = (0, 1)
SYNC_TILE = 128
# clients 4..7 (tier 1's second group) are silent, so that group keeps its rows
SYNC_MASK = np.array([1, 0, 1, 1, 0, 0, 0, 0], np.float32)
NAN_ROW, BLOWUP_ROW = 3, 6


def sync_tree(case: str, seed: int = 0):
    """A client-stacked tree [SN, ...] with a frontend, four list units and
    a head; the guard case has a NaN in one client's row and one client's
    replica scaled by 1e5."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.standard_normal((SN,) + shape).astype(np.float32)

    tree = {
        "frontend": {"embed": leaf(6, 4)},
        "units": [{"w": leaf(4, 5), "b": leaf(5)} for _ in range(3)]
        + [{"w": leaf(300)}],
        "head": {"w": leaf(5, 3)},
    }
    if case == "guard":
        tree["units"][1]["w"][NAN_ROW, 0, 0] = np.nan
        for x in [tree["frontend"]["embed"], tree["head"]["w"]] + [
                v for u in tree["units"] for v in u.values()]:
            x[BLOWUP_ROW] *= 1e5
    return tree


# --- the engine cases: REDUCED smollm-135m, N = 8 over D = 4 ------------- #
N, B, S, ROUNDS = 8, 2, 16, 4
ARCH = "smollm-135m"
LR = 1e-2
PLAN = dict(cuts=(1, 2), intervals=(2, 2, 1), entities=(N, 2, 1))
# tier 1's four entities live two to a rank at D = 4: device-local
LOCAL_PLAN = dict(cuts=(1, 2), intervals=(2, 2, 1), entities=(N, 4, 1))
ENGINE_CASES = ("plain", "mask", "int8", "guard+mask")
# REDUCED granite (MoE): each client's dispatch stays local (one group)
MOE_ARCH = "granite-moe-1b-a400m"


def engine_batches(vocab: int, rounds: int = ROUNDS, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        toks = rng.integers(0, vocab, (N, B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def engine_masks(rounds: int = ROUNDS):
    """The JAX package's sharded test's masks: client i sits out round r
    when i ≡ r (mod 3)."""
    return [(np.arange(N) % 3 != r % 3).astype(np.float32) for r in range(rounds)]


def fed_tuple(intervals, r: int):
    return tuple((r + 1) % I == 0 if I > 1 else True for I in intervals)


class Carried:
    """A model whose ``init_params`` returns one fixed (JAX-drawn) tree."""

    def __init__(self, p0):
        self.p0 = p0

    def init_params(self, generator, device=None):
        from repro_torch.models import params_from_numpy

        return params_from_numpy(self.p0, device)


def engine_kwargs(case: str):
    from repro_torch.compress import Int8Stochastic
    from repro_torch.core.tiers import GuardSpec

    return {
        "plain": {},
        "mask": dict(with_mask=True),
        "int8": dict(compressor=Int8Stochastic(tile=SYNC_TILE)),
        "guard+mask": dict(with_mask=True, guard=GuardSpec()),
    }[case]


def run_engine(case: str, p0, plan_kw=PLAN, rounds: int = ROUNDS, mesh=None,
               client_axes=("data",), arch: str = ARCH, remat=None):
    """(losses, full params as NumPy) of ``rounds`` Engine-A rounds of
    ``arch`` from the carried init, dispatched per round type as
    ``launch.train`` does; sharded over ``mesh``'s ``client_axes`` when one
    is given; each unit rematerialised under the policy ``remat`` when one
    is given."""
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.core import build_train_step_a, default_plan, init_state_a
    from repro_torch.core.sharded import (
        build_sharded_train_step_a, gather_clients, init_sharded_state_a,
        num_client_shards,
    )
    from repro_torch.models import SplittableModel, params_to_numpy
    from repro_torch.optim import sgd

    cpu = torch.device("cpu")
    spec = get_reduced(arch)
    if remat is not None:
        spec = dataclasses.replace(spec, remat=True, remat_policy=remat)
    model, opt = SplittableModel(spec), sgd(LR)
    plan = default_plan(spec.n_units, N, **plan_kw)
    kw = engine_kwargs(case)
    if mesh is None:
        state = init_state_a(Carried(p0), plan, opt, torch.Generator(), cpu)
        build = lambda f: build_train_step_a(model, plan, opt, fed_round=f, **kw)
    else:
        state = init_sharded_state_a(Carried(p0), plan, opt, torch.Generator(), mesh,
                                     client_axes, device=cpu)
        build = lambda f: build_sharded_train_step_a(model, plan, opt, mesh,
                                                     client_axes=client_axes,
                                                     fed_round=f, **kw)
    batches, masks = engine_batches(spec.vocab_size, rounds), engine_masks(rounds)
    steps, losses = {}, []
    for r in range(rounds):
        f = fed_tuple(plan.intervals, r)
        if f not in steps:
            steps[f] = build(f)
        batch = {k: torch.from_numpy(v) for k, v in batches[r].items()}
        args = (torch.from_numpy(masks[r]),) if kw.get("with_mask") else ()
        state, loss = steps[f](state, batch, *args)
        losses.append(float(loss))
    params = state.params
    if mesh is not None:
        params = gather_clients(params, mesh, client_axes,
                                N // num_client_shards(mesh, client_axes))
    return losses, params_to_numpy(params)


def run_async(staleness: int, p0, rounds: int, mesh):
    """The sharded async trainer from the carried init over ``rounds``
    rounds, drained: (pending tiers before the drain, full params)."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.core import default_plan
    from repro_torch.core.async_agg import make_async_trainer
    from repro_torch.core.sharded import gather_clients, init_sharded_state_a
    from repro_torch.models import SplittableModel, params_to_numpy
    from repro_torch.optim import sgd

    spec = get_reduced(ARCH)
    model, opt = SplittableModel(spec), sgd(LR)
    plan = default_plan(spec.n_units, N, **PLAN)
    tr = make_async_trainer(model, plan, opt, staleness=staleness, mesh=mesh)
    state = init_sharded_state_a(Carried(p0), plan, opt, torch.Generator(), mesh,
                                 device=torch.device("cpu"))
    for r, b in enumerate(engine_batches(spec.vocab_size, rounds)):
        state, loss = tr.run_round(state, {k: torch.from_numpy(v) for k, v in b.items()}, r)
        assert np.isfinite(float(loss))
    pending = sorted(p.tier for p in tr.pending)
    state = tr.drain(state)
    D = mesh.size(0)
    return pending, params_to_numpy(gather_clients(state.params, mesh, ("data",), N // D))


def run_sync_case(case: str, step: int, mesh=None):
    """(synced tree, guard health or None) for one sync case, sharded over
    ``mesh`` when one is given, as full NumPy arrays."""
    import torch

    from repro_torch.compress import Int8Stochastic
    from repro_torch.core.sharded import (
        gather_clients, local_rows, sharded_guard_health, sharded_synchronize,
    )
    from repro_torch.core.tiers import GuardSpec, TierPlan, guard_health, synchronize
    from repro_torch.models import params_from_numpy, params_to_numpy

    plan = TierPlan(**SYNC_PLAN)
    tree = params_from_numpy(sync_tree(case), torch.device("cpu"))
    kw = {}
    if case == "mask":
        kw["mask"] = torch.from_numpy(SYNC_MASK)
    if case == "int8":
        kw["compressor"] = Int8Stochastic(tile=SYNC_TILE)
    if case == "guard":
        kw["guard"] = GuardSpec()
    if mesh is None:
        health = guard_health(tree, SN, kw["guard"])[0] if case == "guard" else None
        out = synchronize(tree, plan, step, **kw)
    else:
        D = mesh.size(0)
        tree = local_rows(tree, mesh, ("data",), SN)
        if "mask" in kw:
            kw["mask"] = local_rows(kw["mask"], mesh, ("data",), SN)
        health = None
        if case == "guard":
            h = sharded_guard_health(tree, SN // D, kw["guard"], mesh)[0]
            health = gather_clients(h, mesh, ("data",), SN // D)
        out = gather_clients(sharded_synchronize(tree, plan, step, mesh=mesh, **kw),
                             mesh, ("data",), SN // D)
    return params_to_numpy(out), None if health is None else health.numpy()


def rank_cases(p0, p0_moe):
    """Every case of ``tests/test_torch_sharded.py`` on this rank of a
    gloo world of D ranks (a ``data``×1 mesh); rank 0 returns the results.
    ``p0_moe`` is the MoE case's init (``MOE_ARCH``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    D = dist.get_world_size()
    mesh = make_debug_mesh(data=D, model=1, device="cpu")
    out = {
        "sync": {(c, s): run_sync_case(c, s, mesh) for c in SYNC_CASES for s in SYNC_STEPS},
        "engine": {c: run_engine(c, p0, mesh=mesh) for c in ENGINE_CASES},
        "local": run_engine("plain", p0, LOCAL_PLAN, rounds=1, mesh=mesh),
        "plain2": run_engine("plain", p0, rounds=2, mesh=mesh),
        "async0": run_async(0, p0, ROUNDS, mesh),
        "async1": run_async(1, p0, 2, mesh),
        # the client axes (pod, data) of a 2x2x1 mesh, and a data=2 x model=2
        # mesh whose model ranks hold equal copies
        "pods": run_engine("mask", p0, mesh=make_debug_mesh(data=2, model=1, pods=2,
                                                            device="cpu"),
                           client_axes=("pod", "data")),
        "model": run_engine("mask", p0, mesh=make_debug_mesh(data=2, model=2,
                                                             device="cpu")),
        # MoE at D = 2 client shards (each shard's two model ranks hold copies)
        "moe": run_engine("plain", p0_moe, mesh=make_debug_mesh(data=2, model=2,
                                                                device="cpu"),
                          arch=MOE_ARCH),
    }
    return out if dist.get_rank() == 0 else None


def rank_engine_cases(p0):
    """The engine cases alone (a world of one rank)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(data=dist.get_world_size(), model=1, device="cpu")
    return {c: run_engine(c, p0, mesh=mesh) for c in ENGINE_CASES}


def rank_remat_cases(p0):
    """The plain engine case with and without ``"full"`` remat on this rank
    of a gloo world of D ranks (a ``data``×1 mesh)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(data=dist.get_world_size(), model=1, device="cpu")
    return {"plain": run_engine("plain", p0, mesh=mesh),
            "remat": run_engine("plain", p0, mesh=mesh, remat="full")}


# --- the entry points: the CLI on REDUCED VGG, api.run ------------------- #
CLI_ARGV = ["--device", "cpu", "--rounds", "3", "--clients", "4", "--edges", "2",
            "--batch", "1", "--log-every", "1", "--intervals", "2", "2"]


def patch_cli_vgg():
    """The CLI's VGG-16 ``SPEC`` at REDUCED widths and 32x32 images, for the
    rest of this (spawned rank's) process."""
    import dataclasses

    from repro_torch.configs import vgg16_cifar10 as vc

    vc.SPEC = dataclasses.replace(vc.REDUCED, image_size=32)


def cli_output(argv):
    """(return code, stdout) of ``launch.train.main(argv)``."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    return rc, buf.getvalue()


def rank_entry_points(ckpt: str, spec_dict):
    """On every rank of a 2-rank gloo world: ``--shard-data 2`` (plain with
    a checkpoint, and ``--auto-optimize``) and ``api.run`` with a sharding
    section of the spec; rank 0 returns the CLI outputs and the result."""
    import torch.distributed as dist

    from repro_torch import api

    patch_cli_vgg()
    out = {
        "train": cli_output(CLI_ARGV + ["--shard-data", "2", "--checkpoint", ckpt]),
        "auto": cli_output(CLI_ARGV + ["--shard-data", "2", "--rounds", "0",
                                       "--auto-optimize", "--probe-rounds", "2"]),
        "api": api.run(api.ExperimentSpec.from_dict(spec_dict), device="cpu").to_dict(),
    }
    return out if dist.get_rank() == 0 else None
