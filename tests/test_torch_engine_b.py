"""Engine B, the split-placement engine, in the port against the JAX
package's: the same init (drawn once in JAX, carried through NumPy) and the
same NumPy batches give the same losses and tier params step by step —
unmasked, under participation masks with a silent entity and a silent
round, and over the identity, int8 and top-k fed wires — and the port's
Engine A equals its Engine B.  Also ``engine_b_to_full``, the Engine-B
migration, the refusals, B1m's plain version under integer weights, the
launches a step makes.  ``api.run(engine="b")`` in train and control
modes against JAX's: ``tests/test_torch_api.py``."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import Identity as JIdentity, Int8Stochastic as JInt8, TopK as JTopK
from repro.configs import get_reduced as jax_reduced
from repro.configs.vgg16_cifar10 import REDUCED as JAX_VGG
from repro.control.migrate import migrate_state_b as jax_migrate_b
from repro.core import build_train_step_b as jax_step_b, init_state_b as jax_init_b
from repro.core.engine import TrainState as JState, engine_b_to_full as jax_to_full
from repro.core.tiers import default_plan as jax_plan
from repro.models.model import SplittableModel as JaxModel
from repro.models.spec import MoeSpec as JMoe
from repro.models.vgg import VggModel as JaxVgg
from repro.optim import momentum as jmomentum, sgd as jsgd
from repro.privacy import DPMechanism as JDP
from repro_torch._tree import tree_leaves
from repro_torch.compress import Identity, Int8Stochastic, TopK
from repro_torch.configs import get_reduced
from repro_torch.configs.vgg16_cifar10 import REDUCED as VGG
from repro_torch.control import migrate_state
from repro_torch.control.migrate import migrate_params_b, migrate_state_b
from repro_torch.core import (
    TrainState, build_train_step_a, build_train_step_b, default_plan, init_state_b,
    replicate_for_clients,
)
from repro_torch.core.engine import engine_b_to_full
from repro_torch.kernels.swa_attention import ops as attn_ops
from repro_torch.kernels.tiered_aggregate import masked_tiered_aggregate_ref
from repro_torch.kernels.tiered_aggregate import ops as agg_ops
from repro_torch.models import SplittableModel, VggModel, params_from_numpy, params_to_numpy
from repro_torch.models.spec import MoeSpec
from repro_torch.optim import momentum, sgd
from repro_torch.privacy import DPMechanism

CPU = torch.device("cpu")
N, B, S, STEPS = 8, 2, 16, 4
OPTS = {"sgd": (jsgd, sgd), "momentum": (jmomentum, momentum)}
# JAX's own A == B tolerance (tests/test_engines_equal.py)
LOSS_RTOL, LOSS_ATOL, ATOL, RTOL = 1e-5, 1e-6, 5e-6, 1e-4


class _Carried:
    """A model whose ``init_params`` returns one fixed (JAX-drawn) tree."""

    def __init__(self, p0):
        self.p0 = p0

    def init_params(self, generator, device=None):
        return params_from_numpy(self.p0, device)


@functools.lru_cache(maxsize=None)
def _init(arch):
    """One JAX init per arch (``PRNGKey(0)``), as NumPy arrays."""
    return params_to_numpy(JaxModel(jax_reduced(arch)).init_params(jax.random.PRNGKey(0)))


def _setup(arch, cuts, intervals, opt_name="sgd", lr=1e-2):
    jspec = jax_reduced(arch)
    kw = dict(cuts=cuts, intervals=intervals, entities=(N, 4, 1))
    jp, tp = jax_plan(jspec.n_units, N, **kw), default_plan(jspec.n_units, N, **kw)
    jopt, topt = (f(lr) for f in OPTS[opt_name])
    jm, tm = JaxModel(jspec), SplittableModel(get_reduced(arch))
    return dict(jm=jm, tm=tm, jp=jp, tp=tp, jopt=jopt, topt=topt, p0=_init(arch), spec=jspec)


def _batches(vocab, steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, vocab, (N, B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def _round_masks(rng, steps, plan):
    """Random ~60% masks with a zero-participant *entity* round (round 1)
    and a zero-participant *global* round (round 2), as the JAX package's
    ``tests/test_engines_equal.py`` draws them."""
    masks = rng.random((steps, N)) < 0.6
    masks[1, :N // plan.entities[1]] = False
    if steps > 2:
        masks[2, :] = False
    for t in range(steps):
        if t != 2 and not masks[t].any():
            masks[t, int(rng.integers(N))] = True
    return masks.astype(np.float32)


def _run_jax(c, batches, masks=None, compressor=None):
    state = jax_init_b(c["jm"], c["jp"], c["jopt"], jax.random.PRNGKey(0))
    step = jax.jit(jax_step_b(c["jm"], c["jp"], c["jopt"], compressor=compressor,
                              with_mask=masks is not None))
    out = []
    for t, batch in enumerate(batches):
        args = (jnp.asarray(masks[t]),) if masks is not None else ()
        state, loss = step(state, jax.tree.map(jnp.asarray, batch), *args)
        out.append((float(loss), params_to_numpy(state.params)))
    return out


def _run_port(c, batches, masks=None, compressor=None):
    state = init_state_b(_Carried(c["p0"]), c["tp"], c["topt"], torch.Generator(), CPU)
    step = build_train_step_b(c["tm"], c["tp"], c["topt"], compressor=compressor,
                              with_mask=masks is not None)
    out = []
    for t, batch in enumerate(batches):
        args = (torch.from_numpy(masks[t]),) if masks is not None else ()
        state, loss = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, *args)
        out.append((float(loss), params_to_numpy(state.params)))
    assert state.step == len(batches)
    return out


def _assert_steps_close(got, ref, atol=ATOL):
    for t, ((tl, tp), (jl, jp)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=f"step {t}")
        a, b = jax.tree.leaves(tp), jax.tree.leaves(jp)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, np.asarray(y), atol=atol, rtol=RTOL,
                                       err_msg=f"step {t}")


# --------------------------------------------------------------------------- #
# init and the client-stacked view
# --------------------------------------------------------------------------- #


def test_init_state_b_and_engine_b_to_full_equal_jax():
    """``init_state_b`` cuts one init into JAX's per-tier entity stacks bit
    for bit, and ``engine_b_to_full`` repeats them back into JAX's
    client-stacked tree (VGG's list of units: the migration test)."""
    c = _setup("smollm-135m", (1, 2), (2, 2, 1))
    ref = jax_init_b(c["jm"], c["jp"], c["jopt"], jax.random.PRNGKey(0))
    got = init_state_b(_Carried(c["p0"]), c["tp"], c["topt"], torch.Generator(), CPU)
    assert got.step == 0 and got.opt_state == ()
    _assert_equal(got.params, ref.params)
    _assert_equal(engine_b_to_full(c["tm"], c["tp"], got.params),
                  jax_to_full(c["jm"], c["jp"], ref.params))


def _assert_equal(port_tree, jax_tree):
    a, b = jax.tree.leaves(params_to_numpy(port_tree)), jax.tree.leaves(jax_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == np.asarray(y).shape and np.array_equal(x, np.asarray(y))


# --------------------------------------------------------------------------- #
# port B == JAX B, step by step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,cuts,intervals", [
    ("smollm-135m", (1, 2), (3, 2, 1)),
    ("qwen2-1.5b", (1, 1), (2, 4, 1)),
])
def test_engine_b_matches_jax(arch, cuts, intervals):
    """Unmasked, 4 steps from one init: losses rtol 1e-5, every tier's params
    atol 5e-6 / rtol 1e-4 after every step (the fed means on B1's plain
    version, weights 1/J, against JAX's ``jnp.mean``)."""
    c = _setup(arch, cuts, intervals)
    batches = _batches(c["spec"].vocab_size)
    _assert_steps_close(_run_port(c, batches), _run_jax(c, batches))


def test_engine_b_masked_matches_jax():
    """Under participation masks (B1m's plain version weighted by the
    entities' participant counts): a silent entity at round 1 keeps its
    sub-model, the silent round 2 is a no-op reporting 0.0."""
    c = _setup("smollm-135m", (1, 2), (3, 2, 1))
    batches = _batches(c["spec"].vocab_size, seed=1)
    masks = _round_masks(np.random.default_rng(7), STEPS, c["tp"])
    got, ref = _run_port(c, batches, masks), _run_jax(c, batches, masks)
    _assert_steps_close(got, ref)
    assert got[2][0] == ref[2][0] == 0.0
    for x, y in zip(jax.tree.leaves(got[2][1]), jax.tree.leaves(got[1][1])):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("codec", ["identity", "int8", "top-k"])
def test_engine_b_compressed_matches_jax(codec):
    """Over the fed wire, each entity's upload through the codec before the
    Eq. 4 mean: the identity codec at the unmasked tolerance; int8 (B2's
    plain version with the codec's tile) and top-k within what JAX's own
    A == B test allows between ULP-divergent engines — the int8 rounding
    can flip one LSB (atol 2e-3), top-k one near-tie of |param| at the
    rank-k boundary in 100 000 coordinates."""
    jc, tc = {"identity": (JIdentity(), Identity()), "int8": (JInt8(tile=256),
              Int8Stochastic(256)), "top-k": (JTopK(0.25), TopK(0.25))}[codec]
    c = _setup("smollm-135m", (1, 2), (2, 2, 1))
    batches = _batches(c["spec"].vocab_size, steps=3, seed=2)
    got, ref = _run_port(c, batches, compressor=tc), _run_jax(c, batches, compressor=jc)
    if codec == "identity":
        _assert_steps_close(got, ref)
        return
    np.testing.assert_allclose([g[0] for g in got], [r[0] for r in ref], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    atol = 2e-3 if codec == "int8" else ATOL
    bad = total = 0
    for x, y in zip(jax.tree.leaves(got[-1][1]), jax.tree.leaves(ref[-1][1])):
        y = np.asarray(y, np.float64)
        bad += int((np.abs(x - y) > atol + RTOL * np.abs(y)).sum())
        total += x.size
    assert bad <= (max(1, total // 100_000) if codec == "top-k" else 0), (bad, total)


# --------------------------------------------------------------------------- #
# port A == port B
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,cuts,intervals,case", [
    ("smollm-135m", (1, 2), (3, 2, 1), "plain"),
    ("qwen2-1.5b", (1, 1), (2, 4, 1), "plain"),
    ("smollm-135m", (1, 2), (3, 2, 1), "masked"),
    ("qwen2-1.5b", (1, 1), (2, 4, 1), "masked"),
    ("smollm-135m", (1, 2), (8, 8, 1), "momentum"),
])
def test_port_engine_a_equals_engine_b(arch, cuts, intervals, case):
    """The sync-groups engine (B1 / B1m syncs on client replicas) equals the
    split-placement engine from one init, step by step, at JAX's A == B
    tolerance.  Under momentum Engine A syncs its moments too, so an
    entity's one moment is its clients' moments' mean, up to the first fed
    round (none in these 4 steps): Engine B fed-averages params only, as
    the JAX engine does."""
    c = _setup(arch, cuts, intervals, "momentum" if case == "momentum" else "sgd")
    batches = _batches(c["spec"].vocab_size, seed=3)
    masked = case == "masked"
    masks = _round_masks(np.random.default_rng(11), STEPS, c["tp"]) if masked else None
    params = replicate_for_clients(params_from_numpy(c["p0"], CPU), N)
    sa = TrainState(params, c["topt"].init(params), 0)
    step_a = build_train_step_a(c["tm"], c["tp"], c["topt"], with_mask=masked,
                                sync_opt_state=case == "momentum")
    got_b = _run_port(c, batches, masks)
    for t, batch in enumerate(batches):
        args = (torch.from_numpy(masks[t]),) if masked else ()
        sa, la = step_a(sa, {k: torch.from_numpy(v) for k, v in batch.items()}, *args)
        lb, pb = got_b[t]
        np.testing.assert_allclose(float(la), lb, rtol=LOSS_RTOL, atol=LOSS_ATOL)
        full = engine_b_to_full(c["tm"], c["tp"], params_from_numpy(pb, CPU))
        for x, y in zip(tree_leaves(sa.params), tree_leaves(full)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL, rtol=RTOL)


# --------------------------------------------------------------------------- #
# launches: attention once per layer a step, the fed means per leaf
# --------------------------------------------------------------------------- #


def _count_calls(monkeypatch, module, names, counts):
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, fn=fn, name=name, **k):
            counts[name] = counts.get(name, 0) + 1
            counts[f"{name} rows"] = a[0].shape[0]
            return fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_launches_per_layer_and_per_fed_leaf(masked, monkeypatch):
    """On the CPU the wrappers run the plain versions where the card
    launches: B4 and each B5 pass once per layer a step, on the whole
    global batch (N·b rows: every vmap folded into the batch axis); the fed
    mean one B1 (masked: B1m) per leaf of each tier whose fed level is due,
    nothing else."""
    spec = dataclasses.replace(get_reduced("smollm-135m"), num_layers=5)
    plan = default_plan(spec.n_units, N, cuts=(1, 3), intervals=(3, 2, 1),
                        entities=(N, 4, 1))
    model = SplittableModel(spec)
    state = init_state_b(model, plan, sgd(1e-2), torch.Generator().manual_seed(0), CPU)
    counts = {}
    _count_calls(monkeypatch, attn_ops, ["swa_attention_ref", "swa_attention_bwd_dq_ref",
                                         "swa_attention_bwd_dkv_ref"], counts)
    _count_calls(monkeypatch, agg_ops, ["tiered_aggregate_ref", "masked_tiered_aggregate_ref",
                                        "quantized_tiered_aggregate_ref"], counts)
    step = build_train_step_b(model, plan, sgd(1e-2), with_mask=masked)
    leaves = [len(tree_leaves(p)) for p in state.params]  # 10 (embed + 9), 9, 10
    agg = "masked_tiered_aggregate_ref" if masked else "tiered_aggregate_ref"
    for t, batch in enumerate(_batches(spec.vocab_size, steps=3)):
        counts.clear()
        args = (torch.ones(N),) if masked else ()
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, *args)
        fed = sum(leaves[m] for m in (0, 1) if (t + 1) % plan.intervals[m] == 0)
        want = {f: spec.n_units for f in ("swa_attention_ref", "swa_attention_bwd_dq_ref",
                                         "swa_attention_bwd_dkv_ref")}
        want.update({f"{f} rows": N * B for f in want})
        if fed:
            want[agg] = fed
        got = {k: v for k, v in counts.items()
               if not (k.endswith(" rows") and "aggregate" in k)}
        assert got == want, (t, got, want)
        assert fed == {0: 0, 1: leaves[1], 2: leaves[0]}[t]


# --------------------------------------------------------------------------- #
# B1m's plain version under integer weights
# --------------------------------------------------------------------------- #


def _jax_wm(x, wj, keep):
    """JAX Engine B's ``wm`` (``src/repro/core/engine.py``, the masked fed
    mean): Σ w·x / max(Σ w, 1) in f32 where Σ w > 0, else ``keep``."""
    x, keep, wj = jnp.asarray(x), jnp.asarray(keep), jnp.asarray(wj)
    s = jnp.sum(wj)
    ww = wj.reshape((-1,) + (1,) * (x.ndim - 1))
    tot = jnp.sum(x * ww.astype(x.dtype), axis=0, keepdims=True, dtype=jnp.float32)
    mn = (tot / jnp.maximum(s, 1.0)).astype(x.dtype)
    return np.asarray(jnp.where(s > 0.0, jnp.broadcast_to(mn, x.shape), keep))


@pytest.mark.parametrize("counts", [(2, 0, 1, 2), (1, 1, 1, 1), (0, 0, 0, 0), (0, 0, 2, 0),
                                    (3, 5, 0, 8)])
def test_b1m_plain_version_takes_integer_weights_as_jax(counts):
    """Engine B passes the entities' participant counts as B1m's weight
    vector (fed level only, one group): Σ w·x / Σ w, a round of zero total
    weight keeping ``keep`` bit for bit, equals JAX's ``wm``."""
    rng = np.random.default_rng(sum(counts))
    x = rng.normal(size=(4, 300)).astype(np.float32)
    keep = rng.normal(size=(4, 300)).astype(np.float32)
    w = np.asarray(counts, np.float32)
    got = masked_tiered_aggregate_ref(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(keep), False, True, 1).numpy()
    ref = _jax_wm(x, w, keep)
    if not w.any():
        assert np.array_equal(got, keep)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------- #
# migration
# --------------------------------------------------------------------------- #


def _jax_vgg_init(jm, jp, jopt):
    """(the JAX init as NumPy, JAX's ``init_state_b``) in one compiled call:
    op by op, VGG's many leaf shapes take JAX ~10 s to dispatch."""
    key = jax.random.PRNGKey(0)
    p0, state = jax.jit(lambda k: (jm.init_params(k), jax_init_b(jm, jp, jopt, k)))(key)
    return params_to_numpy(p0), state


def _client_mean(tree):
    return [x.mean(0) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("opt_name", ["sgd", "momentum"])
def test_migrate_state_b_matches_jax_and_keeps_the_client_mean(opt_name):
    """JAX's ``tests/test_control.py`` case (a tiny VGG, N=4, cuts (2, 3) ->
    (1, 4)) from a trained-looking state: ``init_state_b`` and
    ``engine_b_to_full`` over VGG's list of units equal JAX's bit for bit,
    the migrated tier stacks (and momentum) equal JAX's, the client mean
    of the materialized model is kept, and the dispatcher needs the model
    and the old plan."""
    spec = dataclasses.replace(VGG, conv_channels=(8, 16, 16), pool_after=(0, 1),
                               fc_dims=(32, 10), name="vgg-tiny")
    jspec = dataclasses.replace(JAX_VGG, conv_channels=(8, 16, 16), pool_after=(0, 1),
                                fc_dims=(32, 10), name="vgg-tiny")
    n = 4
    kw1 = dict(cuts=(2, 3), intervals=(2, 1, 1), entities=(n, 2, 1))
    kw2 = dict(cuts=(1, 4), intervals=(1, 2, 1), entities=(n, 2, 1))
    jp1, jp2 = jax_plan(spec.n_units, n, **kw1), jax_plan(spec.n_units, n, **kw2)
    tp1, tp2 = default_plan(spec.n_units, n, **kw1), default_plan(spec.n_units, n, **kw2)
    jopt, topt = (f(1e-2) for f in OPTS[opt_name])
    jm, tm = JaxVgg(jspec), VggModel(spec)
    p0, st = _jax_vgg_init(jm, jp1, jopt)
    _assert_equal(init_state_b(_Carried(p0), tp1, topt, torch.Generator(), CPU).params,
                  st.params)
    rng = np.random.default_rng(4)
    # every entity row different, so the means are not trivial
    params = jax.tree.map(lambda x: np.asarray(x) + rng.normal(size=x.shape).astype(np.float32),
                          st.params)
    opt_state = () if opt_name == "sgd" else jax.tree.map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), st.params)
    ref = jax_migrate_b(JState(jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, opt_state), 5), jm, jp1, jp2, jopt)
    tstate = TrainState(params_from_numpy(params, CPU), params_from_numpy(opt_state, CPU), 5)
    got = migrate_state_b(tstate, tm, tp1, tp2, topt)
    assert got.step == 5
    for x, y in zip(jax.tree.leaves(params_to_numpy(got.params)), jax.tree.leaves(ref.params)):
        assert x.shape == np.asarray(y).shape
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6, atol=1e-7)
    for x, y in zip(jax.tree.leaves(params_to_numpy(got.opt_state)),
                    jax.tree.leaves(ref.opt_state)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6, atol=1e-7)
    before = engine_b_to_full(tm, tp1, tstate.params)
    _assert_equal(before, jax_to_full(jm, jp1, jax.tree.map(jnp.asarray, params)))
    after = engine_b_to_full(tm, tp2, got.params)
    for a, b in zip(_client_mean(params_to_numpy(after)), _client_mean(params_to_numpy(before))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    again = migrate_params_b(tm, got.params, tp2, tp2)
    for a, b in zip(tree_leaves(again), tree_leaves(got.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    same = migrate_state(tstate, tp2, topt, engine="b", model=tm, old_plan=tp1)
    for a, b in zip(tree_leaves(same.params), tree_leaves(got.params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="engine-b migration needs model and old_plan"):
        migrate_state(tstate, tp2, topt, engine="b")


# --------------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------------- #


def _raise_case(case):
    """(JAX call, port call) that each raise."""
    c = _setup("smollm-135m", (1, 2), (2, 2, 1))
    jm, tm = c["jm"], c["tm"]
    kw = {}
    jkw = {}
    if case == "class_members":
        kw = jkw = dict(class_members=((0, 1), (2, 3)))
    elif case == "privacy":
        jkw = dict(privacy=JDP(clip=1.0, noise_multiplier=1.0))
        kw = dict(privacy=DPMechanism(clip=1.0, noise_multiplier=1.0))
    else:  # masked MoE: only the spec is read before the raise
        jm = types.SimpleNamespace(spec=dataclasses.replace(
            c["spec"], moe=JMoe(num_experts=4, top_k=2)))
        tm = types.SimpleNamespace(spec=dataclasses.replace(
            get_reduced("smollm-135m"), moe=MoeSpec(num_experts=4, top_k=2)))
        kw = jkw = dict(with_mask=True)
    return (lambda: jax_step_b(jm, c["jp"], c["jopt"], **jkw),
            lambda: build_train_step_b(tm, c["tp"], c["topt"], **kw))


@pytest.mark.parametrize("case", ["class_members", "privacy", "masked-moe"])
def test_engine_b_refusals_equal_jax(case):
    jcall, tcall = _raise_case(case)
    with pytest.raises(NotImplementedError) as jerr:
        jcall()
    with pytest.raises(NotImplementedError) as terr:
        tcall()
    assert str(terr.value) == str(jerr.value)


def test_engine_b_refuses_vgg_where_jax_fails_too():
    """REDUCED VGG, N=4, cuts (2, 4): the port refuses at build time; JAX's
    step fails in its convolution (``apply_units`` takes the tier-local
    indices of the top tier's dense units for conv units)."""
    n = 4
    kw = dict(cuts=(2, 4), intervals=(2, 2, 1), entities=(n, 2, 1))
    jp, tp = jax_plan(VGG.n_units, n, **kw), default_plan(VGG.n_units, n, **kw)
    with pytest.raises(NotImplementedError, match="absolute unit indices"):
        build_train_step_b(VggModel(VGG), tp, sgd(0.1))
    jm = JaxVgg(JAX_VGG)
    _, state = _jax_vgg_init(jm, jp, jsgd(0.1))
    rng = np.random.default_rng(0)
    hw = JAX_VGG.image_size
    batch = {"images": jnp.asarray(rng.normal(size=(n, 2, hw, hw, 3)).astype(np.float32)),
             "labels": jnp.asarray(rng.integers(0, 10, (n, 2)).astype(np.int32))}
    with pytest.raises(TypeError, match="convolution requires lhs and rhs ndim to be equal"):
        jax_step_b(jm, jp, jsgd(0.1))(state, batch)
