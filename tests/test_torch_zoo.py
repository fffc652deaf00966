"""The MoE, SSM and hybrid families in the port against the JAX package:
the specs, the parameter tree leaf for leaf, ``SplittableModel``'s logits,
aux, loss and gradients for granite-moe-1b-a400m, phi3.5-moe, mamba2-1.3b
and jamba-1.5-large at their REDUCED sizes; Engine A and Engine B step by
step against ``build_train_step_a`` / ``build_train_step_b`` at
``tests/test_engines_equal.py``'s plans, and port A == port B; Engine B's
per-tier MoE groups; the training CLI and ``api.run`` on these archs; and
the hybrid's nested sub-stacks through ``models/convert``, ``core/tiers``,
``core/estimator`` and ``control/migrate``.  Every init is drawn once in
JAX and carried through NumPy; batches are NumPy's.

Tolerances.  The model: logits and loss rtol 1e-5 / atol 1e-5 (the dense
family's), gradients at a max-normalised 1e-5 per leaf.  Where Mamba
blocks are in the path, logits at a max-normalised 2e-5 and gradients at
1e-4: through two blocks each package's f32 gradient lands up to 1e-4
(normalised) from the float64 one — the port 1.0e-4, JAX 5.4e-5 on jamba
at S = 50 — and they differ from each other by up to 4.6e-5.  The engines: losses
rtol 1e-5, params atol 5e-6 / rtol 1e-4 (JAX's own A == B), except jamba's
params at atol 1.5e-5: the reference's own A == B on jamba misses 5e-6 on
5 of 524 288 elements by up to 7.88e-6 (f32 summation order in the hybrid
super-block), and the port stands where the reference does."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

import repro.configs as jconfigs
from repro import api as J
from repro.api.registry import resolve_model as jax_resolve_model
from repro.control.migrate import migrate_state_b as jax_migrate_state_b
from repro.core import (
    build_train_step_a as jax_step_a, build_train_step_b as jax_step_b,
    init_state_a as jax_init_a, init_state_b as jax_init_b,
)
from repro.core.engine import TrainState as JState
from repro.core.estimator import _unit_sq_norms as jax_unit_sq_norms
from repro.core.tiers import (
    default_plan as jax_plan, synchronize as jax_synchronize, tier_subtrees as jax_tier_subtrees,
)
from repro.models.model import SplittableModel as JaxModel
from repro.optim import momentum as jmomentum, sgd as jsgd
import repro_torch.configs as tconfigs
from repro_torch import api as T
from repro_torch.control.migrate import migrate_state_b
from repro_torch.core import (
    TrainState, build_train_step_a, build_train_step_b, default_plan, init_state_b,
    replicate_for_clients,
)
from repro_torch.core.engine import engine_b_to_full
from repro_torch.core.estimator import _unit_sq_norms
from repro_torch.core.tiers import combine_tiers, synchronize, tier_subtrees
from repro_torch.launch import train
from repro_torch.models import SplittableModel, params_from_numpy, params_to_numpy
from repro_torch.models import layers as L
from repro_torch.optim import momentum, sgd

CPU = torch.device("cpu")
ZOO = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b", "jamba-1.5-large-398b"]
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
N, B, S, STEPS = 8, 2, 16, 4
LOSS_RTOL, LOSS_ATOL, ATOL, RTOL = 1e-5, 1e-6, 5e-6, 1e-4
JAMBA_ATOL = 1.5e-5
# tests/test_engines_equal.py's plans
PLANS = {
    "mamba2-1.3b": ((1, 2), (2, 2, 1)),
    "granite-moe-1b-a400m": ((1, 2), (2, 3, 1)),
    "jamba-1.5-large-398b": ((1, 1), (4, 2, 1)),
}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, prefix + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, prefix + (str(i),)).items()}
    if isinstance(tree, torch.Tensor):
        return {"/".join(prefix): tree.detach().numpy()}
    return {"/".join(prefix): np.asarray(tree)}


@functools.lru_cache(maxsize=None)
def _init(arch):
    """One JAX init per arch (``PRNGKey(0)``), as NumPy arrays."""
    return params_to_numpy(JaxModel(jconfigs.get_reduced(arch)).init_params(
        jax.random.PRNGKey(0)))


def _perturbed(arch, seed=0):
    """The JAX init with every leaf nudged, so zero-initialised norms and
    biases take part in the comparison."""
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(x.dtype),
                        _init(arch))


def _tokens(vocab, shape, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape[:-1] + (shape[-1] + 1,)).astype(np.int32)
    labels = toks[..., 1:].copy()
    labels[..., :3] = -1  # masked label positions
    return {"tokens": toks[..., :-1], "labels": labels}


def _norm_close(got, ref, tol, what):
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max()) if ref.size else 0.0
    assert err <= tol * float(np.abs(ref).max() if ref.size else 0.0), (what, err)


# --------------------------------------------------------------------------- #
# specs, registry, parameter trees
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ZOO)
def test_spec_counts_match_jax(arch):
    for variant in ("SPEC", "REDUCED"):
        t = getattr(tconfigs._mod(arch), variant)
        j = getattr(jconfigs._mod(arch), variant)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.hd, t.padded_vocab, t.n_units, t.layers_per_unit) == (
            j.hd, j.padded_vocab, j.n_units, j.layers_per_unit)
        assert t.total_param_count() == j.total_param_count()
        assert t.active_param_count() == j.active_param_count()
        for b, s in ((1, 64), (2, 512)):
            assert t.unit_flops_fwd(0, b, s) == j.unit_flops_fwd(0, b, s)
    # the full-width sizes PERF.md and the card's [zoo] phase rely on
    counts = {"granite-moe-1b-a400m": 1_385_481_216, "mamba2-1.3b": 1_343_794_176}
    if arch in counts:
        assert tconfigs.get_spec(arch).total_param_count() == counts[arch]


@pytest.mark.parametrize("arch", ZOO)
def test_init_params_is_the_jax_tree(arch):
    """Structure, shapes and dtypes leaf for leaf, the hybrid's sub-stacks
    included; one seed gives one model."""
    spec = tconfigs.get_reduced(arch)
    p = SplittableModel(spec).init_params(torch.Generator().manual_seed(0), CPU)
    got, ref = _flat(p), _flat(_init(arch))
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    q = SplittableModel(spec).init_params(torch.Generator().manual_seed(0), CPU)
    assert all(np.array_equal(a, b) for a, b in zip(_flat(p).values(), _flat(q).values()))
    if spec.family == "hybrid":
        per, U = spec.attn_period, spec.n_units
        n_moe = per // spec.moe_period
        assert p["units"]["mamba"]["in_proj"].shape[:2] == (U, per - 1)
        assert p["units"]["moe"]["w1"].shape[:2] == (U, n_moe)
        assert p["units"]["mlp"]["w1"].shape[:2] == (U, per - n_moe)


MODEL_CASES = [("granite-moe-1b-a400m", 64), ("phi3.5-moe-42b-a6.6b", 64),
               ("mamba2-1.3b", 64), ("mamba2-1.3b", 40), ("jamba-1.5-large-398b", 64),
               ("jamba-1.5-large-398b", 50)]


@pytest.mark.parametrize("arch,seq", MODEL_CASES)
def test_model_logits_aux_loss_and_grads_match_jax(arch, seq):
    """Logits, the summed aux, the loss (with 0.01·aux for the MoE archs)
    and every gradient; mamba2 at S = 40 and jamba at 50 run the scan's
    padded last chunk."""
    jspec, tspec = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jm, tm = JaxModel(jspec), SplittableModel(tspec)
    p = _perturbed(arch)
    batch = _tokens(jspec.vocab_size, (2, seq), seed=seq)
    jp, jb = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, batch)
    jlogits, jaux = jm.forward(jp, jb)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jp, jb)
    tp = params_from_numpy(p, CPU)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits, taux = tm.forward(tp, tb)
    if jspec.ssm is None:
        np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), **MODEL_TOL)
    else:  # the Mamba blocks' f32 noise (tests/test_torch_ssm.py)
        _norm_close(tlogits.detach().numpy(), jlogits, 2e-5, "logits")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-6)
    assert (float(taux) == 0.0) == (jspec.moe is None)
    np.testing.assert_allclose(float(tm.loss_fn(tp, tb)), float(jloss), rtol=1e-5)
    tg, jg = _flat(grad(tm.loss_fn)(tp, tb)), _flat(params_to_numpy(jgrads))
    assert tg.keys() == jg.keys()
    tol = 1e-5 if jspec.ssm is None else 1e-4
    for k in jg:
        _norm_close(tg[k], jg[k], tol, k)


def test_apply_units_in_pieces_equals_the_whole():
    """Jamba's super-blocks one at a time equal both at once, the aux
    carried along."""
    spec = tconfigs.get_reduced("jamba-1.5-large-398b")
    m = SplittableModel(spec)
    p = params_from_numpy(_perturbed("jamba-1.5-large-398b"), CPU)
    tb = {k: torch.from_numpy(v) for k, v in _tokens(spec.vocab_size, (2, 32), 3).items()}
    carry = m.frontend_apply(p["frontend"], tb)
    whole = m.apply_units(p["units"], carry, 0, 2)
    parts = m.apply_units(p["units"], m.apply_units(p["units"], carry, 0, 1), 1, 2)
    torch.testing.assert_close(parts["h"], whole["h"], rtol=0, atol=0)
    torch.testing.assert_close(parts["aux"], whole["aux"], rtol=0, atol=0)
    assert float(whole["aux"]) > 0.0


def test_jamba_tree_crosses_packages_through_numpy_unchanged():
    """``params_from_numpy`` / ``params_to_numpy`` walk the hybrid's nested
    sub-stacks: JAX's REDUCED jamba tree (client-stacked too) goes to
    torch and back bit for bit, every leaf in place."""
    p0 = _init("jamba-1.5-large-398b")
    for tree in (p0, jax.tree.map(lambda x: np.stack([x, x + 1.0]), p0)):
        back = params_to_numpy(params_from_numpy(tree, CPU))
        a, b = _flat(back), _flat(tree)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert _flat(p0)["units/mamba/in_proj"].ndim == 4  # [U, per - 1, d, ·]


# --------------------------------------------------------------------------- #
# the engines, step by step
# --------------------------------------------------------------------------- #


class _Carried:
    def __init__(self, p0):
        self.p0 = p0

    def init_params(self, generator, device=None):
        return params_from_numpy(self.p0, device)


def _batches(vocab, steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, vocab, (N, B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def _plans(arch):
    cuts, intervals = PLANS[arch]
    kw = dict(cuts=cuts, intervals=intervals, entities=(N, 4, 1))
    n = jconfigs.get_reduced(arch).n_units
    return jax_plan(n, N, **kw), default_plan(n, N, **kw)


@functools.lru_cache(maxsize=None)
def _runs(arch):
    """(losses, params as NumPy) after every step of JAX's Engine A, JAX's
    Engine B, the port's A and the port's B, sgd 1e-2, from one init."""
    jp, tp = _plans(arch)
    jm, tm = JaxModel(jconfigs.get_reduced(arch)), SplittableModel(tconfigs.get_reduced(arch))
    batches = _batches(jm.spec.vocab_size)
    out = {}
    for name, init, build in (("jax_a", jax_init_a, jax_step_a), ("jax_b", jax_init_b, jax_step_b)):
        state = init(jm, jp, jsgd(1e-2), jax.random.PRNGKey(0))
        step = jax.jit(build(jm, jp, jsgd(1e-2)))
        res = []
        for b in batches:
            state, loss = step(state, jax.tree.map(jnp.asarray, b))
            res.append((float(loss), params_to_numpy(state.params)))
        out[name] = res
    params = replicate_for_clients(params_from_numpy(_init(arch), CPU), N)
    states = {"port_a": (TrainState(params, (), 0), build_train_step_a(tm, tp, sgd(1e-2))),
              "port_b": (init_state_b(_Carried(_init(arch)), tp, sgd(1e-2), torch.Generator(), CPU),
                         build_train_step_b(tm, tp, sgd(1e-2)))}
    for name, (state, step) in states.items():
        res = []
        for b in batches:
            state, loss = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            res.append((float(loss), state.params))
        out[name] = res
    assert tm.moe_groups == 1  # Engine B restores the dispatch's group count
    return out


def _atol(arch):
    return JAMBA_ATOL if arch.startswith("jamba") else ATOL


def _steps_close(got, ref, atol, to_numpy=params_to_numpy):
    for t, ((tl, tp), (jl, jp)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=f"step {t}")
        a, b = jax.tree.leaves(to_numpy(tp)), jax.tree.leaves(jp)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == np.asarray(y).shape
            np.testing.assert_allclose(x, np.asarray(y), atol=atol, rtol=RTOL, err_msg=f"step {t}")


@pytest.mark.parametrize("arch", list(PLANS))
def test_engine_a_matches_jax(arch):
    """N = 8, J₂ = 4, batch 2, S = 16, 4 steps, sgd 1e-2: losses rtol 1e-5,
    the client-stacked params atol 5e-6 (jamba 1.5e-5) / rtol 1e-4 after
    every step."""
    r = _runs(arch)
    _steps_close(r["port_a"], r["jax_a"], _atol(arch))


@pytest.mark.parametrize("arch", list(PLANS))
def test_engine_b_matches_jax(arch):
    """The split-placement engine, every tier's entity stacks after every
    step: MoE tiers dispatched per client group, the aux bookkeeping
    0.01·(aux below the top / N + the top's aux)."""
    r = _runs(arch)
    _steps_close(r["port_b"], r["jax_b"], _atol(arch))


@pytest.mark.parametrize("arch", list(PLANS))
def test_port_engine_a_equals_engine_b(arch):
    """From one init, step by step: A's per-client gather combine against
    B's grouped scatter-add, at JAX's A == B tolerance (jamba: its own)."""
    r = _runs(arch)
    tm = SplittableModel(tconfigs.get_reduced(arch))
    _, tp = _plans(arch)
    full = [(lb, engine_b_to_full(tm, tp, pb)) for lb, pb in r["port_b"]]
    _steps_close([(la, pa) for la, pa in r["port_a"]],
                 [(lb, params_to_numpy(pb)) for lb, pb in full], _atol(arch))


def test_engine_b_dispatches_each_tier_in_client_groups(monkeypatch):
    """granite REDUCED with cuts (1, 1) over 3 units: tier 1's unit runs per
    client (one group of b·S tokens), tier 2 has no unit, tier 3's two
    units pool all N clients in N groups; every group holds one client's
    b·S tokens, and the model's count is back at 1 after the step — also
    when the step raises."""
    spec = dataclasses.replace(tconfigs.get_reduced("granite-moe-1b-a400m"), num_layers=3)
    model = SplittableModel(spec)
    plan = default_plan(3, N, cuts=(1, 1), intervals=(2, 2, 1), entities=(N, 4, 1))
    state = init_state_b(model, plan, sgd(1e-2), torch.Generator().manual_seed(0), CPU)
    seen, real = [], L.moe

    def moe(params, x, spec, groups=1):
        seen.append((groups, x.shape[0] * x.shape[1] // groups))
        return real(params, x, spec, groups=groups)

    monkeypatch.setattr(L, "moe", moe)
    step = build_train_step_b(model, plan, sgd(1e-2))
    batch = {k: torch.from_numpy(v) for k, v in _batches(spec.vocab_size, 1)[0].items()}
    state, loss = step(state, batch)
    assert seen == [(1, B * S), (N, B * S), (N, B * S)] and model.moe_groups == 1
    # a middle tier pools per = N / J₂ clients
    plan2 = default_plan(3, N, cuts=(1, 2), intervals=(2, 2, 1), entities=(N, 4, 1))
    seen.clear()
    state2 = init_state_b(model, plan2, sgd(1e-2), torch.Generator().manual_seed(0), CPU)
    build_train_step_b(model, plan2, sgd(1e-2))(state2, batch)
    assert seen == [(1, B * S), (N // 4, B * S), (N, B * S)]

    def broken(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(L, "moe", broken)
    model.moe_groups = 1
    with pytest.raises(RuntimeError, match="boom"):
        step(state, batch)
    assert model.moe_groups == 1


def test_masked_moe_engine_b_refusal_is_jax_s():
    """The real MoE spec under a mask: refused with JAX's message, word for
    word."""
    jp, tp = _plans("granite-moe-1b-a400m")
    with pytest.raises(NotImplementedError) as jerr:
        jax_step_b(JaxModel(jconfigs.get_reduced("granite-moe-1b-a400m")), jp, jsgd(0.1),
                   with_mask=True)
    with pytest.raises(NotImplementedError) as terr:
        build_train_step_b(SplittableModel(tconfigs.get_reduced("granite-moe-1b-a400m")), tp,
                           sgd(0.1), with_mask=True)
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------------------------- #
# the hybrid's sub-stacks through tiers, the estimator and the migration
# --------------------------------------------------------------------------- #


def _stacked_jamba(n=4, seed=0):
    """A client-stacked REDUCED jamba tree, every client row different."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.stack([x + 0.1 * rng.normal(size=x.shape).astype(x.dtype)
                                            for _ in range(n)]), _init("jamba-1.5-large-398b"))


def test_jamba_tiers_estimator_and_sync_match_jax():
    """Leaves [N, U, n, …]: ``tier_subtrees`` slices the unit axis and
    ``combine_tiers`` puts them back bit for bit, equal to JAX's slices;
    ``synchronize`` at a fed round equals JAX's; the estimator's per-unit
    squared norms fold each sub-stack into its unit as JAX's do."""
    n = 4
    tree = _stacked_jamba(n)
    kw = dict(cuts=(1, 1), intervals=(2, 2, 1), entities=(n, 2, 1))
    jp, tp = jax_plan(2, n, **kw), default_plan(2, n, **kw)
    tt = params_from_numpy(tree, CPU)
    parts = tier_subtrees(tt, tp)
    for a, b in zip(parts, jax_tier_subtrees(jax.tree.map(jnp.asarray, tree), jp)):
        x, y = _flat(a), _flat(params_to_numpy(b))
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
    back = _flat(combine_tiers(parts, tt))
    assert all(np.array_equal(back[k], v) for k, v in _flat(tree).items())
    got = _flat(synchronize(tt, tp, 1))
    ref = _flat(params_to_numpy(jax_synchronize(jax.tree.map(jnp.asarray, tree), jp, 1)))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(_unit_sq_norms(tt, 2).numpy(),
                               np.asarray(jax_unit_sq_norms(jax.tree.map(jnp.asarray, tree), 2)),
                               rtol=1e-6)


def test_jamba_engine_b_migration_matches_jax():
    """Engine-B tier stacks of jamba's two super-blocks, cuts (1, 1) -> (0, 1)
    and back to (1, 2), momentum carried: ``migrate_state_b`` re-slices the
    units with their sub-stacks as JAX's does (rtol 1e-6)."""
    n = 4
    tree = _stacked_jamba(n, seed=1)
    plans = {c: (jax_plan(2, n, cuts=c, intervals=(2, 2, 1), entities=(n, 2, 1)),
                 default_plan(2, n, cuts=c, intervals=(2, 2, 1), entities=(n, 2, 1)))
             for c in ((1, 1), (0, 1), (1, 2))}
    jp_old, tp_old = plans[(1, 1)]
    tiers = [jax.tree.map(lambda x, per=n // jp_old.entities[m]: x[::per], part)
             for m, part in enumerate(jax_tier_subtrees(tree, jp_old))]
    moments = jax.tree.map(lambda x: 0.5 * x, tiers)
    jm = JaxModel(jconfigs.get_reduced("jamba-1.5-large-398b"))
    tm = SplittableModel(tconfigs.get_reduced("jamba-1.5-large-398b"))
    for cuts in ((0, 1), (1, 2)):
        jp_new, tp_new = plans[cuts]
        ref = jax_migrate_state_b(JState(jax.tree.map(jnp.asarray, tiers),
                                         jax.tree.map(jnp.asarray, moments), 3),
                                  jm, jp_old, jp_new, jmomentum(1e-2))
        got = migrate_state_b(TrainState(params_from_numpy(tiers, CPU),
                                         params_from_numpy(moments, CPU), 3),
                              tm, tp_old, tp_new, momentum(1e-2))
        for out, want in ((got.params, ref.params), (got.opt_state, ref.opt_state)):
            x, y = _flat(out), _flat(params_to_numpy(want))
            assert x.keys() == y.keys()
            for k in y:
                assert x[k].shape == y[k].shape, k
                np.testing.assert_allclose(x[k], y[k], rtol=1e-6, atol=1e-7, err_msg=k)


# --------------------------------------------------------------------------- #
# the entry points
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-1.3b"])
def test_train_cli_runs_the_arch_and_jax_reads_its_checkpoint(arch, tmp_path, capsys):
    ckpt = tmp_path / "lm.npz"
    rc = train.main(["--device", "cpu", "--arch", arch, "--rounds", "2", "--clients", "4",
                     "--edges", "2", "--batch", "2", "--log-every", "1",
                     "--checkpoint", str(ckpt)])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"arch={arch} units=2" in out
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.startswith("round")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    from repro.checkpoint import load_checkpoint as jax_load
    from repro.core.engine import replicate_for_clients as jax_replicate

    template = jax_replicate(JaxModel(jconfigs.get_reduced(arch)).init_params(
        jax.random.PRNGKey(1)), 4)
    tree, step, meta = jax_load(str(ckpt), template)
    assert step == 2
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(template)):
        assert np.asarray(a).shape == np.asarray(b).shape and np.isfinite(np.asarray(a)).all()


def _api_spec(arch, engine):
    """REDUCED arch (2 units), N = 4, J₂ = 2, batch 2, seq 32, 3 rounds."""
    return J.paper_spec().replace(
        model=J.ModelCfg(arch=arch, variant="reduced", batch=2, seq=32),
        system=J.SystemCfg(num_clients=4, num_edges=2),
        solver=J.SolverCfg(kind="fixed", cuts=(1, 1), intervals=(2, 2, 1)),
        run=J.RunCfg(mode="train", rounds=3, dataset_size=64, lr=0.1, engine=engine),
    )


@pytest.mark.parametrize("arch,engine", [("granite-moe-1b-a400m", "a"),
                                         ("granite-moe-1b-a400m", "b"),
                                         ("jamba-1.5-large-398b", "a")])
def test_api_train_mode_matches_jax(arch, engine, monkeypatch):
    """``api.run`` in train mode against JAX's ``api.run`` from a carried
    init: losses rtol 1e-4, every other train field equal."""
    import json

    js = _api_spec(arch, engine)
    ref = J.run(js)
    p0 = params_to_numpy(JaxModel(jax_resolve_model(js.model)).init_params(
        jax.random.PRNGKey(js.run.seed)))
    run_mod = sys.modules["repro_torch.api.run"]
    if engine == "a":
        def carried(model, plan, opt, generator, device=None):
            params = replicate_for_clients(params_from_numpy(p0, device), plan.num_clients)
            return TrainState(params, opt.init(params), 0)

        monkeypatch.setattr(run_mod, "init_state_a", carried)
    else:
        monkeypatch.setattr(run_mod, "init_state_b",
                            lambda model, plan, opt, generator, device=None:
                            init_state_b(_Carried(p0), plan, opt, generator, device))
    got = T.run(T.ExperimentSpec.from_dict(json.loads(json.dumps(js.to_dict()))), device="cpu")
    np.testing.assert_allclose(got.train["losses"], ref.train["losses"], rtol=1e-4)
    a, b = got.to_dict()["train"], ref.to_dict()["train"]
    assert a.keys() == b.keys()
    for k in b:
        if k not in ("losses", "first_loss", "final_loss", "wall_s", "round_ms"):
            assert a[k] == b[k], k
