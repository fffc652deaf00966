"""Unit rematerialisation (``spec.remat``, ``models/remat.py``) in the port:
the loss and every gradient with remat on equal the same model without it
bit for bit, and JAX's ``SplittableModel`` under the same ``remat`` and
``remat_policy``, for the dense, MoE, SSM, hybrid, VLM and audio families
at their REDUCED sizes and all three policies; Engine A
(``vmap(grad_and_value)``), Engine B (``torch.autograd.grad`` around
``vmap``s) and the sharded engine on two gloo ranks step under ``"full"``
as they do without it; and what a ``"full"`` segment saves.

Tolerances against JAX, each family's own (ROADMAP §C): the loss rtol
1e-5, gradients max-normalised 1e-5 per leaf; where Mamba blocks are in
the path, the port's within 1e-4 of the float64 gradient and of JAX's
beyond JAX's own distance to it (two blocks put each package's f32
gradient that far from float64, ``tests/test_torch_zoo.py``).  Engine B against Engine A:
JAX's own A == B tolerance, losses rtol 1e-5, params atol 5e-6 / rtol 1e-4.
Every init is drawn once in JAX and carried through NumPy; batches are
NumPy's.
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import repro.configs as jconfigs
from repro.models.model import SplittableModel as JaxModel
import repro_torch.configs as tconfigs
import torch_sharded_cases as C
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import (
    build_train_step_a, build_train_step_b, default_plan, init_state_a, init_state_b,
)
from repro_torch.launch.mesh import run_on_ranks
from repro_torch.models import SplittableModel, params_from_numpy, params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models.remat import POLICIES, remat
from repro_torch.optim import sgd

CPU = torch.device("cpu")
ARCHS = {
    "dense": "smollm-135m", "moe": "granite-moe-1b-a400m", "ssm": "mamba2-1.3b",
    "hybrid": "jamba-1.5-large-398b", "vlm": "paligemma-3b", "audio": "whisper-large-v3",
}
NORM_TOL = 1e-5
MAMBA, MAMBA_TOL = ("ssm", "hybrid"), 1e-4
S, TEXT = 16, 12  # tokens of the LM families; text tokens of the VLM and audio ones
N, B, STEPS = 4, 2, 3  # the engines: clients, batch, steps
LOSS_RTOL, LOSS_ATOL, ATOL, RTOL = 1e-5, 1e-6, 5e-6, 1e-4


def _with_remat(spec, policy):
    return dataclasses.replace(spec, remat=True, remat_policy=policy)


@functools.lru_cache(maxsize=None)
def _init(arch):
    """One JAX init (``PRNGKey(0)``) as NumPy arrays, every leaf nudged so
    that zero-initialised norms and biases take part."""
    p = params_to_numpy(JaxModel(jconfigs.get_reduced(arch)).init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(100)
    return jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(x.dtype), p)


def _batch(spec, lead, seed):
    """Tokens and labels [*lead, T] (the first two labels masked), with the
    VLM's patch embeddings or the audio model's frames."""
    rng = np.random.default_rng(seed)
    T = S if spec.family not in ("vlm", "audio") else TEXT
    toks = rng.integers(0, spec.vocab_size, tuple(lead) + (T + 1,)).astype(np.int32)
    labels = toks[..., 1:].copy()
    labels[..., :2] = -1
    out = {"tokens": toks[..., :-1], "labels": labels}
    if spec.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=tuple(lead) + (spec.prefix_len, spec.d_model)).astype(np.float32)
    if spec.family == "audio":
        out["frames"] = rng.normal(
            size=tuple(lead) + (spec.encoder_len, spec.d_model)).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(model, p, batch):
    """(loss, gradients in ``tree_leaves`` order) by plain autograd."""
    tp = params_from_numpy(p, CPU)
    live = [x.requires_grad_(True) for x in tree_leaves(tp)]
    loss = model.loss_fn(tp, batch)
    return loss.detach(), torch.autograd.grad(loss, live)


def _equal(a, b, what):
    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        assert torch.equal(x, y), f"{what}: leaf {i} differs"


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", list(ARCHS))
def test_remat_is_the_plain_model_bit_for_bit(family, policy):
    """The loss and every gradient, by plain autograd and under Engine A's
    ``vmap(grad_and_value)`` over two clients, equal the model's without
    remat bit for bit."""
    spec = tconfigs.get_reduced(ARCHS[family])
    plain, rm = SplittableModel(spec), SplittableModel(_with_remat(spec, policy))
    p, batch = _init(ARCHS[family]), _torch(_batch(spec, (B,), seed=1))
    l0, g0 = _loss_and_grads(plain, p, batch)
    l1, g1 = _loss_and_grads(rm, p, batch)
    assert torch.equal(l0, l1)
    _equal(g1, g0, f"{family} {policy} autograd")
    pN = tree_map(lambda x: torch.stack([x, 1.01 * x]), params_from_numpy(p, CPU))
    bN = _torch(_batch(spec, (2, B), seed=2))
    ref = vmap(grad_and_value(plain.loss_fn))(pN, bN)
    got = vmap(grad_and_value(rm.loss_fn))(pN, bN)
    _equal(got, ref, f"{family} {policy} vmap(grad_and_value)")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", list(ARCHS))
def test_remat_matches_jax_remat(family, policy):
    """The port under ``remat`` against ``jax.checkpoint`` under the same
    policy: the loss rtol 1e-5, every gradient max-normalised 1e-5.  Where
    Mamba blocks are in the path both packages' f32 gradients drift from
    the float64 one (the same model in float64 on the port): the port's is
    held within 1e-4 of it, and its distance to JAX's within JAX's own
    distance to it plus 1e-4 (at this input JAX's SSM gradient lands
    1.5e-4 from float64, the port's 1.3e-5)."""
    arch = ARCHS[family]
    jspec = _with_remat(jconfigs.get_reduced(arch), policy)
    tspec = _with_remat(tconfigs.get_reduced(arch), policy)
    p, batch = _init(arch), _batch(tspec, (B,), seed=3)
    jp, jb = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, batch)
    jloss, jgrads = jax.value_and_grad(JaxModel(jspec).loss_fn)(jp, jb)
    tloss, tgrads = _loss_and_grads(SplittableModel(tspec), p, _torch(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = _grads_by_path(p, tgrads)
    ref = {k: np.asarray(v, np.float64) for k, v in _named(params_to_numpy(jgrads))}
    assert got.keys() == ref.keys()
    if family not in MAMBA:
        for k, r in ref.items():
            assert _err(got[k], r) <= NORM_TOL * np.abs(r).max(), (family, policy, k)
        return
    s64 = dataclasses.replace(tspec, param_dtype="float64", compute_dtype="float64")
    p64 = jax.tree.map(lambda x: x.astype(np.float64), p)
    b64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
    f64 = _grads_by_path(p64, _loss_and_grads(SplittableModel(s64), p64, _torch(b64))[1])
    for k, r in f64.items():
        scale = np.abs(r).max()
        assert _err(got[k], r) <= MAMBA_TOL * scale, (family, policy, k, "float64")
        assert _err(got[k], ref[k]) <= _err(ref[k], r) + MAMBA_TOL * scale, (family, policy, k)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _grads_by_path(p, grads):
    """{path: gradient as float64 NumPy} of the port's gradients, which come
    in ``tree_leaves`` order of ``params_from_numpy(p)``."""
    tree = _as_tree(params_from_numpy(p, CPU), grads)
    return {k: v.numpy().astype(np.float64) for k, v in _named(tree)}


def _as_tree(template, flat):
    """``flat`` (in ``tree_leaves`` order) in ``template``'s tree."""
    it = iter(flat)
    return tree_map(lambda _: next(it), template)


def _named(tree, prefix=()):
    """(path, leaf) pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _named(v, prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _named(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def saved_tensors_of(out):
    """The tensors that the ``_Remat`` node producing the tree ``out`` keeps
    for its backward."""
    for t in tree_leaves(out):
        fn = getattr(t, "grad_fn", None)
        if fn is not None and type(fn).__name__ == "_RematBackward":
            return tuple(fn.saved_tensors)
    raise AssertionError("no remat node made the output")


def test_full_saves_only_the_inputs():
    """A ``"full"`` segment keeps its input carry and its unit's parameters
    and nothing else; ``"dots"`` keeps those and one output a weight
    product (q, k, v, o, w1, w3, w2 of a dense unit)."""
    spec = tconfigs.get_reduced("smollm-135m")
    model = SplittableModel(spec)
    p = params_from_numpy(_init("smollm-135m"), CPU)
    up = tree_map(lambda x: x[0].requires_grad_(True),
                  tree_map(lambda x: x.clone(), p["units"]))
    h = torch.randn(B, S, spec.d_model, requires_grad=True)
    carry = {"h": h, "aux": torch.zeros(())}
    body = lambda u, c: model._apply_one_unit(u, c, 0, 1)
    inputs = {id(t) for t in tree_leaves((up, carry))}
    saved = saved_tensors_of(remat(body, up, carry, policy="full"))
    assert len(saved) == len(inputs)
    assert {id(t) for t in saved} == inputs
    saved = saved_tensors_of(remat(body, up, carry, policy="dots"))
    assert {id(t) for t in saved[:len(inputs)]} == inputs
    extra = saved[len(inputs):]
    assert len(extra) == 7, len(extra)
    assert [tuple(t.shape[-1:]) for t in extra] == [
        (spec.num_heads * spec.hd,), (spec.num_kv_heads * spec.hd,),
        (spec.num_kv_heads * spec.hd,), (spec.d_model,), (spec.d_ff,), (spec.d_ff,),
        (spec.d_model,)]


def test_remat_refuses_an_unknown_policy():
    spec = tconfigs.get_reduced("smollm-135m")
    with pytest.raises(ValueError, match="remat policy"):
        SplittableModel(_with_remat(spec, "none"))
    with pytest.raises(ValueError, match="remat policy"):
        remat(lambda x: x, torch.ones(1), policy="none")


def test_dot_outside_a_segment_is_the_product():
    x, w = torch.randn(3, 4), torch.randn(4, 5)
    assert torch.equal(L.dot(x, w), x @ w)


# --------------------------------------------------------------------------- #
# the engines
# --------------------------------------------------------------------------- #


class _Carried:
    def __init__(self, p0):
        self.p0 = p0

    def init_params(self, generator, device=None):
        return params_from_numpy(self.p0, device)


def _run(build, init, family, spec, remat_policy):
    """(losses, final state) of STEPS steps of the engine ``build`` makes on
    ``spec`` (under ``remat_policy`` when given) from the carried init."""
    if remat_policy:
        spec = _with_remat(spec, remat_policy)
    model, opt = SplittableModel(spec), sgd(1e-2)
    plan = default_plan(spec.n_units, N, cuts=(1, 2), intervals=(2, 2, 1), entities=(N, 2, 1))
    state = init(_Carried(_init(ARCHS[family])), plan, opt, torch.Generator(), CPU)
    step = build(model, plan, opt)
    losses = []
    rng = np.random.default_rng(7)
    for t in range(STEPS):
        batch = _torch(_batch(spec, (N, B), seed=int(rng.integers(1 << 30))))
        state, loss = step(state, batch)
        losses.append(loss)
    return losses, state


@pytest.mark.parametrize("family", list(ARCHS))
def test_engines_under_full_remat_step_as_without(family):
    """Engine A and Engine B, three steps each under ``"full"``, equal the
    same engine without remat bit for bit; Engine B under remat equals
    Engine A under remat at JAX's A == B tolerance."""
    spec = tconfigs.get_reduced(ARCHS[family])
    runs = {}
    for engine, build, init in (("a", build_train_step_a, init_state_a),
                                ("b", build_train_step_b, init_state_b)):
        ref = _run(build, init, family, spec, None)
        got = _run(build, init, family, spec, "full")
        runs[engine] = got
        for t, (x, y) in enumerate(zip(got[0], ref[0])):
            assert torch.equal(x, y), (engine, t)
        _equal(got[1].params, ref[1].params, f"{family} engine {engine}")
    from repro_torch.core.engine import engine_b_to_full

    la, sa = runs["a"]
    lb, sb = runs["b"]
    np.testing.assert_allclose([float(x) for x in lb], [float(x) for x in la],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    plan = default_plan(spec.n_units, N, cuts=(1, 2), intervals=(2, 2, 1), entities=(N, 2, 1))
    full = engine_b_to_full(SplittableModel(spec), plan, sb.params)
    for x, y in zip(tree_leaves(full), tree_leaves(sa.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def sharded_runs():
    p0 = _init(C.ARCH)
    two = run_on_ranks(C.rank_remat_cases, 2, device="cpu", args=(p0,))
    one = run_on_ranks(C.rank_remat_cases, 1, device="cpu", args=(p0,))
    return p0, one, two


def test_sharded_engine_under_full_remat_steps_as_without(sharded_runs):
    """The sharded engine on two gloo ranks (and on one) under ``"full"``
    equals the same sharded run without remat bit for bit, and a world of
    one rank equals the unsharded engine under remat bit for bit."""
    p0, one, two = sharded_runs
    for world, runs in (("2 ranks", two), ("1 rank", one)):
        (rl, rp), (pl, pp) = runs["remat"], runs["plain"]
        assert rl == pl, world
        for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(pp)):
            np.testing.assert_array_equal(a, b, err_msg=world)
    ul, up = C.run_engine("plain", p0, remat="full")
    assert one["remat"][0] == ul
    for a, b in zip(jax.tree.leaves(one["remat"][1]), jax.tree.leaves(up)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_frees_each_unit_under_engine_a(policy):
    """The peak of live bytes of one ``vmap(grad_and_value)`` step on
    ``meta`` tensors (``launch.dryrun_lib``'s tally), 8 units of REDUCED
    smollm-135m at 512 tokens: without remat every unit's internals live
    until the backward reaches them (``torch.func.grad`` records the
    backward too); with it a unit's replay is freed once its backward is
    done, so the peak falls below half (``"dots"`` keeps one output a
    weight product: below three quarters)."""
    from repro_torch.launch import dryrun_lib as D

    spec = dataclasses.replace(tconfigs.get_reduced("smollm-135m"), num_layers=8)
    batch = {k: torch.empty((2, 1, 512), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    peaks = {}
    for name, s in (("plain", spec), (policy, _with_remat(spec, policy))):
        model = SplittableModel(s)
        params = tree_map(lambda x: x.expand((2,) + tuple(x.shape)), D.meta_params(model))
        tally = D._Tally()
        with tally:
            vmap(grad_and_value(model.loss_fn))(params, batch)
        peaks[name] = tally.peak
    assert peaks[policy] < (0.75 if policy == "dots" else 0.5) * peaks["plain"], peaks
