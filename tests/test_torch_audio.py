"""The audio family (whisper-large-v3, ROADMAP A14.5) in the port against the
JAX package: the spec, registry and parameter tree (cross-attention blocks
without biases or norms), the attention kernels' plain versions with
Sq != Sk (cross-attention) and bidirectional (the encoder), ``layers.attention``
with ``kv_override``, ``causal=False`` and ``use_rope=False``, the model's
forward, loss and gradients, Engines A and B step by step, the enc ++ dec
layout through ``tier_subtrees`` / ``combine_tiers``, the estimator and the
layout rules, decoding with its cross caches, and the refusals of both CLIs,
``api.run`` and the ragged per-class sync.  Every init is drawn once in JAX
and carried through NumPy; batches are NumPy's.

Tolerances.  The attention plain versions against JAX's ``_sdpa`` (zero
bias, or ``_mask_bias(causal=False)``) and its ``jax.grad``: ATTN_TOL =
2e-5, rtol = atol for o and max-normalised for the gradients (the flash
backward sums in another order than ``jax.grad``).  The model: logits and
loss rtol 1e-5 / atol 1e-5, gradients max-normalised 1e-5 per leaf.
Decode: logits and caches rtol 1e-5 / atol 1e-5.  The engines: losses rtol
1e-5, params atol 5e-6 / rtol 1e-4 (JAX's own A == B).

The JAX package's Engine B applies each tier's slice of the two stacks
with the global encoder count, ``spec.encoder_layers``, as the boundary, so
a tier that holds at most ``encoder_layers`` units never runs its decoder
units (ROADMAP §C): its losses stand apart from its Engine A's.  The port's
Engine B runs each tier's own units, equals its Engine A and JAX's Engine
A, and with JAX's boundary rule (``_JaxSplitModel``) it equals JAX's
Engine B step by step.
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import api as J
from repro.core import (
    build_train_step_a as jax_step_a, build_train_step_b as jax_step_b,
    init_state_a as jax_init_a, init_state_b as jax_init_b,
)
from repro.core.estimator import _unit_sq_norms as jax_unit_sq_norms
from repro.core.tiers import (
    class_tier_members as jax_members, combine_tiers as jax_combine_tiers,
    default_plan as jax_plan, ragged_synchronize as jax_ragged_sync,
    tier_subtrees as jax_tier_subtrees,
)
from repro.launch import serve as jserve, sharding as jsh, train as jtrain
from repro.models import layers as JL
from repro.models.model import SplittableModel as JaxModel
from repro.optim import sgd as jsgd
import repro_torch.configs as tconfigs
from repro_torch import api as T
from repro_torch.core import (
    TrainState, build_train_step_a, build_train_step_b, default_plan, init_state_b,
    replicate_for_clients,
)
from repro_torch.core.engine import engine_b_to_full
from repro_torch.core.estimator import _unit_sq_norms
from repro_torch.core.tiers import (
    class_tier_members, combine_tiers, ragged_synchronize, tier_subtrees,
)
from repro_torch.kernels.swa_attention import (
    swa_attention, swa_attention_ref, swa_decode, swa_decode_ref,
)
from repro_torch.launch import serve as tserve, sharding as tsh, train as ttrain
from repro_torch.models import SplittableModel, params_from_numpy, params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models.model import _unstack
from repro_torch.optim import sgd

ARCH = "whisper-large-v3"
CPU = torch.device("cpu")
ATTN_TOL = 2e-5
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
NORM_TOL = 1e-5
N, B, TEXT, STEPS = 4, 2, 12, 4  # the engines: clients, batch, text tokens, steps
LOSS_RTOL, LOSS_ATOL, ATOL, RTOL = 1e-5, 1e-6, 5e-6, 1e-4
# REDUCED whisper holds 2 encoder and 2 decoder units: (1, 2) cuts inside
# the encoder and at the enc/dec boundary, (2, 3) at the boundary and
# inside the decoder
CUTS = [(1, 2), (2, 3)]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, prefix + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, prefix + (str(i),)).items()}
    if isinstance(tree, torch.Tensor):
        return {"/".join(prefix): tree.detach().cpu().numpy()}
    return {"/".join(prefix): np.asarray(tree)}


def _norm_close(got, ref, tol, what):
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (what, err)


def _jspec():
    return jconfigs.get_reduced(ARCH)


def _tspec():
    return tconfigs.get_reduced(ARCH)


@functools.lru_cache(maxsize=None)
def _init():
    """One JAX init of REDUCED whisper (``PRNGKey(0)``), as NumPy arrays."""
    return params_to_numpy(JaxModel(_jspec()).init_params(jax.random.PRNGKey(0)))


def _perturbed(seed=0):
    """The JAX init with every leaf nudged, so zero-initialised norms take
    part in the comparison."""
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(x.dtype),
                        _init())


def _audio_batch(spec, lead, text, seed):
    """frames [*lead, encoder_len, d] normal; tokens and labels [*lead,
    text] in [0, V), the first two labels masked (-1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, spec.vocab_size, tuple(lead) + (text + 1,)).astype(np.int32)
    labels = toks[..., 1:].copy()
    labels[..., :2] = -1
    frames = rng.normal(size=tuple(lead) + (spec.encoder_len, spec.d_model)).astype(np.float32)
    return {"frames": frames, "tokens": toks[..., :-1], "labels": labels}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# spec, registry and parameters
# --------------------------------------------------------------------------- #


def test_spec_and_registry_match_jax():
    for variant in ("SPEC", "REDUCED"):
        t = getattr(tconfigs._mod(ARCH), variant)
        j = getattr(jconfigs._mod(ARCH), variant)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.hd, t.padded_vocab, t.n_units) == (j.hd, j.padded_vocab, j.n_units)
        assert t.total_param_count() == j.total_param_count()
        for u in (0, t.n_units - 1):
            assert t.unit_flops_fwd(u, 2, 448) == j.unit_flops_fwd(u, 2, 448)
    assert tconfigs.get_spec(ARCH).name == ARCH and tconfigs.get_reduced(ARCH).family == "audio"
    # every id of the zoo resolves (VGG-16 has its own model)
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert [tconfigs.get_reduced(a).name for a in tconfigs.ARCH_IDS] == tconfigs.ARCH_IDS
    spec = tconfigs.get_spec(ARCH)
    # the full-width shapes that PERF.md and the card's [audio] phase rely on
    assert (spec.hd, spec.num_heads, spec.num_kv_heads, spec.encoder_len) == (64, 20, 20, 1500)
    assert (spec.encoder_layers, spec.num_layers, spec.n_units, spec.padded_vocab) == (
        32, 32, 64, 51968)


def _shape_tree(tree):
    return {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in _flat(tree).items()}


def test_init_params_is_the_jax_tree():
    """REDUCED: every leaf path, shape and dtype, the cross blocks among them
    (``xattn`` without ``bq``/``bk``/``bv`` or ``q_norm``/``k_norm``), and the
    same at full depth and encoder length narrowed to d 64."""
    p = SplittableModel(_tspec()).init_params(torch.Generator().manual_seed(0), CPU)
    assert _shape_tree(p) == _shape_tree(_init())
    assert sorted(p["units"]) == ["dec", "enc"]
    assert sorted(p["units"]["dec"]["xattn"]) == ["norm", "wk", "wo", "wq", "wv"]
    d = _tspec().d_model
    assert p["frontend"]["enc_pos"].shape == (_tspec().encoder_len, d)
    narrow = dict(d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=512)
    js = dataclasses.replace(jconfigs.get_spec(ARCH), **narrow)
    ts = dataclasses.replace(tconfigs.get_spec(ARCH), **narrow)
    ref = jax.eval_shape(JaxModel(js).init_params, jax.random.PRNGKey(0))
    got = SplittableModel(ts).init_params(torch.Generator().manual_seed(0), CPU)
    shapes ={"/".join(str(getattr(k, "key", k)) for k in path): (tuple(s.shape), np.dtype(s.dtype))
              for path, s in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert _shape_tree(got) == shapes
    assert got["units"]["enc"]["attn"]["wq"].shape[0] == 32
    assert got["units"]["dec"]["xattn"]["wq"].shape[0] == 32


@pytest.mark.parametrize("extras", [dict(), dict(qkv_bias=True, qk_norm=True)],
                         ids=["plain", "bias-norm"])
def test_cross_attention_block_matches_jax(extras):
    """``init_attention(cross=True)``: the leaves JAX's has, for a spec with
    and without q/k/v biases and q/k norms (a cross block has neither)."""
    js = dataclasses.replace(_jspec(), **extras)
    ts = dataclasses.replace(_tspec(), **extras)
    for cross in (False, True):
        j = JL.init_attention(jax.random.PRNGKey(0), js, cross=cross)
        t = L.init_attention(torch.Generator().manual_seed(0), ts, cross=cross)
        assert _shape_tree(t) == _shape_tree(params_to_numpy(j))


# --------------------------------------------------------------------------- #
# the attention kernels' plain versions: Sq != Sk, and bidirectional
# --------------------------------------------------------------------------- #


def _grads_against_jax(q, k, v, do, jax_fn, window, prefix):
    """o and (dq, dk, dv) of ``swa_attention`` (through its autograd: the
    flash backward's plain versions) against ``jax_fn`` and ``jax.grad``."""
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo = jax_fn(jq, jk, jv)
    jg = jax.grad(lambda a, b, c: jnp.sum(jax_fn(a, b, c) * jdo), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to = swa_attention(tq, tk, tv, window, prefix)
    ro, lse = swa_attention_ref(tq.detach(), tk.detach(), tv.detach(), window, prefix)
    assert torch.equal(to.detach(), ro)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    tg = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=ATTN_TOL, atol=ATTN_TOL)
    for name, a, b, x in zip(("dq", "dk", "dv"), tg, jg, (q, k, v)):
        assert a.shape == x.shape, name
        _norm_close(a.numpy(), b, ATTN_TOL, name)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("Sq,Sk", [(12, 100), (100, 12), (33, 64), (1, 47)])
def test_cross_attention_plain_versions_match_jax(Sq, Sk, hd, G):
    """q [2, Sq, H, hd] against k, v [2, Sk, K, hd], unmasked (prefix Sk at
    window 0, and any prefix past Sk): JAX's ``_sdpa`` under a zero bias."""
    K = 2
    H = G * K
    rng = np.random.default_rng(Sq * Sk + hd + G)
    q, do = (rng.normal(size=(2, Sq, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(2, Sk, K, hd)).astype(np.float32) for _ in range(2))
    zero = jnp.zeros((Sq, Sk), jnp.float32)
    for prefix in (Sk, Sk + 5):
        _grads_against_jax(q, k, v, do, lambda a, b, c: JL._sdpa(a, b, c, zero), 0, prefix)


@pytest.mark.parametrize("window", [0, 300])
def test_bidirectional_plain_versions_match_jax_at_1500(window):
    """The encoder's self-attention at S = 1500 (a ragged last tile at every
    tile size), narrow heads with G = 1: a prefix of S against JAX's
    ``_sdpa(_mask_bias(causal=False, window))``."""
    S, H, hd = 1500, 2, 32
    rng = np.random.default_rng(window)
    q, k, v, do = (rng.normal(size=(1, S, H, hd)).astype(np.float32) for _ in range(4))
    pos = jnp.arange(S)
    bias = JL._mask_bias(pos, pos, False, window, 0)
    _grads_against_jax(q, k, v, do, lambda a, b, c: JL._sdpa(a, b, c, bias), window, S)


def test_decode_cross_route_plain_version_matches_jax():
    """One query against every slot of non-zero cross caches: B4d's plain
    version with every slot at position 0 (the route ``layers.attention``
    takes for a decode step) against JAX's ``_sdpa`` under a zero bias."""
    rng = np.random.default_rng(7)
    for Bd, C, K, G, hd in ((3, 1500, 4, 1, 32), (2, 40, 2, 3, 64)):
        q = rng.normal(size=(Bd, 1, K * G, hd)).astype(np.float32)
        k, v = (rng.normal(size=(Bd, C, K, hd)).astype(np.float32) for _ in range(2))
        ref = JL._sdpa(*map(jnp.asarray, (q, k, v)), jnp.zeros((1, C), jnp.float32))
        slots = torch.zeros((C,), dtype=torch.int32)
        for p in (0, 5):
            got = swa_decode(*map(torch.from_numpy, (q, k, v)), slots,
                             torch.tensor([p], dtype=torch.int32))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=ATTN_TOL, atol=ATTN_TOL)
            assert torch.equal(got, swa_decode_ref(*map(torch.from_numpy, (q, k, v)), slots,
                                                   torch.tensor([p], dtype=torch.int32)))


# --------------------------------------------------------------------------- #
# layers.attention
# --------------------------------------------------------------------------- #


def _unit(stack, i=0, p=None):
    p = _perturbed() if p is None else p
    return jax.tree.map(lambda a: a[i], p["units"][stack])


@pytest.mark.parametrize("qk_norm", [False, True])
def test_layers_attention_kv_override_matches_jax(qk_norm):
    """The cross branch: q alone projected (q-normed where the block has
    ``q_norm``), every key of k, v [B, Sk, K, hd] seen, the cache returned
    as it came; Sq = 24 against Sk = encoder_len = 16."""
    jspec, tspec = _jspec(), _tspec()
    px = _unit("dec")["xattn"]
    if qk_norm:
        jspec = dataclasses.replace(jspec, qk_norm=True)
        tspec = dataclasses.replace(tspec, qk_norm=True)
        px = dict(px, q_norm=np.random.default_rng(1).normal(size=(jspec.hd,)).astype(np.float32))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, jspec.d_model)).astype(np.float32)
    kv = [rng.normal(size=(2, jspec.encoder_len, jspec.num_kv_heads, jspec.hd)).astype(np.float32)
          for _ in range(2)]
    ja, jc = JL.attention(jax.tree.map(jnp.asarray, px), jnp.asarray(x), jspec,
                          kv_override=tuple(map(jnp.asarray, kv)), use_rope=False)
    sentinel = {"unchanged": torch.zeros(1)}
    ta, tc = L.attention(params_from_numpy(px, CPU), torch.from_numpy(x), tspec,
                         kv_override=tuple(map(torch.from_numpy, kv)), use_rope=False,
                         cache=sentinel)
    assert jc is None and tc is sentinel
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **MODEL_TOL)


@pytest.mark.parametrize("causal,use_rope", [(False, False), (False, True), (True, False)])
@pytest.mark.parametrize("window", [0, 6])
def test_layers_attention_bidirectional_and_unroped_match_jax(causal, use_rope, window):
    jspec, tspec = _jspec().with_window(window), _tspec().with_window(window)
    pa = _unit("enc")["attn"]
    x = np.random.default_rng(window + 3).normal(size=(2, 20, jspec.d_model)).astype(np.float32)
    ja, _ = JL.attention(jax.tree.map(jnp.asarray, pa), jnp.asarray(x), jspec,
                         causal=causal, use_rope=use_rope)
    ta, cache = L.attention(params_from_numpy(pa, CPU), torch.from_numpy(x), tspec,
                            causal=causal, use_rope=use_rope)
    assert cache is None
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **MODEL_TOL)


def test_decode_self_attention_stays_causal():
    spec = _tspec()
    attn = params_from_numpy(_unit("dec")["attn"], CPU)
    with pytest.raises(ValueError, match="causal"):
        L.attention(attn, torch.zeros(1, 1, spec.d_model), spec, causal=False,
                    cache=L.init_attn_cache(spec, 1, 8, CPU))


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


def test_forward_loss_and_grads_match_jax():
    """Logits, the loss and every gradient (``frontend/proj`` and
    ``enc_pos``, which reach the loss only through the cross-attention,
    among them)."""
    jspec, tspec = _jspec(), _tspec()
    jm, tm = JaxModel(jspec), SplittableModel(tspec)
    p = _perturbed()
    batch = _audio_batch(jspec, (2,), 20, seed=1)
    jp, jb = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, batch)
    jlogits, _ = jm.forward(jp, jb)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jp, jb)
    tp, tb = params_from_numpy(p, CPU), _to_torch(batch)
    tlogits, taux = tm.forward(tp, tb)
    assert tlogits.shape == (2, 20, jspec.padded_vocab)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), **MODEL_TOL)
    assert float(taux) == 0.0
    np.testing.assert_allclose(float(tm.loss_fn(tp, tb)), float(jloss), rtol=1e-5)
    leaves = list(_flat(tp).keys())
    live = [x.requires_grad_(True) for x in jax.tree.leaves(tp)]
    grads = torch.autograd.grad(tm.loss_fn(tp, tb), live)
    tg, jg = dict(zip(leaves, (g.numpy() for g in grads))), _flat(params_to_numpy(jgrads))
    assert tg.keys() == jg.keys()
    for k in jg:
        _norm_close(tg[k], jg[k], NORM_TOL, k)
    for k in ("frontend/proj", "frontend/enc_pos", "units/enc/attn/wq", "units/dec/xattn/wq"):
        assert float(np.abs(tg[k]).max()) > 0.0, k


@pytest.mark.parametrize("lo,hi", [(0, 1), (1, 3), (2, 4), (0, 4), (3, 3)])
def test_apply_units_ranges_match_jax(lo, hi):
    """Units [lo, hi) of the enc ++ dec layout on the full stacks: the
    encoder units on ``enc``, then the decoder units on the carry; the
    carry at a max-normalised 1e-5 (its residual stream grows to ~7 over
    four perturbed units)."""
    jspec, tspec = _jspec(), _tspec()
    p = _perturbed()
    batch = _audio_batch(jspec, (2,), 10, seed=2)
    jm, tm = JaxModel(jspec), SplittableModel(tspec)
    jc = jm.frontend_apply(jax.tree.map(jnp.asarray, p["frontend"]),
                           jax.tree.map(jnp.asarray, batch))
    jc = jm.apply_units(jax.tree.map(jnp.asarray, p["units"]), jc, lo, hi)
    tp = params_from_numpy(p, CPU)
    tc = tm.apply_units(tp["units"], tm.frontend_apply(tp["frontend"], _to_torch(batch)), lo, hi)
    for k in ("h", "enc"):
        _norm_close(tc[k].detach().numpy(), jc[k], NORM_TOL, k)


# --------------------------------------------------------------------------- #
# the engines
# --------------------------------------------------------------------------- #


class _Carried:
    def __init__(self, p0):
        self.p0 = p0

    def init_params(self, generator, device=None):
        return params_from_numpy(self.p0, device)


class _JaxSplitModel(SplittableModel):
    """The port's model with the JAX package's boundary rule: a slice of the
    two stacks is split at ``spec.encoder_layers``, whatever it holds."""

    def apply_units(self, units, carry, lo, hi, prefix_len=0):
        ne = self.spec.encoder_layers
        n_enc = units["enc"]["attn"]["wq"].shape[0]
        n_dec = units["dec"]["attn"]["wq"].shape[0]
        e_lo, e_hi = min(lo, ne), min(hi, ne, n_enc)
        d_lo, d_hi = max(lo, ne) - ne, min(max(hi, ne) - ne, n_dec)
        carry = dict(carry)
        for up in _unstack(units["enc"], e_lo, max(e_hi, e_lo)):
            carry["enc"] = self._apply_enc_unit(up, carry["enc"])
        for up in _unstack(units["dec"], d_lo, max(d_hi, d_lo)):
            carry = self._apply_dec_unit(up, carry)
        return carry


def _plans(cuts, n_units=4):
    kw = dict(cuts=cuts, intervals=(2, 2, 1), entities=(N, 2, 1))
    return jax_plan(n_units, N, **kw), default_plan(n_units, N, **kw)


@functools.lru_cache(maxsize=None)
def _runs(cuts):
    """(losses, params) after every step of JAX's Engine A and B and the
    port's A, B and B under JAX's boundary rule, sgd 1e-2, from one init."""
    jspec, tspec = _jspec(), _tspec()
    jp, tp = _plans(cuts)
    jm = JaxModel(jspec)
    batches = [_audio_batch(jspec, (N, B), TEXT, t) for t in range(STEPS)]
    out = {}
    for name, init, build in (("jax_a", jax_init_a, jax_step_a), ("jax_b", jax_init_b, jax_step_b)):
        state = init(jm, jp, jsgd(1e-2), jax.random.PRNGKey(0))
        step = jax.jit(build(jm, jp, jsgd(1e-2)))
        res = []
        for b in batches:
            state, loss = step(state, jax.tree.map(jnp.asarray, b))
            res.append((float(loss), params_to_numpy(state.params)))
        out[name] = res
    p0 = params_to_numpy(jm.init_params(jax.random.PRNGKey(0)))
    tm = SplittableModel(tspec)
    states = {
        "port_a": (TrainState(replicate_for_clients(params_from_numpy(p0, CPU), N), (), 0),
                   build_train_step_a(tm, tp, sgd(1e-2))),
        "port_b": (init_state_b(_Carried(p0), tp, sgd(1e-2), torch.Generator(), CPU),
                   build_train_step_b(tm, tp, sgd(1e-2))),
        "port_b_jax_rule": (init_state_b(_Carried(p0), tp, sgd(1e-2), torch.Generator(), CPU),
                            build_train_step_b(_JaxSplitModel(tspec), tp, sgd(1e-2))),
    }
    for name, (state, step) in states.items():
        res = []
        for b in batches:
            state, loss = step(state, _to_torch(b))
            res.append((float(loss), state.params))
        out[name] = res
    return out


def _steps_close(got, ref, to_numpy=params_to_numpy):
    for t, ((tl, tp), (jl, jp)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=f"step {t}")
        a, b = _flat(to_numpy(tp)), _flat(jp)
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=RTOL, err_msg=f"step {t} {k}")


def _b_full(run, cuts):
    _, tp = _plans(cuts)
    tm = SplittableModel(_tspec())
    return [(loss, params_to_numpy(engine_b_to_full(tm, tp, p))) for loss, p in run]


@pytest.mark.parametrize("cuts", CUTS, ids=lambda c: f"cuts{c[0]}{c[1]}")
def test_engine_a_matches_jax(cuts):
    """N = 4, J₂ = 2, batch 2, 12 tokens, 4 steps, sgd 1e-2: losses rtol
    1e-5, the client-stacked params atol 5e-6 / rtol 1e-4 after every step."""
    r = _runs(cuts)
    _steps_close(r["port_a"], r["jax_a"])


@pytest.mark.parametrize("cuts", CUTS, ids=lambda c: f"cuts{c[0]}{c[1]}")
def test_engine_b_matches_jax_engine_a(cuts):
    """The port's Engine B runs each tier's own units: its state, made
    client-stacked, follows JAX's Engine A step by step; the encoder's
    output crosses every cut, so the frontend's ``proj`` and ``enc_pos``
    on tier 1 learn through it."""
    r = _runs(cuts)
    _steps_close(_b_full(r["port_b"], cuts), r["jax_a"], to_numpy=lambda x: x)
    p0, p1 = _init()["frontend"], params_to_numpy(r["port_b"][0][1][0]["frontend"])
    for k in ("proj", "enc_pos"):
        assert float(np.abs(p1[k] - p0[k][None]).max()) > 0.0, k


@pytest.mark.parametrize("cuts", CUTS, ids=lambda c: f"cuts{c[0]}{c[1]}")
def test_engine_b_with_jax_s_boundary_matches_jax_engine_b(cuts):
    """JAX's Engine B splits each tier's slice at ``spec.encoder_layers``
    and so never runs the decoder units here (ROADMAP §C): its losses stand
    apart from its Engine A's.  The port's Engine B under the same rule
    equals it step by step, every tier's entity stacks."""
    r = _runs(cuts)
    assert abs(r["jax_b"][0][0] - r["jax_a"][0][0]) > 1e-4
    _steps_close(r["port_b_jax_rule"], r["jax_b"])


@pytest.mark.parametrize("cuts", CUTS, ids=lambda c: f"cuts{c[0]}{c[1]}")
def test_port_engine_a_equals_engine_b(cuts):
    r = _runs(cuts)
    _steps_close([(la, params_to_numpy(pa)) for la, pa in r["port_a"]],
                 _b_full(r["port_b"], cuts), to_numpy=lambda x: x)


@pytest.mark.parametrize("cuts", [(0, 0), (1, 2), (2, 2), (2, 3), (1, 4), (4, 4), (0, 3)])
def test_tier_subtrees_and_combine_round_trip_as_jax(cuts):
    """Each tier's slice of the enc ++ dec layout equals JAX's (empty stacks
    included), and ``combine_tiers`` gives the tree back bit for bit."""
    jp, tp = _plans(cuts)
    full = jax.tree.map(lambda x: np.stack([x, x + 1.0]), _init())
    jplan, tplan = (jax_plan(4, 2, cuts=cuts, intervals=(2, 2, 1), entities=(2, 1, 1)),
                    default_plan(4, 2, cuts=cuts, intervals=(2, 2, 1), entities=(2, 1, 1)))
    jparts = jax_tier_subtrees(jax.tree.map(jnp.asarray, full), jplan)
    tparts = tier_subtrees(params_from_numpy(full, CPU), tplan)
    for m, (a, b) in enumerate(zip(tparts, jparts)):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys(), m
        for k in fb:
            assert np.array_equal(fa[k], fb[k]), (m, k)
    back = _flat(combine_tiers(tparts, params_from_numpy(full, CPU)))
    ref = _flat(jax_combine_tiers(jparts, jax.tree.map(jnp.asarray, full)))
    assert back.keys() == ref.keys() == _flat(full).keys()
    for k in ref:
        assert np.array_equal(back[k], ref[k]) and np.array_equal(back[k], _flat(full)[k]), k


def test_estimator_unit_norms_match_jax():
    """[N, U] squared norms over enc ++ dec, the frontend folded into unit 0
    and the head into unit U − 1."""
    full = jax.tree.map(lambda x: np.stack([x, 2.0 * x, x - 0.5]), _perturbed())
    got = _unit_sq_norms(params_from_numpy(full, CPU), 4).numpy()
    ref = np.asarray(jax_unit_sq_norms(jax.tree.map(jnp.asarray, full), 4))
    assert got.shape == ref.shape == (3, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("tp", [2, 4])
def test_layout_rules_on_the_enc_dec_paths_equal_jax(tp):
    """``launch.sharding``'s rules for ``units/enc`` and ``units/dec`` (and
    ``frontend/enc_pos``), rule for rule: the parameters client-stacked and
    not, and the decode caches with their ``xk``/``xv``."""
    jm = JaxModel(_jspec())
    p = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    stacked = jax.tree.map(lambda s: jax.ShapeDtypeStruct((4,) + s.shape, s.dtype), p)

    def flat_specs(tree, leaf):
        flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(ps)
                for path, ps in flat}

    def port_specs(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in port_specs(sub, prefix + (str(key),)).items()}
        return {"/".join(prefix): tuple(tree)}

    jleaf = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for tree, ca in ((p, None), (stacked, ("data",))):
        got = port_specs(tsh.param_pspecs(tree, tp=tp, client_axes=ca))
        assert got == flat_specs(jsh.param_pspecs(tree, tp=tp, client_axes=ca), jleaf)
        assert any(k.startswith("units/enc/") for k in got)
        assert any(k.startswith("units/dec/xattn/") for k in got)
    caches = jax.eval_shape(lambda: jm.init_caches(8, 32))
    kw = dict(batch=8, client_axes=("data",))
    got = port_specs(tsh.cache_pspecs(caches, **kw))
    assert got == flat_specs(jsh.cache_pspecs(caches, **kw), jleaf)
    assert "xk" in got and "xv" in got


# --------------------------------------------------------------------------- #
# decoding
# --------------------------------------------------------------------------- #


def test_init_caches_match_jax():
    jm, tm = JaxModel(_jspec()), SplittableModel(_tspec())
    j, t = _flat(jm.init_caches(2, 16)), _flat(tm.init_caches(2, 16, CPU))
    assert sorted(t) == sorted(j) and {"xk", "xv"} <= set(t)
    for k in j:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("fill", ["zero", "filled"])
def test_decode_step_matches_jax(fill):
    """Six decode steps: the logits and every cache leaf after each step.
    ``zero``: the cross caches as ``init_caches`` makes them, which stay
    zero, as in JAX (nothing fills them from an encoder); ``filled``: both
    packages' cross caches set to the same non-zero values first."""
    jspec, tspec = _jspec(), _tspec()
    jm, tm = JaxModel(jspec), SplittableModel(tspec)
    p = _perturbed()
    tp = params_from_numpy(p, CPU)
    Bd, C, steps = 2, 8, 6
    toks = np.random.default_rng(4).integers(0, jspec.vocab_size, (Bd, steps)).astype(np.int32)
    jcache, tcache = jm.init_caches(Bd, C), tm.init_caches(Bd, C, CPU)
    if fill == "filled":
        rng = np.random.default_rng(5)
        for name in ("xk", "xv"):
            x = rng.normal(size=tuple(jcache[name].shape)).astype(np.float32)
            jcache[name] = jnp.asarray(x)
            tcache[name].copy_(torch.from_numpy(x))
    jp = jax.tree.map(jnp.asarray, p)
    step = jax.jit(jm.decode_step)
    for i in range(steps):
        jlog, jcache = step(jp, jnp.asarray(toks[:, i:i + 1]), jcache, jnp.int32(i))
        tlog, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]), tcache, i)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **MODEL_TOL,
                                   err_msg=f"step {i}")
        a, b = _flat(tcache), _flat(jcache)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_allclose(a[k], b[k], **MODEL_TOL, err_msg=f"step {i} {k}")
        if fill == "zero":
            assert not a["xk"].any() and not a["xv"].any()


# --------------------------------------------------------------------------- #
# the CLIs, the API and the ragged sync
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("cli", ["train", "serve"])
def test_clis_refuse_audio_with_jax_s_words(cli):
    j, t = {"train": (jtrain, ttrain), "serve": (jserve, tserve)}[cli]
    argv = ["--arch", ARCH]
    with pytest.raises(SystemExit) as jerr:
        j.main(argv)
    with pytest.raises(SystemExit) as terr:
        t.main(["--device", "cpu"] + argv)
    assert str(terr.value) == str(jerr.value)
    assert str(jerr.value).startswith(f"{ARCH}: ")


def test_api_run_on_audio_fails_on_the_missing_frames_in_both_packages(monkeypatch):
    """The capability check lets whisper through, as JAX's build does; then
    ``run`` trains on the LM stream, which carries no audio frames, and both
    packages fail on the missing ``frames`` before any step completes."""
    js = J.paper_spec().replace(
        model=J.ModelCfg(arch=ARCH, variant="reduced", batch=2, seq=8),
        system=J.SystemCfg(num_clients=4, num_edges=2),
        solver=J.SolverCfg(kind="fixed", cuts=(1, 2), intervals=(2, 2, 1)),
        run=J.RunCfg(mode="train", rounds=2, dataset_size=64, lr=0.1),
    )
    J.build(js)
    ts = T.ExperimentSpec.from_dict(json.loads(json.dumps(js.to_dict())))
    T.build(ts)
    steps = []
    run_mod = sys.modules["repro_torch.api.run"]
    built = run_mod.build_train_step_a

    def counting(*args, **kwargs):
        step = built(*args, **kwargs)

        def wrapped(state, batch):
            out = step(state, batch)
            steps.append(1)
            return out

        return wrapped

    monkeypatch.setattr(run_mod, "build_train_step_a", counting)
    with pytest.raises(KeyError, match="frames"):
        J.run(js)
    with pytest.raises(KeyError, match="frames"):
        T.run(ts, device="cpu")
    assert steps == []


def test_ragged_sync_refuses_enc_dec_stacks_as_jax():
    """The per-class (ragged) sync stays refused on the two stacks, in the
    JAX package's words."""
    full = jax.tree.map(lambda x: np.stack([x] * 4), _init())
    kw = dict(cuts=(1, 2), intervals=(2, 2, 1), entities=(4, 2, 1))
    jplan, tplan = jax_plan(4, 4, **kw), default_plan(4, 4, **kw)
    class_cuts, class_of = [(1, 2), (2, 3)], [0, 0, 1, 1]
    with pytest.raises(NotImplementedError) as jerr:
        jax_ragged_sync(jax.tree.map(jnp.asarray, full), jplan,
                        jax_members(4, class_cuts, class_of), 0)
    with pytest.raises(NotImplementedError) as terr:
        ragged_synchronize(params_from_numpy(full, CPU), tplan,
                           class_tier_members(4, class_cuts, class_of, CPU), 0)
    assert str(terr.value) == str(jerr.value)
