"""Decoding in the port against the JAX package (ROADMAP A14.3): the KV and
Mamba caches, ``decode_step``, ``mamba_block(cache=)``, decode attention's
plain version (B4d's, ``swa_decode_ref``) and the sliding-window ring.
Every init is drawn once in JAX and carried through NumPy; tokens are
NumPy's.  REDUCED sizes throughout.

Tolerances.  Dense archs: logits and caches at f32 tolerance, rtol 1e-5 /
atol 1e-5 (the transformer tests' model tolerance: the port's f32 sums
run in another order than XLA's).  MoE, SSM and hybrid archs: the layer tests'
max-normalised tolerance (max |port − JAX| ≤ tol · max |JAX|), 1e-5 for
the MoE family and 2e-5 where Mamba blocks are in the path; routing
near-ties (a token's k-th and (k+1)-th gates within 1e-6, where the two
packages' router products may pick different experts) would be excluded
as ``tests/test_torch_moe.py`` excludes them, and none occurs in these
cases (asserted).  Teacher-forced decode against the port's own forward:
max-normalised 1e-5 (2e-5 through Mamba blocks): the same model, the
products at other shapes.  Decode attention's plain version against JAX's
``_sdpa(_mask_bias(...))``: rtol = atol = 2e-5, the attention kernels'
ATTN_TOL.

The ring.  Under a window W the JAX package's cache has C = W slots but
wraps only when W < C, which never holds: past C its writes are dropped,
and from position 2W − 1 every slot is masked and its logits are NaN
(pinned below as a fact of the reference).  The port wraps (slot
idx % C): it equals JAX's decode while idx < C, and after that the
windowed forward, which is what JAX's decode path means to compute.
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as JL
from repro.models.model import SplittableModel as JaxModel
import repro_torch.configs as tconfigs
from repro_torch.kernels.swa_attention import swa_decode, swa_decode_ref
from repro_torch.models import SplittableModel, params_from_numpy, params_to_numpy
from repro_torch.models import layers as L

CPU = torch.device("cpu")
ARCHS = tconfigs.ARCH_IDS
DENSE_TOL = dict(rtol=1e-5, atol=1e-5)
MOE_TOL, MAMBA_TOL = 1e-5, 2e-5
TF_TOL = 1e-5  # teacher forcing, port against port (2e-5 through Mamba blocks)
ATTN_TOL = 2e-5
TIE_MARGIN = 1e-6
STEPS = 6


def _norm_tol(spec) -> float:
    return MAMBA_TOL if spec.family in ("ssm", "hybrid") else MOE_TOL


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (str(key),)).items()}
    if isinstance(tree, torch.Tensor):
        return {"/".join(prefix): tree.detach().cpu().numpy()}
    return {"/".join(prefix): np.asarray(tree)}


def _specs(arch, window=0, moe_no_drop=False):
    js, ts = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    if window:
        js, ts = js.with_window(window), ts.with_window(window)
    if moe_no_drop and ts.moe is not None:
        # capacity E / k: an expert's buffer holds every token, so neither
        # the decode batch nor the forward's tokens drop a (token, k) pair
        cf = ts.moe.num_experts / ts.moe.top_k
        js = dataclasses.replace(js, moe=dataclasses.replace(js.moe, capacity_factor=cf))
        ts = dataclasses.replace(ts, moe=dataclasses.replace(ts.moe, capacity_factor=cf))
    return js, ts


@functools.lru_cache(maxsize=None)
def _init(arch, seed=0):
    return params_to_numpy(JaxModel(jconfigs.get_reduced(arch)).init_params(
        jax.random.PRNGKey(seed)))


def _tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


class _Margins:
    """Records the smallest k-th/(k+1)-th gate margin of every ``moe_route``
    call the port makes."""

    def __init__(self, monkeypatch):
        self.smallest = np.inf
        route = L.moe_route

        def recording(params, xg, spec):
            probs, gates, ids = route(params, xg, spec)
            srt = torch.sort(probs, dim=-1, descending=True).values
            k = spec.moe.top_k
            self.smallest = min(self.smallest, float((srt[..., k - 1] - srt[..., k]).min()))
            return probs, gates, ids

        monkeypatch.setattr(L, "moe_route", recording)


# --------------------------------------------------------------------------- #
# caches
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("window", [0, 8], ids=["full", "window8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_jax(arch, window):
    """Leaf keys, shapes and dtypes of every unit's cache, stacked on axis
    0, equal JAX's; k, v and the Mamba states start at 0, positions at -1."""
    js, ts = _specs(arch, window)
    j = _flat(JaxModel(js).init_caches(2, 16))
    t = _flat(SplittableModel(ts).init_caches(2, 16, CPU))
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    if window and ts.family != "ssm":
        assert t["attn/k"].shape[2] == window  # C = min(cache_len, window)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, monkeypatch):
    """Six decode steps: the logits and every cache leaf after each step."""
    js, ts = _specs(arch)
    p = _init(arch)
    jm, tm = JaxModel(js), SplittableModel(ts)
    tp = params_from_numpy(p, CPU)
    B, C = 2, 8
    toks = _tokens(js.vocab_size, B, STEPS)
    jcache, tcache = jm.init_caches(B, C), tm.init_caches(B, C, CPU)
    step = jax.jit(jm.decode_step)
    margins = _Margins(monkeypatch)
    for i in range(STEPS):
        jl, jcache = step(p, jnp.asarray(toks[:, i : i + 1]), jcache, jnp.int32(i))
        tl, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, i : i + 1]), tcache, i)
        jl, jf, tf = np.asarray(jl), _flat(jcache), _flat(tcache)
        assert tl.shape == jl.shape == (B, js.padded_vocab)
        assert sorted(tf) == sorted(jf)
        if ts.family == "dense":
            np.testing.assert_allclose(tl.numpy(), jl, **DENSE_TOL, err_msg=f"step {i}")
        else:
            tol = _norm_tol(ts)
            err = np.abs(tl.numpy().astype(np.float64) - jl).max()
            assert err <= tol * np.abs(jl).max(), (i, err)
        for k in jf:
            if k.endswith(("positions", "index")):
                np.testing.assert_array_equal(tf[k], jf[k], err_msg=f"{k} step {i}")
            elif ts.family == "dense":
                np.testing.assert_allclose(tf[k], jf[k], **DENSE_TOL, err_msg=f"{k} step {i}")
            else:
                err = np.abs(tf[k].astype(np.float64) - jf[k]).max()
                assert err <= _norm_tol(ts) * max(np.abs(jf[k]).max(), 1e-30), (k, i, err)
    if ts.moe is not None:
        assert margins.smallest > TIE_MARGIN, margins.smallest  # no routing near-tie


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-1.5b", "mamba2-1.3b", "qwen3-32b",
                                  "granite-moe-1b-a400m", "jamba-1.5-large-398b"])
def test_teacher_forced_decode_matches_forward(arch, monkeypatch):
    """As ``tests/test_models_smoke.py::test_decode_matches_forward``, in the
    port: decoding a sequence token by token gives the forward's logits at
    every position.  The MoE archs run at capacity E / k, where neither path
    drops a token: at the default capacity the decode batch's B tokens and
    the forward's B·S compete for different capacities, in JAX as here."""
    _, ts = _specs(arch, moe_no_drop=True)
    tm = SplittableModel(ts)
    tp = params_from_numpy(_init(arch, seed=1), CPU)
    B, S = 2, 8
    toks = _tokens(ts.vocab_size, B, S, seed=1)
    margins = _Margins(monkeypatch)
    full, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    caches = tm.init_caches(B, S, CPU)
    tol = TF_TOL if ts.family in ("dense", "moe") else MAMBA_TOL
    V = ts.vocab_size
    for i in range(S):
        step, caches = tm.decode_step(tp, torch.from_numpy(toks[:, i : i + 1]), caches, i)
        ref = full[:, i, :V].numpy().astype(np.float64)
        err = np.abs(step[:, :V].numpy() - ref).max()
        assert err <= tol * np.abs(ref).max(), (i, err)
    if ts.moe is not None:
        assert margins.smallest > TIE_MARGIN, margins.smallest


# --------------------------------------------------------------------------- #
# decode attention (B4d's plain version) and the Mamba step
# --------------------------------------------------------------------------- #


def _cache_positions(kind, C, q_pos):
    if kind == "partly filled":  # slots 0..q_pos written, the rest -1
        return np.where(np.arange(C) <= q_pos, np.arange(C), -1)
    if kind == "wrapped":  # a ring of C slots after q_pos + 1 tokens
        pos = np.arange(q_pos + 1 - C, q_pos + 1)
        return np.roll(pos, (q_pos + 1) % C)
    if kind == "all masked":  # every slot outside the window
        return np.arange(C) + q_pos + 1
    raise ValueError(kind)


DECODE_CASES = [(g, hd, kind, w) for g in (1, 2, 3) for hd in (32, 64, 128)
                for kind, w in (("partly filled", 0), ("wrapped", 0), ("wrapped", 12),
                                ("partly filled", 5))]


@pytest.mark.parametrize("G,hd,kind,window", DECODE_CASES,
                         ids=[f"G{g}-hd{h}-{k.replace(' ', '-')}-w{w}"
                              for g, h, k, w in DECODE_CASES])
def test_decode_attention_plain_matches_jax(G, hd, kind, window):
    """``swa_decode_ref`` (and ``swa_decode`` on CPU tensors) against JAX's
    ``_sdpa(q, ck, cv, _mask_bias(positions, cache_pos, True, window, 0,
    k_valid))`` at one query position."""
    rng = np.random.default_rng(G * 1000 + hd)
    B, K, C, q_pos = 2, 2, 16, 20 if kind == "wrapped" else 9
    H = G * K
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    cpos = _cache_positions(kind, C, q_pos).astype(np.int32)
    qp = np.array([q_pos], np.int32)
    k_valid = jnp.broadcast_to(jnp.asarray(cpos >= 0)[None, :], (B, C))
    bias = JL._mask_bias(jnp.asarray(qp), jnp.asarray(cpos), True, window, 0, k_valid)
    ref = np.asarray(JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias))
    args = [torch.from_numpy(a) for a in (q, k, v, cpos, qp)]
    for got in (swa_decode_ref(*args, window), swa_decode(*args, window)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_decode_attention_all_masked_row_is_nan_as_in_jax():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((1, 1, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)))
    cpos = _cache_positions("all masked", 8, 3).astype(np.int32)
    qp = np.array([3], np.int32)
    bias = JL._mask_bias(jnp.asarray(qp), jnp.asarray(cpos), True, 0, 0,
                         jnp.ones((1, 8), bool))
    ref = np.asarray(JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias))
    got = swa_decode(*(torch.from_numpy(a) for a in (q, k, v, cpos, qp)))
    assert np.isnan(ref).all() and torch.isnan(got).all()


def test_decode_attention_refuses_a_grad_and_more_than_one_query():
    q = torch.zeros(1, 1, 2, 32, requires_grad=True)
    k = torch.zeros(1, 4, 1, 32)
    pos, qp = torch.arange(4, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="no backward"):
        swa_decode(q, k, k, pos, qp)
    with pytest.raises(ValueError, match=r"\[B, 1, H, hd\]"):
        swa_decode(torch.zeros(1, 2, 2, 32), k, k, pos, qp)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_mamba_block_cache_step_matches_jax(arch):
    """One ``mamba_block(cache=)`` step from a non-zero cache: the output,
    the new conv window and the new f32 state."""
    js, ts = _specs(arch)
    p = params_to_numpy(JL.init_mamba(jax.random.PRNGKey(3), js))
    rng = np.random.default_rng(3)
    p = {k: (v + 0.05 * rng.normal(size=v.shape)).astype(v.dtype) for k, v in p.items()}
    shapes = {k: v.shape for k, v in params_to_numpy(JL.init_mamba_cache(js, 2)).items()}
    cache = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    x = rng.normal(size=(2, 1, js.d_model)).astype(np.float32)
    jy, jc = JL.mamba_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), js,
                            cache=jax.tree.map(jnp.asarray, cache))
    ty, tc = L.mamba_block(params_from_numpy(p, CPU), torch.from_numpy(x), ts,
                           cache=params_from_numpy(cache, CPU))
    for name, got, ref in (("y", ty, jy), ("conv", tc["conv"], jc["conv"]),
                           ("state", tc["state"], jc["state"])):
        ref = np.asarray(ref, np.float64)
        assert got.dtype == torch.float32
        err = np.abs(got.numpy() - ref).max()
        assert err <= MAMBA_TOL * np.abs(ref).max(), (name, err)


# --------------------------------------------------------------------------- #
# the sliding-window ring and a full cache
# --------------------------------------------------------------------------- #

W = 8


def _ring_run(steps):
    """REDUCED qwen2.5-14b under a window of 8 with a 64-long cache (C = 8,
    the reference's own ring test): JAX's and the port's logits by step."""
    js, ts = _specs("qwen2.5-14b", window=W)
    p = _init("qwen2.5-14b")
    jm, tm = JaxModel(js), SplittableModel(ts)
    tp = params_from_numpy(p, CPU)
    toks = _tokens(js.vocab_size, 1, steps, seed=5)
    jcache, tcache = jm.init_caches(1, 64), tm.init_caches(1, 64, CPU)
    assert tcache["attn"]["k"].shape[2] == W
    step = jax.jit(jm.decode_step)
    jl, tl = [], []
    for i in range(steps):
        a, jcache = step(p, jnp.asarray(toks[:, i : i + 1]), jcache, jnp.int32(i))
        b, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, i : i + 1]), tcache, i)
        jl.append(np.asarray(a)[:, : js.vocab_size])
        tl.append(b[:, : ts.vocab_size].numpy())
    return js, ts, p, toks, np.stack(jl, 1), np.stack(tl, 1)


def test_ring_equals_jax_until_full_then_the_windowed_forward():
    """Port == JAX while idx < C; over 3·W steps the port equals the windowed
    forward (the port's and JAX's) and stays finite."""
    steps = 3 * W
    js, ts, p, toks, jl, tl = _ring_run(steps)
    np.testing.assert_allclose(tl[:, :W], jl[:, :W], **DENSE_TOL)
    assert np.isfinite(tl).all()
    tfull, _ = SplittableModel(ts).forward(params_from_numpy(p, CPU),
                                           {"tokens": torch.from_numpy(toks)})
    jfull, _ = JaxModel(js).forward(p, {"tokens": jnp.asarray(toks)})
    for ref in (tfull[..., : ts.vocab_size].numpy(), np.asarray(jfull)[..., : js.vocab_size]):
        err = np.abs(tl - ref).max()
        assert err <= TF_TOL * np.abs(ref).max(), err


def test_jax_ring_stops_writing_and_goes_nan_at_two_windows_less_one():
    """A fact of the reference (``src/repro/models/layers.py:283``): its
    windowed decode never wraps, so from position 2·W − 1 = 15 every slot
    lies outside the window and the logits are NaN; the port's are finite."""
    _, _, _, _, jl, tl = _ring_run(2 * W)
    assert np.isfinite(jl[:, : 2 * W - 1]).all()
    assert np.isnan(jl[:, 2 * W - 1]).all()
    assert np.isfinite(tl).all()


def test_a_full_cache_without_a_window_raises():
    _, ts = _specs("smollm-135m")
    tm = SplittableModel(ts)
    tp = params_from_numpy(_init("smollm-135m"), CPU)
    caches = tm.init_caches(1, 4, CPU)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    for i in range(4):
        tm.decode_step(tp, tok, caches, i)
    with pytest.raises(ValueError, match="KV cache of length 4"):
        tm.decode_step(tp, tok, caches, 4)
    # a windowed cache shorter than its window cannot hold the window either
    _, tw = _specs("smollm-135m", window=16)
    wm = SplittableModel(tw)
    caches = wm.init_caches(1, 4, CPU)
    for i in range(4):
        wm.decode_step(tp, tok, caches, i)
    with pytest.raises(ValueError, match="shorter than the window 16"):
        wm.decode_step(tp, tok, caches, 4)
