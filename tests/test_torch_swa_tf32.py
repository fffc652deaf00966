"""3xTF32, the arithmetic of the attention kernels on the tensor cores,
emulated on the CPU and held to the f32 tolerances of the JAX package's tests.

The card's forward (B4) and its dq and dk/dv passes (B5) at hd 80-256
(``csrc/swa_attention.cu`` on ``csrc/mma_tf32.cuh``) split every f32
operand x of a product into big = tf32(x) and small = tf32(x - big),
rounded to nearest with ties away (``cvt.rna.tf32.f32``), and take a.b as
a_small.b_big + a_big.b_small + a_big.b_big.  Here every product of the
forward (s = (scale q).k^T and o += p.v, an online softmax over 32-key kv
tiles, each tile's p.v added to o in f32) and of the backward
(s, dp = do.v^T, dq = scale ds.k, dk = ds^T.(scale q), dv = p^T.do) goes
through the same split, on the same numpy inputs as the plain versions in
``ref.py``, at the JAX package's backward cases (``tests/test_kernels_swa.py``)
at hd 64 and 128 with windows 0 and 128, and with the VLM's prefix-LM mask
(P) and at hd 256.  The forward's emulation
follows the kernel's log2 units (log2(e) folded into q's scale, p = 2^(s - m),
lse = ln(2) m + ln(l)).  3xTF32 holds the tolerances (forward: rtol = atol =
2e-5; backward: ATTN_TOL = 2e-5 of max|ref|); one TF32 product (a_big.b_big
alone) does not.  This file's cases measured, with the products emulated as
above, against the plain f32 versions:

    case (B, S, H, K, hd, window)   forward: worst |err| / (2e-5 + 2e-5 |ref|), (o, lse)
                                    1xTF32          3xTF32
    (1, 256, 4, 2, 64, 128)         (31.8, 27.8)    (0.030, 0.011)
    (2, 384, 4, 4, 128, 256)        (42.3, 25.8)    (0.048, 0.015)
    (1, 512, 8, 2, 80, 0)           (62.5, 21.8)    (0.058, 0.015)
    (1, 300, 4, 1, 64, 128)         (27.7, 8.9)     (0.033, 0.008)
    (1, 256, 6, 3, 96, 128)         (34.4, 15.3)    (0.036, 0.014)
    (1, 640, 4, 2, 64, 512)         (30.4, 12.6)    (0.042, 0.014)
    (1, 256, 4, 2, 64, 0)           (43.5, 16.1)    (0.028, 0.009)
    (1, 256, 4, 2, 128, 0)          (31.9, 21.5)    (0.040, 0.008)
    (1, 256, 4, 2, 128, 128)        (38.5, 8.3)     (0.047, 0.010)
    (1, 300, 4, 1, 64, 64), P 100   (20.9, 2.8)     (0.035, 0.008)
    (1, 256, 8, 1, 256, 0), P 128   (17.1, 1.6)     (0.061, 0.008)
    (1, 130, 4, 2, 256, 48), P 70   (25.3, 2.2)     (0.060, 0.009)
    (1, 160, 4, 2, 32, 0), P 33     (28.0, 4.6)     (0.029, 0.009)
    (1, 256, 4, 1, 256, 0)          (34.5, 23.7)    (0.076, 0.026)

    case (B, S, H, K, hd, window)   backward: max|err| / max|ref|, (dq, dk, dv)
                                    1xTF32                  3xTF32
    (1, 256, 4, 2, 64, 128)         (8.3, 8.4, 4.6)e-4      (5.9, 8.3, 5.0)e-7
    (2, 384, 4, 4, 128, 256)        (10.2, 6.9, 5.1)e-4     (9.2, 9.5, 12.3)e-7
    (1, 512, 8, 2, 80, 0)           (8.7, 5.8, 3.6)e-4      (13.1, 7.9, 7.1)e-7
    (1, 300, 4, 1, 64, 128)         (6.7, 7.3, 3.3)e-4      (5.5, 4.8, 7.7)e-7
    (1, 256, 6, 3, 96, 128)         (6.9, 5.9, 6.6)e-4      (11.6, 9.5, 5.3)e-7
    (1, 640, 4, 2, 64, 512)         (7.2, 8.6, 4.5)e-4      (8.6, 8.2, 14.5)e-7
    (1, 256, 4, 2, 64, 0)           (6.7, 7.0, 4.1)e-4      (12.3, 14.7, 11.8)e-7
    (1, 256, 4, 2, 128, 0)          (7.7, 6.6, 3.7)e-4      (8.6, 10.1, 8.8)e-7
    (1, 256, 4, 2, 128, 128)        (7.1, 6.1, 2.8)e-4      (13.9, 10.1, 6.3)e-7
    (1, 300, 4, 1, 64, 64), P 100   (8.0, 7.7, 6.4)e-4      (14.8, 17.4, 5.6)e-7
    (1, 256, 8, 1, 256, 0), P 128   (6.5, 4.9, 4.4)e-4      (26.1, 12.8, 10.4)e-7
    (1, 130, 4, 2, 256, 48), P 70   (6.9, 10.1, 4.9)e-4     (18.8, 19.2, 14.4)e-7
    (1, 160, 4, 2, 32, 0), P 33     (11.6, 6.5, 4.5)e-4     (5.8, 9.3, 7.9)e-7
    (1, 256, 4, 1, 256, 0)          (8.7, 7.6, 6.7)e-4      (10.6, 12.1, 9.7)e-7

The 3xTF32 columns are the size of the f32 differences between two orders
of summation; 1xTF32 is 8-63x outside the forward's tolerance and 14-58x
outside the backward's.  The emulation sums each product's terms in f32 in
einsum's order; the tensor cores add with truncation instead, which the
kernels keep from drifting by summing each tile's partial product from 0
and adding it to the running sums in f32 (checked on the card by
``tests/test_torch_cuda.py``).

At head dim <= 64 both B5 passes run on wgmma (``swa_bwd_dq_wg_kernel``,
``swa_bwd_dkv_wg_kernel``, ``csrc/wgmma_tf32.cuh``), whose arithmetic is
emulated apart (``wg_backward``): the tensor cores read an f32 word as TF32
by dropping its 13 low bits, so big = trunc(x) and small = trunc(x -
trunc(x)) (no rounding to nearest); every product runs in k-steps of 8,
each k-step's three terms in the order small.big, big.small, big.big into
one f32 sum; the scale multiplies s and dq, dk after the products (q is
not scaled first); dq sums each 32-key kv tile's product from 0 and adds it
in f32, dk and dv each (query head, 32-row q tile) in the kernels' order.
Held at ATTN_TOL of max|ref| against the plain versions and ``jax.grad`` of
the JAX package's attention, at hd 64 and 32, G 1 and 3, ragged lengths,
windows, a prefix and Sq != Sk.  At head dim 128 both passes run the "half"
kernels (``swa_bwd_dq_wg_half_kernel``, ``swa_bwd_dkv_wg_half_kernel``):
two warpgroups on one 64-row q tile or 64-key kv tile, each over half of
hd, so every score product (s, dp, s^T, dp^T) is summed k-step by k-step
over each half's 64 columns apart and the two partial sums added in f32;
the dk/dv pass cuts each 64-key kv tile's (query head, 32-row q tile)
iterations into ``dkv_splits`` ranges, each summed from 0 and scaled (dk),
the ranges added in split order.  ``wg_backward`` emulates that at qwen2's
G 6 and at G 1 and 4, causal, windowed, with a prefix at a tile edge and
one past it, under a window, and with Sq != Sk, in the split counts an
H100's 132 SMs give.

The forward at head dim <= 64 runs on wgmma too (``swa_fwd_wg_kernel``),
emulated apart (``wg_forward``): s = q.k^T through the same truncated parts
and k-steps, then times the scale with log2(e) folded in (the kernel does
not scale q first); an online softmax over 32-key kv tiles in log2 units;
each tile's p.v summed from 0 and added to o, rescaled, in f32.  Held at
rtol = atol 2e-5 against the plain version and the JAX package's forward
(its Pallas ``_fwd`` in interpret mode, or ``_sdpa`` under ``_mask_bias``
where ``_fwd`` does not take the case), at the JAX forward cases at hd 64,
hd 32, windows, prefixes, the encoder's and the cross-attention's masks
and Sq != Sk; big.big alone misses it more than 5x.  At head dim 256
(``swa_fwd_wg_wide_kernel``) each of the kernel's two consumer warpgroups
sums s over its half of hd (128 columns, 16 k-steps) and the two partial
sums are added in f32, so ``wg_forward`` sums them so, at paligemma-3b's
prefix-LM mask, causal, windowed, with Sq != Sk and ragged lengths: under
truncation s now reduces over 256 columns, and the order holds the same
tolerance.
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention.ref import swa_attention_ref as jax_swa_ref
from repro.models import layers as JL
from repro_torch.kernels import build
from repro_torch.kernels.swa_attention import ops
from repro_torch.kernels.swa_attention import (
    swa_attention_bwd_dkv_ref, swa_attention_bwd_dq_ref, swa_attention_ref,
)
from repro_torch.kernels.swa_attention.ref import visible

ATTN_TOL = 2e-5  # tests/test_kernels_swa.py: the backward, after max-normalising
FWD_TOL = 2e-5  # tests/test_kernels_swa.py: the forward, rtol = atol
# B, S, H, K, hd, window: the JAX package's cases, then hd 64 / 128 at windows 0 / 128
CASES = [
    (1, 256, 4, 2, 64, 128),
    (2, 384, 4, 4, 128, 256),
    (1, 512, 8, 2, 80, 0),
    (1, 300, 4, 1, 64, 128),
    (1, 256, 6, 3, 96, 128),
    (1, 640, 4, 2, 64, 512),
    (1, 256, 4, 2, 64, 0),
    (1, 256, 4, 2, 128, 0),
    (1, 256, 4, 2, 128, 128),
]
# B, S, H, K, hd, window, prefix: the VLM's prefix-LM mask (under a window,
# at a ragged S, past a tile edge) and hd 256, whose kernels split the
# output's columns over warps (B4, dq) or blocks (dk/dv): each column's sum
# runs in the same order as below hd 256, so the emulation is the same
CASES += [
    (1, 300, 4, 1, 64, 64, 100),
    (1, 256, 8, 1, 256, 0, 128),
    (1, 130, 4, 2, 256, 48, 70),
    (1, 160, 4, 2, 32, 0, 33),
    (1, 256, 4, 1, 256, 0, 0),
]
IDS = [str(c) for c in CASES]


def mask_of(case):
    """(window, prefix) of a case."""
    return case[5], (case[6] if len(case) > 6 else 0)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the int32 view: 10 mantissa bits, nearest,
    ties away from zero (half the dropped unit added to the magnitude, then
    the 13 low bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """einsum(eq, a, b) with a and b rounded to TF32 (terms 1) or split into
    TF32 big and small parts (terms 3, the small products first)."""
    a_big, b_big = tf32(a), tf32(b)
    out = torch.einsum(eq, a_big, b_big)
    if terms == 3:
        a_small, b_small = tf32(a - a_big), tf32(b - b_big)
        out = (torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small)) + out
    return out


def tf32_backward(q, k, v, o, lse, do, window, terms, prefix=0):
    """(dq, dk, dv) as the kernels compute them, with every product through
    ``product``: the scale folded into q, delta = rowsum(o·do), p from lse."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = (q * scale).reshape(B, S, K, G, hd)
    dog = do.reshape(B, S, K, G, hd)
    pos = torch.arange(S)
    ok = visible(pos, pos, True, window, prefix)
    s = product("bqkgh,bskh->bkgqs", qg, k, terms)
    p = torch.where(ok, torch.exp(s - lse.reshape(B, K, G, S, 1)), 0.0)
    dp = product("bqkgh,bskh->bkgqs", dog, v, terms)
    delta = (o * do).sum(-1).permute(0, 2, 1)
    ds = p * (dp - delta.reshape(B, K, G, S, 1))
    dq = product("bkgqs,bskh->bqkgh", ds, k, terms).reshape(B, S, H, hd) * scale
    dk = product("bkgqs,bqkgh->bskh", ds, qg, terms)
    dv = product("bkgqs,bqkgh->bskh", p, dog, terms)
    return dq, dk, dv


def tf32_forward(q, k, v, window, terms, tile=32, prefix=0):
    """(o, lse) as the forward kernel computes them: the scores in log2
    units, s = (scale log2(e) q).k^T through ``product``; an online softmax
    over ``tile``-key kv tiles, p = 2^(s - m); each tile's p.v through
    ``product`` on its own, added to o in f32; lse = ln(2) m + ln(l)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qscale = torch.tensor(1.0 / math.sqrt(hd)) * torch.tensor(math.log2(math.e))  # f32
    qg = (q * qscale).reshape(B, S, K, G, hd)
    s_all = product("bqkgh,bskh->bkgqs", qg, k, terms)  # each score is its own dot product
    pos = torch.arange(S)
    m = torch.full((B, K, G, S), -1e30)
    l = torch.zeros(B, K, G, S)
    o = torch.zeros(B, K, G, S, hd)
    for j0 in range(0, S, tile):
        ok = visible(pos, pos[j0:j0 + tile], True, window, prefix)
        s = torch.where(ok, s_all[..., j0:j0 + tile], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, torch.exp2(s - m_new[..., None]), 0.0)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + product("bkgqs,bskh->bkgqh", p, v[:, j0:j0 + tile], terms)
        m = m_new
    o = (o / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return o, (math.log(2.0) * m + torch.log(l)).reshape(B, H, S)


def inputs(case):
    """q, k, v, do from numpy, seeded by the case."""
    B, S, H, K, hd = case[:5]
    rng = np.random.default_rng(sum(case))
    q, do = (torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, K, hd)).astype(np.float32))
            for _ in range(2))
    return q, k, v, do


def forward_errors(case, terms):
    """Worst |err| / (FWD_TOL + FWD_TOL |ref|) of (o, lse) against the plain
    f32 version: at most 1 within the forward's tolerance."""
    q, k, v, _ = inputs(case)
    W, P = mask_of(case)
    ref = swa_attention_ref(q, k, v, W, P)
    got = tf32_forward(q, k, v, W, terms, prefix=P)
    return [float(((a - r).abs() / (FWD_TOL + FWD_TOL * r.abs())).max())
            for a, r in zip(got, ref)]


def errors(case, terms):
    """max|err| / max|ref| of (dq, dk, dv) against the plain f32 versions."""
    W, P = mask_of(case)
    q, k, v, do = inputs(case)
    o, lse = swa_attention_ref(q, k, v, W, P)
    rdq, delta = swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W, P)
    rdk, rdv = swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W, P)
    got = tf32_backward(q, k, v, o, lse, do, W, terms, prefix=P)
    return [float((a - r).abs().max() / r.abs().max()) for a, r in zip(got, (rdq, rdk, rdv))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_backward_holds_the_f32_tolerance(case):
    errs = errors(case, 3)
    assert max(errs) <= ATTN_TOL, errs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_tf32_product_misses_the_f32_tolerance(case):
    """Why the kernels pay three products: one rounds each operand to 11
    significant bits, more than 5x (14-51x) outside the tolerance."""
    errs = errors(case, 1)
    assert min(errs) > 5 * ATTN_TOL, errs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_forward_holds_the_f32_tolerance(case):
    errs = forward_errors(case, 3)
    assert max(errs) <= 1.0, errs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_tf32_product_forward_misses_the_f32_tolerance(case):
    """The forward's o with one TF32 product is more than 5x outside its
    tolerance (rtol = atol = 2e-5)."""
    o_err, _ = forward_errors(case, 1)
    assert o_err > 5.0, o_err


def test_tf32_rounds_to_nearest_with_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # of TF32 at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 0.0, -0.0, 2.0 ** -126], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0, -0.0, 2.0 ** -126],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    big = tf32(y)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((y - big).abs() <= big.abs() * 2.0 ** -11).all())
    small = tf32(y - big)
    # big + small carries ~22 significant bits
    assert bool(((y.double() - big.double() - small.double()).abs()
                 <= y.abs().double() * 2.0 ** -21).all())


def test_library_is_rebuilt_when_a_header_changes(tmp_path):
    """``csrc/*.cuh`` headers are part of a library's key, beside the .cu."""
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    first = build.library_path(src)
    header.write_text("// two\n")
    assert build.library_path(src) != first
    assert build.build_log(src) == build.library_path(src).with_suffix(".log")


# --------------------------------------------------------------------------
# B5 on wgmma (head dim <= 64)
# --------------------------------------------------------------------------
WG_TILE = 32  # keys a kv tile of the dq pass, rows a q tile of the dk/dv pass
# B, Sq, Sk, H, K, hd, window, prefix: G 3 causal at a ragged S; G 1 under a
# window at hd 32; a prefix under a window; the bidirectional encoder (a
# prefix of S); cross-attention (Sq < Sk, a prefix of Sk); Sq > Sk causal
WG_CASES = [
    (1, 300, 300, 3, 1, 64, 0, 0),
    (1, 200, 200, 3, 3, 32, 64, 0),
    (1, 300, 300, 3, 1, 64, 64, 100),
    (2, 150, 150, 2, 2, 64, 0, 150),
    (1, 130, 300, 2, 2, 64, 0, 300),
    (1, 300, 130, 6, 2, 32, 0, 0),
]
# hd 128 (the half kernels): qwen2-1.5b's G 6 causal at a ragged S, G 1
# windowed, G 4 with a prefix at a 64-key tile's edge and one past it, a
# prefix under a window, the encoder's prefix of S, Sq < Sk under a prefix
# of Sk, Sq > Sk causal
WG_CASES += [
    (1, 200, 200, 6, 1, 128, 0, 0),
    (1, 230, 230, 2, 2, 128, 100, 0),
    (1, 160, 160, 8, 2, 128, 0, 64),
    (1, 160, 160, 8, 2, 128, 0, 65),
    (1, 200, 200, 4, 1, 128, 64, 100),
    (1, 130, 130, 4, 4, 128, 0, 130),
    (1, 100, 230, 6, 1, 128, 0, 230),
    (1, 230, 100, 6, 2, 128, 0, 0),
]
WG_IDS = [str(c) for c in WG_CASES]


def trunc(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read an f32 word as TF32: the 13 low bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def wg_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, N] = a [..., M, K] . b [..., N, K]^T as wgmma's 3xTF32 takes
    it: k-steps of 8 in order, each adding small.big, big.small, big.big
    (small = trunc(x - trunc(x))) to one f32 sum."""
    a_big, b_big = trunc(a), trunc(b)
    a_small, b_small = trunc(a - a_big), trunc(b - b_big)
    out = None
    for k0 in range(0, a.shape[-1], 8):
        sl = slice(k0, k0 + 8)
        for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
            step = torch.einsum("...mk,...nk->...mn", x[..., sl], y[..., sl])
            out = step if out is None else out + step
    return out


WG_HALVES = {128: 2}  # hd -> the column parts of the score products added in f32
H100_SMS = 132  # the SMs that dkv_splits plans for


def wg_scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A score product a.b^T as the kernels sum it: wg_dot over each part of
    hd's columns (WG_HALVES), the parts' sums added in f32 in column order."""
    hd = a.shape[-1]
    w = hd // WG_HALVES.get(hd, 1)
    out = wg_dot(a[..., :w], b[..., :w])
    for c in range(w, hd, w):
        out = out + wg_dot(a[..., c:c + w], b[..., c:c + w])
    return out


def wg_backward(q, k, v, o, lse, do, window, prefix):
    """(dq, dk, dv) as swa_bwd_dq_wg_kernel and swa_bwd_dkv_wg_kernel (at hd
    128 swa_bwd_dq_wg_half_kernel and swa_bwd_dkv_wg_half_kernel) compute
    them (``window`` and ``prefix`` as the kernels take them)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    ok = visible(torch.arange(Sq), torch.arange(Sk), True, window, prefix)  # [Sq, Sk]
    qg = q.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4)  # [B, K, G, Sq, hd]
    dog = do.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4)
    kg, vg = (x.permute(0, 2, 1, 3)[:, :, None] for x in (k, v))  # [B, K, 1, Sk, hd]
    lse_g = lse.reshape(B, K, G, Sq)
    delta = (o * do).sum(-1).permute(0, 2, 1).reshape(B, K, G, Sq)

    # the dq pass: rows x keys; each kv tile's ds.k from 0, added in f32
    s = scale * wg_scores(qg, kg)
    p = torch.where(ok, torch.exp(s - lse_g[..., None]), 0.0)
    ds = p * (wg_scores(dog, vg) - delta[..., None])
    kt = kg.transpose(-1, -2)  # [B, K, 1, hd, Sk]
    dq = torch.zeros(B, K, G, Sq, hd)
    for j0 in range(0, Sk, WG_TILE):
        dq = dq + wg_dot(ds[..., j0:j0 + WG_TILE], kt[..., j0:j0 + WG_TILE])
    dq = (scale * dq).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)

    # the dk/dv pass: keys x rows; each (query head, q tile)'s product from
    # 0, added in f32, heads outer, q tiles inner
    st = scale * wg_scores(kg, qg)  # [B, K, G, Sk, Sq]
    pt = torch.where(ok.T, torch.exp(st - lse_g[..., None, :]), 0.0)
    dst = pt * (wg_scores(vg, dog) - delta[..., None, :])
    qt, dot = qg.transpose(-1, -2), dog.transpose(-1, -2)  # [B, K, G, hd, Sq]
    if hd != ops.HALF_HEAD_DIM:
        dk = dv = torch.zeros(B, K, Sk, hd)
        for g in range(G):
            for i0 in range(0, Sq, WG_TILE):
                rows = slice(i0, i0 + WG_TILE)
                dv = dv + wg_dot(pt[:, :, g, :, rows], dot[:, :, g, :, rows])
                dk = dk + wg_dot(dst[:, :, g, :, rows], qt[:, :, g, :, rows])
        dk, dv = (x.permute(0, 2, 1, 3) for x in (scale * dk, dv))
        return dq, dk, dv
    # hd 128: each kv tile's iterations (the q tiles that see its keys) cut
    # into the splits' ranges, each summed from 0 (dk then scaled), the
    # ranges added in split order (the merge)
    keys, rows = ops.DKV_TILES[hd]
    splits = ops.dkv_splits(B, Sq, Sk, K, G, hd, window, prefix, H100_SMS)
    dk, dv = torch.zeros(B, K, Sk, hd), torch.zeros(B, K, Sk, hd)
    nq = -(-Sq // rows)
    for k0 in range(0, Sk, keys):
        kt = slice(k0, k0 + keys)
        i_lo = 0 if k0 < prefix else k0 // rows
        i_hi = nq - 1 if window == 0 else min(nq - 1, (k0 + keys - 1 + window - 1) // rows)
        its = [(g, i) for g in range(G) for i in range(i_lo, i_hi + 1)]
        for z in range(splits):
            part_k = part_v = torch.zeros(B, K, min(k0 + keys, Sk) - k0, hd)
            for g, i in its[z * len(its) // splits:(z + 1) * len(its) // splits]:
                r = slice(i * rows, (i + 1) * rows)
                part_v = part_v + wg_dot(pt[:, :, g, kt, r], dot[:, :, g, :, r])
                part_k = part_k + wg_dot(dst[:, :, g, kt, r], qt[:, :, g, :, r])
            dk[:, :, kt] = dk[:, :, kt] + scale * part_k
            dv[:, :, kt] = dv[:, :, kt] + part_v
    return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def wg_inputs(case):
    B, Sq, Sk, H, K, hd = case[:6]
    rng = np.random.default_rng(sum(case))
    q, do = (rng.normal(size=(B, Sq, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, Sk, K, hd)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def wg_errors(case):
    """The emulated wgmma passes' (dq, dk, dv) against the plain versions and
    against jax.grad of the JAX package's attention: max|err| / max|ref|."""
    B, Sq, Sk, H, K, hd, W, P = case
    q, k, v, do = wg_inputs(case)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = swa_attention_ref(tq, tk, tv, W, P)
    got = wg_backward(tq, tk, tv, o, lse, tdo, W, P)
    rdq, delta = swa_attention_bwd_dq_ref(tq, tk, tv, o, lse, tdo, W, P)
    plain = (rdq,) + tuple(swa_attention_bwd_dkv_ref(tq, tk, tv, lse, delta, tdo, W, P))

    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    if P or Sq != Sk:
        bias = JL._mask_bias(jnp.arange(Sq), jnp.arange(Sk), True, W, P)

        def attn(a, b, c):
            return JL._sdpa(a, b, c, bias)
    else:
        def attn(a, b, c):
            return jax_swa_ref(a, b, c, W)
    jax_grads = jax.grad(lambda a, b, c: jnp.sum(attn(a, b, c) * jdo), argnums=(0, 1, 2))(
        jq, jk, jv)

    def err(a, r):
        r = np.asarray(r, np.float64)
        return float(np.abs(a.double().numpy() - r).max() / np.abs(r).max())
    return ([err(a, r) for a, r in zip(got, plain)], [err(a, r) for a, r in zip(got, jax_grads)])


@pytest.mark.parametrize("case", WG_CASES, ids=WG_IDS)
def test_wgmma_backward_emulated_holds_the_f32_tolerance(case):
    """dq, dk, dv through truncated TF32 parts, k-step by k-step, within
    ATTN_TOL of max|ref| of the plain versions and of jax.grad."""
    to_plain, to_jax = wg_errors(case)
    assert max(to_plain) <= ATTN_TOL, to_plain
    assert max(to_jax) <= ATTN_TOL, to_jax


@pytest.mark.parametrize("case", WG_CASES[:3], ids=WG_IDS[:3])
def test_wgmma_backward_with_one_product_misses_the_f32_tolerance(case):
    """The small terms are what holds it: big.big alone (one truncated TF32
    product a k-step) is more than 5x outside ATTN_TOL."""
    B, Sq, Sk, H, K, hd, W, P = case
    q, k, v, do = map(torch.from_numpy, wg_inputs(case))
    o, lse = swa_attention_ref(q, k, v, W, P)
    global wg_dot
    three = wg_dot
    try:
        wg_dot = lambda a, b: torch.einsum("...mk,...nk->...mn", trunc(a), trunc(b))  # noqa: E731
        got = wg_backward(q, k, v, o, lse, do, W, P)
    finally:
        wg_dot = three
    rdq, delta = swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W, P)
    ref = (rdq,) + tuple(swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W, P))
    errs = [float((a - r).abs().max() / r.abs().max()) for a, r in zip(got, ref)]
    assert min(errs) > 5 * ATTN_TOL, errs


def test_trunc_drops_the_low_bits_and_small_carries_the_rest():
    """trunc(x) keeps TF32's 10 mantissa bits toward zero; x - trunc(x) is
    exact in f32, and its own trunc leaves ~2^-20 of |x|."""
    y = torch.from_numpy(np.random.default_rng(1).normal(size=1000).astype(np.float32))
    big = trunc(y)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool((big.abs() <= y.abs()).all())
    assert bool(((y - big).abs() < big.abs() * 2.0 ** -9).all())
    small = trunc(y - big)
    assert bool(((y.double() - big.double() - small.double()).abs()
                 <= y.abs().double() * 2.0 ** -19).all())


# --------------------------------------------------------------------------
# B4 on wgmma (head dim <= 64)
# --------------------------------------------------------------------------
WG_FWD_TILE = 32  # keys a kv tile of swa_fwd_wg_kernel and swa_fwd_wg_wide_kernel
WG_FWD_HALVES = {256: 2}  # hd -> the column parts of s that the kernel adds in f32
# B, Sq, Sk, H, K, hd, window, prefix: the JAX package's forward cases at hd
# 64 and causal hd 64 / 32 (Sq = Sk, no prefix: against its Pallas _fwd);
# hd 32 under a window of 64 (which _fwd does not take); the prefix cases;
# the bidirectional encoder (a prefix of S); cross-attention (Sq < Sk, a
# prefix of Sk); Sq > Sk causal; then hd 256 (the wide kernel): paligemma's
# prefix-LM mask at a small size, causal at a ragged S (against Pallas _fwd),
# windowed, Sq < Sk under a prefix of Sk, and Sq > Sk causal
WG_FWD_CASES = [
    (1, 256, 256, 4, 2, 64, 128, 0),
    (1, 300, 300, 4, 1, 64, 128, 0),
    (1, 640, 640, 4, 2, 64, 512, 0),
    (1, 256, 256, 4, 2, 64, 0, 0),
    (1, 160, 160, 4, 2, 32, 0, 0),
    (1, 200, 200, 3, 3, 32, 64, 0),
    (1, 300, 300, 4, 1, 64, 64, 100),
    (1, 160, 160, 4, 2, 32, 0, 33),
    (2, 150, 150, 2, 2, 64, 0, 150),
    (1, 130, 300, 2, 2, 64, 0, 300),
    (1, 300, 130, 6, 2, 32, 0, 0),
    (1, 160, 160, 8, 1, 256, 0, 64),
    (1, 200, 200, 4, 1, 256, 0, 0),
    (1, 200, 200, 4, 2, 256, 48, 0),
    (1, 100, 260, 4, 1, 256, 0, 260),
    (1, 260, 100, 6, 2, 256, 0, 0),
]
WG_FWD_IDS = [str(c) for c in WG_FWD_CASES]


def one_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """wg_dot with big.big alone: one truncated TF32 product a k-step."""
    return torch.einsum("...mk,...nk->...mn", trunc(a), trunc(b))


def wg_forward(q, k, v, window, prefix, dot=None):
    """(o, lse) as swa_fwd_wg_kernel (and at hd 256 swa_fwd_wg_wide_kernel)
    computes them: s = q.k^T through ``dot`` (wg_dot: truncated TF32 parts,
    k-steps of 8, small.big, big.small, big.big), at hd 256 over each half
    of the columns apart, the halves added in f32, then times the scale with
    log2(e) folded in (f32); an online softmax over WG_FWD_TILE-key kv tiles
    in log2 units, p = 2^(s - m); each tile's p.v through ``dot`` from 0,
    added to o (rescaled first) in f32; lse = ln(2) m + ln(l)."""
    dot = wg_dot if dot is None else dot
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qscale = torch.tensor(1.0 / math.sqrt(hd)) * torch.tensor(math.log2(math.e))  # f32
    ok = visible(torch.arange(Sq), torch.arange(Sk), True, window, prefix)  # [Sq, Sk]
    qg = q.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4)  # [B, K, G, Sq, hd]
    kg, vg = (x.permute(0, 2, 1, 3)[:, :, None] for x in (k, v))  # [B, K, 1, Sk, hd]
    parts = [slice(c, c + hd // WG_FWD_HALVES.get(hd, 1))
             for c in range(0, hd, hd // WG_FWD_HALVES.get(hd, 1))]
    s_all = dot(qg[..., parts[0]], kg[..., parts[0]])  # [B, K, G, Sq, Sk]
    for c in parts[1:]:
        s_all = s_all + dot(qg[..., c], kg[..., c])
    s_all = qscale * s_all
    vt = vg.transpose(-1, -2)  # [B, K, 1, hd, Sk]
    m = torch.full((B, K, G, Sq), -1e30)
    l = torch.zeros(B, K, G, Sq)
    o = torch.zeros(B, K, G, Sq, hd)
    for j0 in range(0, Sk, WG_FWD_TILE):
        keys = slice(j0, j0 + WG_FWD_TILE)
        s = torch.where(ok[:, keys], s_all[..., keys], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok[:, keys], torch.exp2(s - m_new[..., None]), 0.0)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + dot(p, vt[..., keys])
        m = m_new
    lr = l.clamp(min=1e-30)
    o = (o / lr[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return o, (math.log(2.0) * m + torch.log(lr)).reshape(B, H, Sq)


def jax_forward(q, k, v, window, prefix):
    """(o, lse) of the JAX package: its Pallas _fwd (interpret mode, as
    tests/test_kernels_swa.py runs it) where it takes the case (Sq = Sk, no
    prefix, a window of whole 128-row tiles), else o of _sdpa under
    _mask_bias (the jnp attention it runs for the prefix and for
    cross-attention) and no lse."""
    from repro.kernels.swa_attention.ops import T, _swa_fwd_res

    Sq, Sk = q.shape[1], k.shape[1]
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if prefix or Sq != Sk or window % T:
        bias = JL._mask_bias(jnp.arange(Sq), jnp.arange(Sk), True, window, prefix)
        return np.asarray(JL._sdpa(jq, jk, jv, bias)), None
    o, res = _swa_fwd_res(jq, jk, jv, window, True)
    return np.asarray(o), np.asarray(res[4])[:, :, :Sq]


@pytest.mark.parametrize("case", WG_FWD_CASES, ids=WG_FWD_IDS)
def test_wgmma_forward_emulated_holds_the_f32_tolerance(case):
    """o and lse through truncated TF32 parts, the scale after s and each
    kv tile's p.v from 0, within rtol = atol 2e-5 of the plain version and
    of the JAX package's forward."""
    B, Sq, Sk, H, K, hd, W, P = case
    q, k, v, _ = wg_inputs(case)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = wg_forward(tq, tk, tv, W, P)
    ro, rlse = swa_attention_ref(tq, tk, tv, W, P)
    torch.testing.assert_close(o, ro, rtol=FWD_TOL, atol=FWD_TOL)
    torch.testing.assert_close(lse, rlse, rtol=FWD_TOL, atol=FWD_TOL)
    jo, jlse = jax_forward(q, k, v, W, P)
    np.testing.assert_allclose(o.numpy(), jo, rtol=FWD_TOL, atol=FWD_TOL)
    if jlse is not None:
        np.testing.assert_allclose(lse.numpy(), jlse, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("case", WG_FWD_CASES[:2] + WG_FWD_CASES[6:8] + WG_FWD_CASES[9:10]
                         + WG_FWD_CASES[11:12],
                         ids=WG_FWD_IDS[:2] + WG_FWD_IDS[6:8] + WG_FWD_IDS[9:10]
                         + WG_FWD_IDS[11:12])
def test_wgmma_forward_with_one_product_misses_the_f32_tolerance(case):
    """The small terms are what holds it: big.big alone in s and p.v puts o
    more than 5x outside its tolerance (rtol = atol 2e-5)."""
    B, Sq, Sk, H, K, hd, W, P = case
    q, k, v = map(torch.from_numpy, wg_inputs(case)[:3])
    o, _ = wg_forward(q, k, v, W, P, dot=one_product)
    ro, _ = swa_attention_ref(q, k, v, W, P)
    err = float(((o - ro).abs() / (FWD_TOL + FWD_TOL * ro.abs())).max())
    assert err > 5.0, err
