"""The port's flash attention (B4 forward, B5 backward) on the CPU, where the
wrappers run their plain versions, against the JAX package's Pallas kernel
(interpret mode) and its oracle, on the same numpy inputs.  The autograd
Functions that carry the kernels on the card run here too, under
``vmap(grad_and_value)`` as Engine A calls them."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.kernels.swa_attention import (
    swa_attention as jax_swa, swa_attention_ref as jax_swa_ref,
)
from repro_torch.kernels.swa_attention import (
    launches, reset_launches, swa_attention, swa_attention_bwd, swa_attention_bwd_ref,
    swa_attention_fwd, swa_attention_ref,
)

# B, S, H, K, hd, window: the JAX package's own cases
CASES = [
    (1, 256, 4, 2, 64, 128),
    (2, 384, 4, 4, 128, 256),
    (1, 512, 8, 2, 80, 0),
    (1, 300, 4, 1, 64, 128),
    (1, 256, 6, 3, 96, 128),
    (1, 640, 4, 2, 64, 512),
]


def _qkv(case, seed, dtype=np.float32):
    B, S, H, K, hd, _ = case
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(dtype),
            rng.normal(size=(B, S, K, hd)).astype(dtype),
            rng.normal(size=(B, S, K, hd)).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_plain_forward_matches_jax_kernel(case):
    W = case[-1]
    q, k, v = _qkv(case, sum(case))
    ref = np.asarray(jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=W))
    out, lse = swa_attention_fwd(*_t(q, k, v), W)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    B, S, H = q.shape[:3]
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32


@pytest.mark.parametrize("case", CASES[:4], ids=[str(c) for c in CASES[:4]])
def test_plain_backward_matches_jax_grad(case):
    """Autograd through the port's Function (whose backward is B5's plain
    version here) against jax.grad of the JAX oracle, max-normalised."""
    W = case[-1]
    q, k, v = _qkv(case, sum(case) + 1)
    dd = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(jax_swa_ref(*a, W) * dd), (0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [x.requires_grad_() for x in _t(q, k, v)]
    (swa_attention(*ts, W) * torch.from_numpy(dd)).sum().backward()
    for t, r in zip(ts, ref):
        r = np.asarray(r)
        scale = np.max(np.abs(r)) + 1e-9
        np.testing.assert_allclose(t.grad.numpy() / scale, r / scale, atol=2e-5)


@pytest.mark.parametrize("window", [0, 32])
def test_vmap_grad_and_value_through_the_functions(window):
    """Engine A's transform: the vmap rules fold the client axis into B."""
    N = 3
    case = (N * 2, 80, 6, 2, 32, window)
    q, k, v = (torch.from_numpy(a).reshape(N, 2, *a.shape[1:]) for a in _qkv(case, 5))
    dd = torch.from_numpy(np.random.default_rng(6).normal(size=q.shape).astype(np.float32))

    def f(q, k, v, dd):
        return (swa_attention(q, k, v, window) * dd).sum()

    def f_plain(q, k, v, dd):
        return (swa_attention_ref(q, k, v, window)[0] * dd).sum()

    g, val = vmap(grad_and_value(f, argnums=(0, 1, 2)))(q, k, v, dd)
    g_ref, val_ref = vmap(grad_and_value(f_plain, argnums=(0, 1, 2)))(q, k, v, dd)
    torch.testing.assert_close(val, val_ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(g, g_ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_window_at_least_s_equals_full_causal():
    case = (1, 256, 4, 2, 64, 0)
    q, k, v = _t(*_qkv(case, 8))
    full, lse0 = swa_attention_fwd(q, k, v, 0)
    for W in (256, 512):
        out, lse = swa_attention_fwd(q, k, v, W)
        torch.testing.assert_close(out, full, rtol=1e-6, atol=0)
        torch.testing.assert_close(lse, lse0, rtol=1e-6, atol=0)


def test_plain_bfloat16_forward():
    case = (1, 256, 4, 2, 64, 128)
    q, k, v = _qkv(case, 7)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    out, lse = swa_attention_fwd(tq, tk, tv, 128)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = swa_attention_ref(tq.float(), tk.float(), tv.float(), 128)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)


def test_plain_backward_formula_matches_autograd():
    """``swa_attention_bwd_ref`` (the kernel's formula: delta, p from lse,
    GQA group sums) against autograd through the plain forward."""
    case = (2, 130, 6, 2, 32, 64)
    q, k, v = (x.double().requires_grad_() for x in _t(*_qkv(case, 11)))
    do = torch.from_numpy(np.random.default_rng(12).normal(size=q.shape))
    o, lse = swa_attention_ref(q, k, v, 64)
    (o * do).sum().backward()
    dq, dk, dv = swa_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                                       lse, do, 64)
    for a, t in zip((dq, dk, dv), (q, k, v)):
        torch.testing.assert_close(a.double(), t.grad, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_launch_nothing_and_bad_shapes_raise():
    reset_launches()
    q, k, v = _t(*_qkv((1, 64, 4, 2, 32, 0), 3))
    o, lse = swa_attention_fwd(q, k, v, 0)
    swa_attention_bwd(q, k, v, o, lse, torch.ones_like(q), 0)
    assert launches == {"swa_attention_fwd": 0, "swa_attention_bwd_dq": 0,
                        "swa_attention_bwd_dkv": 0}
    with pytest.raises(ValueError, match="divisible"):
        swa_attention_fwd(q[:, :, :3], k, v, 0)
    with pytest.raises(ValueError, match=r"\[B, S, H, hd\]"):
        swa_attention_fwd(q[0], k, v, 0)
