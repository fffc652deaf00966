"""Head dim 128 on the CPU, against the JAX package: the training path that
the card runs at qwen2-1.5b's and qwen3-32b's head dim.

Every REDUCED config of the repo runs attention at hd 32 or 64, so these
take qwen2-1.5b's and qwen3-32b's REDUCED specs with ``head_dim=128``
(``dataclasses.replace``, on the port's side and on JAX's alike) and hold:

* Engine B step by step against JAX's Engine B, from one JAX init carried
  through NumPy, on the same NumPy batches, at JAX's own A == B tolerance
  (``tests/test_engines_equal.py``: losses rtol 1e-5, params atol 5e-6 /
  rtol 1e-4), plain and under participation masks;
* qwen3-32b's ``qk_norm`` (the q and k norms over hd before rope) and
  qwen2-1.5b's QKV bias: the model's logits at 1e-5 and its gradients at
  1e-5 of each leaf's largest, causal and under a window;
* the dk/dv pass's split count at hd 128 (64-key kv tiles over 32-row q
  tiles) and its record on ``meta`` tensors with the workspace's bytes.

The port's attention runs its flash-attention Functions, whose plain
versions take CPU tensors; the card's hd-128 kernels' arithmetic is held
apart, in ``tests/test_torch_swa_tf32.py`` (``wg_backward``).
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.configs import get_reduced as jax_reduced
from repro.core import build_train_step_b as jax_step_b, init_state_b as jax_init_b
from repro.core.tiers import default_plan as jax_plan
from repro.models.model import SplittableModel as JaxModel
from repro.optim import sgd as jsgd
from repro_torch.configs import get_reduced
from repro_torch.core import build_train_step_b, default_plan, init_state_b
from repro_torch.kernels import meta
from repro_torch.kernels.swa_attention import ops
from repro_torch.launch import dryrun_lib as D
from repro_torch.models import SplittableModel, params_from_numpy, params_to_numpy
from repro_torch.optim import sgd

CPU = torch.device("cpu")
HD = 128
N, B, S, STEPS = 4, 2, 40, 3
# JAX's own A == B tolerance (tests/test_engines_equal.py)
LOSS_RTOL, LOSS_ATOL, ATOL, RTOL = 1e-5, 1e-6, 5e-6, 1e-4
MODEL_TOL = 1e-5


def _specs(arch, window=0):
    """(JAX's, the port's) REDUCED spec of ``arch`` at head dim 128."""
    return tuple(dataclasses.replace(f(arch), head_dim=HD).with_window(window)
                 for f in (jax_reduced, get_reduced))


class _Carried:
    """A model whose ``init_params`` returns one fixed (JAX-drawn) tree."""

    def __init__(self, p0):
        self.p0 = p0

    def init_params(self, generator, device=None):
        return params_from_numpy(self.p0, device)


def _batches(vocab, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (N, B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def _masks(seed=0):
    """~60% participation a step, an entity silent in step 1."""
    rng = np.random.default_rng(seed)
    masks = rng.random((STEPS, N)) < 0.6
    masks[1, :N // 2] = False
    masks[:, N - 1] = True
    return masks.astype(np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("arch,cuts", [("qwen2-1.5b", (1, 2)), ("qwen2-1.5b", (1, 1)),
                                       ("qwen3-32b", (1, 2))])
def test_engine_b_at_hd_128_matches_jax_step_by_step(arch, cuts, masked):
    jspec, tspec = _specs(arch)
    assert jspec.hd == tspec.hd == HD
    kw = dict(cuts=cuts, intervals=(2, 2, 1), entities=(N, 2, 1))
    jp, tp = jax_plan(jspec.n_units, N, **kw), default_plan(tspec.n_units, N, **kw)
    jm, tm = JaxModel(jspec), SplittableModel(tspec)
    p0 = params_to_numpy(jm.init_params(jax.random.PRNGKey(0)))
    batches, masks = _batches(jspec.vocab_size), _masks() if masked else None

    jstate = jax_init_b(jm, jp, jsgd(1e-2), jax.random.PRNGKey(0))
    jstep = jax.jit(jax_step_b(jm, jp, jsgd(1e-2), with_mask=masked))
    tstate = init_state_b(_Carried(p0), tp, sgd(1e-2), torch.Generator(), CPU)
    tstep = build_train_step_b(tm, tp, sgd(1e-2), with_mask=masked)
    for t, batch in enumerate(batches):
        jargs = (jnp.asarray(masks[t]),) if masked else ()
        targs = (torch.from_numpy(masks[t]),) if masked else ()
        jstate, jloss = jstep(jstate, jax.tree.map(jnp.asarray, batch), *jargs)
        tstate, tloss = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, *targs)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=f"step {t}")
        a = jax.tree.leaves(params_to_numpy(tstate.params))
        b = jax.tree.leaves(params_to_numpy(jstate.params))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, np.asarray(y), atol=ATOL, rtol=RTOL,
                                       err_msg=f"step {t}")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, prefix + (str(key),)).items()}
    if isinstance(tree, torch.Tensor):
        return {"/".join(prefix): tree.detach().numpy()}
    return {"/".join(prefix): np.asarray(tree)}


@pytest.mark.parametrize("arch,window,seq", [("qwen3-32b", 0, 96), ("qwen3-32b", 48, 96),
                                             ("qwen3-32b", 0, 33), ("qwen2-1.5b", 0, 96)])
def test_qk_norm_and_qkv_bias_at_hd_128_logits_and_grads_match_jax(arch, window, seq):
    """qwen3-32b's q and k norms over hd 128 (and qwen2-1.5b's QKV bias):
    logits within 1e-5, the loss, and every gradient leaf within 1e-5 of
    its largest value, from the JAX init with every leaf nudged (so the
    norms' weights and the biases take part)."""
    jspec, tspec = _specs(arch, window)
    assert jspec.qk_norm == (arch == "qwen3-32b") and jspec.qkv_bias == (arch == "qwen2-1.5b")
    jm, tm = JaxModel(jspec), SplittableModel(tspec)
    rng = np.random.default_rng(seq + window)
    p = jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(x.dtype),
                     params_to_numpy(jm.init_params(jax.random.PRNGKey(1))))
    toks = rng.integers(0, jspec.vocab_size, (2, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    jb, jpar = (jax.tree.map(jnp.asarray, x) for x in (batch, p))
    jlogits, _ = jm.forward(jpar, jb)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jpar, jb)
    tp = params_from_numpy(p, CPU)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits, _ = tm.forward(tp, tb)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    np.testing.assert_allclose(float(tm.loss_fn(tp, tb)), float(jloss), rtol=MODEL_TOL)
    tg, jg = _flat(grad(tm.loss_fn)(tp, tb)), _flat(params_to_numpy(jgrads))
    assert tg.keys() == jg.keys()
    for k in jg:
        scale = float(np.abs(jg[k]).max()) or 1.0
        err = float(np.abs(tg[k] - jg[k]).max()) / scale
        assert err <= MODEL_TOL, f"{k}: {err:.3e}"


def test_dkv_splits_at_hd_128_walk_64_key_tiles():
    """The dk/dv pass at hd 128 walks 64-key kv tiles over 32-row q tiles
    (``ops.DKV_TILES``): at qwen2-1.5b's Engine-B shape [4, 1024, 12, 2]
    causal, kv tile j sees 6 x (32 - 2j) iterations, and its 128 blocks
    leave 4 of an H100's 132 SMs idle, so ``dkv_splits`` cuts each tile in
    2 (the card's sweep read 2 fastest of 1-6, PERF.md §6)."""
    assert ops.DKV_TILES[HD] == (64, 32)
    its = ops.dkv_tile_iterations(1024, 1024, 6, 0, 0, HD)
    assert its == [6 * (32 - 2 * j) for j in range(16)]
    assert ops.dkv_splits(4, 1024, 1024, 2, 6, HD, 0, 0, 132) == 2
    # a prefix of every key: every kv tile sees every q tile
    assert ops.dkv_tile_iterations(300, 300, 2, 0, 300, HD) == [2 * 10] * 5


def test_meta_dkv_at_hd_128_records_its_splits_and_workspace():
    """On ``meta`` tensors at qwen2-1.5b's Engine-B shape: one recorded call
    with ``dkv_splits``' count at the dry-run's 132 SMs, and the workspace
    (written by the splits, read by the merge) in ``kernel_work``'s bytes
    and in the tally's temporaries beside dk and dv."""
    B, S, H, K = 4, 1024, 12, 2

    def m(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    q, do, k, v = m(B, S, H, HD), m(B, S, H, HD), m(B, S, K, HD), m(B, S, K, HD)
    lse, delta = m(B, H, S), m(B, H, S)
    splits = ops.dkv_splits(B, S, S, K, H // K, HD, 0, 0, ops.DRYRUN_NUM_SMS)
    assert splits == 2
    seen = []
    with meta.recording(lambda name, shape: seen.append((name, shape))):
        ops.swa_attention_bwd_dkv(q, k, v, lse, delta, do, 0, 0)
    assert [(name, rec["splits"]) for name, rec in seen] == [("swa_attention_bwd_dkv", splits)]
    assert not any(ops.launches.values())
    ws_bytes = 4 * splits * 2 * B * S * K * HD
    _, plain_bytes = D.pairs_work(B, S, S, H, K, HD, D.attention_pairs(S, S, 0, 0))[
        "swa_attention_bwd_dkv"]
    assert D.kernel_work("swa_attention_bwd_dkv", seen[0][1])["bytes"] == plain_bytes + 2 * ws_bytes
    _, got = D.count_step(lambda: ops.swa_attention_bwd_dkv(q, k, v, lse, delta, do, 0, 0))
    assert got["temp_bytes"] == 2 * B * S * K * HD * 4 + ws_bytes
