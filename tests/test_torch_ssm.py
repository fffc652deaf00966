"""Mamba2 in the port against the JAX package: ``ssd_scan`` (the chunked
SSD dual form, with and without the padding branch ``S % chunk != 0`` and a
non-zero ``init_state``) and ``mamba_block`` at mamba2-1.3b's and
jamba-1.5-large's REDUCED shapes, from JAX-drawn weights carried through
NumPy and NumPy inputs: outputs, final states and gradients; the block
under ``torch.func.vmap``; the pairwise contractions' largest intermediate;
the decode cache's refusal; mamba2's gradient growing with depth as
JAX's.

Tolerances.  Outputs are f32 sums over d_inner (256) of a scan whose
states reach tens; either package lands ~1e-5 from a float64 evaluation,
so values near zero differ by more than an elementwise atol of 1e-6.  Each
output is held at a max-normalised 1e-5 (max |port − JAX| ≤ 1e-5 ·
max |JAX|) and the port's distance from the float64 evaluation to at most
twice JAX's.  The whole block's output is held at 2e-5: each package lands
up to 6.5e-6 (normalised) from the float64 block at mamba2's widths
(port 3.42e-5, JAX 3.03e-5 of 5.23), so the two can differ by 1.03e-5."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from repro.configs import get_reduced as jax_reduced, get_spec as jax_spec
from repro.models import layers as JL
from repro.models.model import SplittableModel as JaxModel
from repro.models.spec import SsmSpec as JaxSsmSpec
from repro_torch.configs import get_reduced, get_spec
from repro_torch.models import SplittableModel, params_from_numpy, params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models.spec import SsmSpec

CPU = torch.device("cpu")
NORM_TOL = 1e-5
BLOCK_TOL = 2e-5


def _assert_norm_close(got, ref, what, tol=NORM_TOL):
    ref = np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    assert err <= tol * scale, f"{what}: max |port - JAX| {err:.3g} > {tol} x {scale:.3g}"


def _assert_f64_no_worse(got, ref, f64, what):
    """The port is no further from the float64 evaluation than JAX, twice over."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    e_port, e_jax = np.abs(got - f64).max(), np.abs(ref - f64).max()
    assert e_port <= 2 * e_jax + 1e-7 * np.abs(f64).max(), (what, e_port, e_jax)


def _scan_inputs(S, with_state, seed=0, B=2, H=4, P=8, N=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    A = (-np.abs(rng.normal(size=(B, S, H))) * 0.3).astype(np.float32)  # dt·A < 0
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    st = rng.normal(size=(B, H, P, N)).astype(np.float32) if with_state else None
    return x, A, Bm, Cm, st


SCAN_CASES = [(S, chunk, st) for S, chunk in ((64, 16), (50, 16), (40, 64), (16, 16))
              for st in (False, True)]


@pytest.mark.parametrize("S,chunk,with_state", SCAN_CASES)
def test_ssd_scan_matches_jax(S, chunk, with_state):
    """y and the final state, S a multiple of the chunk or padded (50 and 40
    run the padding branch; 40 < 64 is one padded chunk), from zero or a
    given initial state; also the gradients of Σ r·y + Σ q·state."""
    x, A, Bm, Cm, st = _scan_inputs(S, with_state, seed=S + chunk)
    jargs = [jnp.asarray(a) for a in (x, A, Bm, Cm)]
    jst = None if st is None else jnp.asarray(st)
    jy, jf = JL.ssd_scan(*jargs, chunk, jst)
    targs = [torch.from_numpy(a) for a in (x, A, Bm, Cm)]
    tst = None if st is None else torch.from_numpy(st)
    ty, tf = L.ssd_scan(*targs, chunk, tst)
    assert ty.shape == (x.shape[0], S) + x.shape[2:] and tf.shape == (2, 4, 8, 16)
    _assert_norm_close(ty.numpy(), jy, "y")
    _assert_norm_close(tf.numpy(), jf, "final state")
    y64, f64 = L.ssd_scan(*[t.double() for t in targs], chunk,
                          None if tst is None else tst.double())
    _assert_f64_no_worse(ty.numpy(), jy, y64.numpy(), "y")
    _assert_f64_no_worse(tf.numpy(), jf, f64.numpy(), "final state")

    rng = np.random.default_rng(1)
    r = rng.normal(size=ty.shape).astype(np.float32)
    q = rng.normal(size=tf.shape).astype(np.float32)

    def jloss(*a):
        y, f = JL.ssd_scan(*a[:4], chunk, a[4] if len(a) > 4 else None)
        return jnp.sum(y * r) + jnp.sum(f * q)

    def tloss(*a):
        y, f = L.ssd_scan(*a[:4], chunk, a[4] if len(a) > 4 else None)
        return torch.sum(y * torch.from_numpy(r)) + torch.sum(f * torch.from_numpy(q))

    n = 5 if with_state else 4
    jg = jax.grad(jloss, argnums=tuple(range(n)))(*(jargs + ([jst] if with_state else [])))
    tg = grad(tloss, argnums=tuple(range(n)))(*(targs + ([tst] if with_state else [])))
    for i, (a, b) in enumerate(zip(tg, jg)):
        _assert_norm_close(a.numpy(), b, f"grad {i}")


def test_ssd_scan_intermediates_stay_within_the_decay_matrix(monkeypatch):
    """No einsum of ``ssd_scan`` makes a tensor larger than what the scan
    holds anyway: the [B, H, nc, l, l] decay matrix, the chunk states
    [B, nc + 1, H, P, N] and the output.  At this shape (state size N above
    the chunk) the reference's ``bcln,bhcl,bclhp->bchpn``, contracted left
    to right as ``torch.einsum`` does without ``opt_einsum``, would first
    make a [B, nc, l, N, H] product larger than all three."""
    B, S, H, P, N, chunk = 1, 32, 4, 4, 24, 8
    nc = S // chunk
    x, A, Bm, Cm, _ = _scan_inputs(S, False, B=B, H=H, P=P, N=N)
    limit = max(B * H * nc * chunk * chunk, B * (nc + 1) * H * P * N, B * S * H * P)
    assert B * nc * chunk * N * H > limit
    sizes = []
    real = torch.einsum

    def einsum(eq, *ops):
        out = real(eq, *ops)
        sizes.append((eq, out.numel()))
        return out

    monkeypatch.setattr(torch, "einsum", einsum)
    L.ssd_scan(*[torch.from_numpy(a) for a in (x, A, Bm, Cm)], chunk)
    assert len(sizes) == 5
    assert max(n for _, n in sizes) <= limit, sizes


BLOCK_CASES = [(arch, S) for arch in ("mamba2-1.3b", "jamba-1.5-large-398b")
               for S in (64, 50)]


@pytest.mark.parametrize("arch,S", BLOCK_CASES)
def test_mamba_block_matches_jax(arch, S):
    """Output and the gradients of Σ r·out (every weight and the input), at
    the REDUCED widths (mamba2: chunk 32; jamba: chunk 16); S = 50 runs the
    padded last chunk."""
    js, ts = jax_reduced(arch), get_reduced(arch)
    p = params_to_numpy(JL.init_mamba(jax.random.PRNGKey(0), js))
    rng = np.random.default_rng(S)
    # nudge the zero and constant leaves so each enters the comparison
    p = {k: (v + 0.05 * rng.normal(size=v.shape)).astype(v.dtype) for k, v in p.items()}
    x = rng.normal(size=(2, S, js.d_model)).astype(np.float32)
    r = rng.normal(size=(2, S, js.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    jo, jc = JL.mamba_block(jp, jnp.asarray(x), js)
    assert jc is None
    jg, jgx = jax.grad(lambda q, xx: jnp.sum(JL.mamba_block(q, xx, js)[0] * r),
                       argnums=(0, 1))(jp, jnp.asarray(x))
    tp, tx, tr = params_from_numpy(p, CPU), torch.from_numpy(x), torch.from_numpy(r)
    to, tc = L.mamba_block(tp, tx, ts)
    assert tc is None
    tg, tgx = grad(lambda q, xx: torch.sum(L.mamba_block(q, xx, ts)[0] * tr),
                   argnums=(0, 1))(tp, tx)
    _assert_norm_close(to.numpy(), jo, "output", BLOCK_TOL)
    o64, _ = L.mamba_block({k: torch.from_numpy(v.astype(np.float64)) for k, v in p.items()},
                           torch.from_numpy(x.astype(np.float64)),
                           ts.with_dtypes("float64", "float64"))
    _assert_f64_no_worse(to.numpy(), jo, o64.numpy(), "output")
    assert tg.keys() == jg.keys()
    for k in jg:
        _assert_norm_close(tg[k].numpy(), jg[k], f"grad {k}", BLOCK_TOL)
    _assert_norm_close(tgx.numpy(), jgx, "grad x", BLOCK_TOL)


def test_mamba_block_under_vmap_and_grad_and_value():
    """Engine A's form: three clients' own weights and tokens under
    ``vmap(grad_and_value)`` equal each client's call alone, with no
    batching fallback."""
    spec = get_reduced("mamba2-1.3b")
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    ps = [L.init_mamba(g, spec) for g in gens]
    params = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
    xs = torch.randn((3, 1, 40, spec.d_model), generator=gens[0])

    def loss(p, x):
        return torch.sum(L.mamba_block(p, x, spec)[0] ** 2)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g, v = vmap(grad_and_value(loss))(params, xs)
    for i in range(3):
        gi, vi = grad_and_value(loss)(ps[i], xs[i])
        torch.testing.assert_close(v[i], vi, rtol=1e-5, atol=1e-4)
        for k in gi:
            torch.testing.assert_close(g[k][i], gi[k], rtol=1e-4, atol=1e-4)


def test_mamba_init_is_the_jax_tree():
    for arch in ("mamba2-1.3b", "jamba-1.5-large-398b"):
        js, ts = jax_reduced(arch), get_reduced(arch)
        j = params_to_numpy(JL.init_mamba(jax.random.PRNGKey(0), js))
        t = L.init_mamba(torch.Generator().manual_seed(0), ts)
        assert t.keys() == j.keys()
        for k in j:
            assert t[k].shape == j[k].shape and t[k].numpy().dtype == j[k].dtype, k
        # the deterministic leaves are JAX's (A_log = log(linspace(1, 16)) to an ulp)
        for k in ("D", "dt_bias", "gate_norm", "norm"):
            np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)
        np.testing.assert_allclose(t["A_log"].numpy(), j["A_log"], rtol=2e-7)


def test_the_decode_cache_raises_naming_a14_3():
    """A14.3 is ported: the Mamba decode cache builds and steps (held
    against JAX in tests/test_torch_decode.py); what it still refuses is
    more than one token a step."""
    spec = get_reduced("mamba2-1.3b")
    p = L.init_mamba(torch.Generator().manual_seed(0), spec)
    cache = L.init_mamba_cache(spec, 1, CPU)
    y, new = L.mamba_block(p, torch.zeros(1, 1, spec.d_model), spec, cache=cache)
    assert y.shape == (1, 1, spec.d_model) and new["state"].shape == cache["state"].shape
    with pytest.raises(ValueError, match="one token a step"):
        L.mamba_block(p, torch.zeros(1, 2, spec.d_model), spec, cache=cache)
    assert dataclasses.is_dataclass(spec.ssm)


@functools.lru_cache(maxsize=None)
def _depth_gradients(num_layers):
    """One batch's loss and gradient norm of mamba2-1.3b at ``num_layers``
    blocks, narrowed to d 32 (vocab 512, state 16, head_dim 16) with its
    chunk of 256 at S = 512: JAX in f32, the port in f32 and float64, from
    one JAX init.  Also each f32 gradient's largest per-leaf max-normalised
    distance from the float64 one."""
    narrow = dict(num_layers=num_layers, d_model=32, vocab_size=512)
    ssm = dict(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=256)
    js = dataclasses.replace(jax_spec("mamba2-1.3b"), **narrow, ssm=JaxSsmSpec(**ssm))
    ts = dataclasses.replace(get_spec("mamba2-1.3b"), **narrow, ssm=SsmSpec(**ssm))
    jmodel = JaxModel(js)
    p0 = params_to_numpy(jmodel.init_params(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, 512, (1, 513)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.value_and_grad(jmodel.loss_fn)(jax.tree.map(jnp.asarray, p0),
                                                jax.tree.map(jnp.asarray, batch))
    out = {"jax": (float(jl), [np.asarray(g, np.float64) for g in jax.tree.leaves(jg)])}
    for name, spec, dt in (("port", ts, np.float32),
                           ("f64", ts.with_dtypes("float64", "float64"), np.float64)):
        params = params_from_numpy(jax.tree.map(lambda a: a.astype(dt), p0), CPU)
        leaves = [x.requires_grad_(True) for x in jax.tree.leaves(params)]
        loss = SplittableModel(spec).loss_fn(
            jax.tree.unflatten(jax.tree.structure(params), leaves),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves)
        out[name] = (float(loss.detach()), [g.numpy().astype(np.float64) for g in grads])
    ref = out["f64"][1]
    return {k: dict(loss=loss, norm=float(np.sqrt(sum((g ** 2).sum() for g in gs))),
                    f64_err=max(float(np.abs(g - r).max() / np.abs(r).max())
                                for g, r in zip(gs, ref)))
            for k, (loss, gs) in out.items()}


@pytest.mark.parametrize("num_layers", [4, 16, 48])
def test_mamba_gradient_grows_with_depth_as_in_jax(num_layers):
    """mamba2-1.3b's init gives a gradient that grows with depth, in the
    reference and the port alike: narrowed to d 32, its norm is ~5.7 at 4
    blocks and ~2.7e4 at 48, where neither package's f32 gradient stays
    near the float64 one.  So plain SGD at a fixed learning rate diverges
    the deeper the stack (the full-width cell's learning rate, PERF.md).
    At every depth the port's loss is within 1e-4 of JAX's, its gradient
    norm within 5%, and its distance from float64 at most twice JAX's."""
    got = _depth_gradients(num_layers)
    print(f"\n{num_layers} blocks: " + "; ".join(
        f"{k} loss {v['loss']:.8f} |g| {v['norm']:.6g} f64 distance {v['f64_err']:.3g}"
        for k, v in got.items()))
    jx, port, f64 = got["jax"], got["port"], got["f64"]
    assert abs(port["loss"] - jx["loss"]) <= 1e-4 * abs(jx["loss"])
    assert abs(port["norm"] - jx["norm"]) <= 0.05 * jx["norm"]
    assert port["f64_err"] <= 2 * jx["f64_err"]
    if num_layers == 48:
        shallow = _depth_gradients(4)
        for k in ("jax", "port", "f64"):
            assert got[k]["norm"] >= 1e3 * shallow[k]["norm"], k
