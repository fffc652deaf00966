"""The MoE layer (``layers.moe``) in the port against the JAX package's
``L.moe``: the same JAX-drawn expert weights (carried through NumPy) and the
same NumPy inputs give the same output, aux loss, gradients and routing, at
one dispatch group (the gather combine) and at four (the scatter-add
combine), where the default capacity drops tokens and where capacity 8.0
drops none; the layer under ``torch.func.vmap`` and ``grad_and_value``; and
the port's mirror of ``tests/test_models_smoke.py::test_moe_grouped_gradients``.

Tolerances.  The reference's expert stacks are drawn with fan-in E
(``_dense_init`` of an [E, d, ff] leaf), so a layer's outputs reach a few
hundred and its f32 sums over d_ff carry ~1e-4 of rounding noise in either
package, each as far from a float64 evaluation as the other.  Outputs and
gradients are therefore held at a max-normalised 1e-5 (max |port − JAX| ≤
1e-5 · max |JAX|), and the port's distance from the float64 evaluation to
at most twice JAX's; the aux scalar at rtol 1e-5 / atol 1e-6."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from repro.configs import get_reduced as jax_reduced
from repro.models import layers as JL
from repro.models.spec import MoeSpec as JMoe
from repro_torch.configs import get_reduced
from repro_torch.models import MoeSpec, params_from_numpy, params_to_numpy
from repro_torch.models import layers as L

CPU = torch.device("cpu")
NORM_TOL = 1e-5
AUX_RTOL, AUX_ATOL = 1e-5, 1e-6
# JAX's K-th/(K+1)-th gate margin under which the expert ids may differ
TIE_MARGIN = 1e-6


def _specs(case, capacity):
    """(JAX spec, port spec) of one case: granite's and phi3.5's REDUCED
    (both 4 experts top-2 at d 128; the two REDUCED configs coincide), and
    granite's full-width routing (32 experts top-8) at REDUCED widths."""
    arch = "phi3.5-moe-42b-a6.6b" if case == "phi3.5" else "granite-moe-1b-a400m"
    js, ts = jax_reduced(arch), get_reduced(arch)
    e, k = (32, 8) if case == "granite-e32k8" else (js.moe.num_experts, js.moe.top_k)
    cf = capacity if capacity is not None else js.moe.capacity_factor
    js = dataclasses.replace(js, moe=JMoe(num_experts=e, top_k=k, capacity_factor=cf))
    ts = dataclasses.replace(ts, moe=MoeSpec(num_experts=e, top_k=k, capacity_factor=cf))
    return js, ts


def _inputs(js, seed=0, shape=(2, 64)):
    """JAX's expert weights, and tokens with a component they share (so the
    router favours some experts and the default capacity overflows)."""
    p = params_to_numpy(JL.init_moe(jax.random.PRNGKey(seed), js))
    rng = np.random.default_rng(seed + 1)
    common = 2.0 * rng.normal(size=(js.d_model,))
    x = (rng.normal(size=shape + (js.d_model,)) + common).astype(np.float32)
    r = rng.normal(size=shape + (js.d_model,)).astype(np.float32)  # the loss's weights
    return p, x, r


def _assert_norm_close(got, ref, what):
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    assert err <= NORM_TOL * scale, f"{what}: max |port - JAX| {err:.3g} > {NORM_TOL} x {scale:.3g}"


def _f64(tree):
    return {k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in tree.items()}


CASES = [(case, cap, groups) for case in ("granite", "phi3.5", "granite-e32k8")
         for cap in (None, 8.0) for groups in (1, 4)]


@pytest.mark.parametrize("case,capacity,groups", CASES,
                         ids=[f"{c}-cap{k or 'default'}-g{g}" for c, k, g in CASES])
def test_moe_matches_jax(case, capacity, groups):
    """Output, aux, the gradients of Σ r·out + aux (every weight and the
    input), and the expert ids wherever JAX's gate margin exceeds 1e-6."""
    js, ts = _specs(case, capacity)
    p, x, r = _inputs(js)
    jp = jax.tree.map(jnp.asarray, p)

    def jloss(params, xx):
        out, aux = JL.moe(params, xx, js, groups=groups)
        return jnp.sum(out * r) + aux

    jout, jaux = JL.moe(jp, jnp.asarray(x), js, groups=groups)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp, tx, tr = params_from_numpy(p, CPU), torch.from_numpy(x), torch.from_numpy(r)

    def tloss(params, xx):
        out, aux = L.moe(params, xx, ts, groups=groups)
        return torch.sum(out * tr) + aux

    tout, taux = L.moe(tp, tx, ts, groups=groups)
    tg, tgx = grad(tloss, argnums=(0, 1))(tp, tx)

    jout = np.asarray(jout, np.float64)
    _assert_norm_close(tout.numpy(), jout, "output")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL, atol=AUX_ATOL)
    # the port is no further from a float64 evaluation than JAX is, twice over
    o64, a64 = L.moe(_f64(p), torch.from_numpy(x.astype(np.float64)),
                     ts.with_dtypes("float64", "float64"), groups=groups)
    o64 = o64.numpy()
    assert np.abs(tout.numpy() - o64).max() <= 2 * np.abs(jout - o64).max() + 1e-7 * np.abs(o64).max()
    np.testing.assert_allclose(float(taux), float(a64), rtol=AUX_RTOL)
    for k in jg:
        _assert_norm_close(tg[k].numpy(), np.asarray(jg[k], np.float64), f"grad {k}")
    _assert_norm_close(tgx.numpy(), np.asarray(jgx, np.float64), "grad x")

    # routing: the top-k ids agree wherever JAX's k-th gate clears the next
    G = groups if (x.shape[0] * x.shape[1]) % groups == 0 else 1
    xg = jnp.asarray(x).reshape(G, -1, js.d_model)
    jprobs = jax.nn.softmax((xg @ jp["router"]).astype(jnp.float32), axis=-1)
    srt = -np.sort(-np.asarray(jprobs), axis=-1)
    K = js.moe.top_k
    margin = srt[..., K - 1] - srt[..., K]
    _, jids = jax.lax.top_k(jprobs, K)
    _, _, tids = L.moe_route(tp, tx.reshape(G, -1, ts.d_model), ts)
    clear = margin > TIE_MARGIN
    same = np.all(np.sort(np.asarray(jids), -1) == np.sort(tids.numpy(), -1), axis=-1)
    assert same[clear].all()
    # no near-tie in any of these cases: every token's ids are compared
    assert int((~clear).sum()) == 0, int((~clear).sum())
    # the default capacity drops (token, k) pairs in every case; 8.0 none
    Tg = tids.shape[1]
    cap = int(max(1, np.ceil(Tg * K / ts.moe.num_experts * ts.moe.capacity_factor)))
    load = torch.stack([torch.bincount(t.reshape(-1), minlength=ts.moe.num_experts)
                        for t in tids])
    dropped = int(torch.clamp(load - cap, min=0).sum())
    assert (dropped > 0) == (capacity is None), (dropped, cap)


def test_moe_under_vmap_and_grad_and_value():
    """Engine A's form: ``vmap(grad_and_value)`` over three clients' own
    weights and tokens equals each client's call alone, with no batching
    fallback (a fallback warns), at both combines."""
    js, ts = _specs("granite", None)
    clients = [_inputs(js, seed=s, shape=(1, 32)) for s in range(3)]
    stack = lambda i: np.stack([c[i] for c in clients])  # noqa: E731
    params = params_from_numpy(jax.tree.map(lambda *xs: np.stack(xs), *[c[0] for c in clients]),
                               CPU)
    xs, rs = torch.from_numpy(stack(1)), torch.from_numpy(stack(2))
    for groups in (1, 4):
        def loss(p, x, r):
            out, aux = L.moe(p, x, ts, groups=groups)
            return torch.sum(out * r) + aux

        with warnings.catch_warnings():
            warnings.simplefilter("error")
            g, v = vmap(grad_and_value(loss))(params, xs, rs)
        for i in range(3):
            pi = {k: t[i] for k, t in params.items()}
            gi, vi = grad_and_value(loss)(pi, xs[i], rs[i])
            torch.testing.assert_close(v[i], vi, rtol=1e-6, atol=1e-5)
            for k in gi:
                torch.testing.assert_close(g[k][i], gi[k], rtol=1e-5, atol=1e-5)


def test_moe_grouped_gradients():
    """The port's mirror of the JAX package's test: at capacity 8.0 (no
    drops) the grouped dispatch with the scatter-add combine is
    differentiable and its gradients match the one-group gather path within
    the reference's rtol 5e-4 / atol 5e-5 (the aux differs: it is averaged
    per group)."""
    _, spec = _specs("granite", 8.0)
    p = L.init_moe(torch.Generator().manual_seed(0), spec)
    x = torch.randn((2, 16, spec.d_model), generator=torch.Generator().manual_seed(1))

    def loss(params, g):
        out, aux = L.moe(params, x, spec, groups=g)
        return torch.sum(out ** 2) + aux

    g1 = grad(lambda q: loss(q, 1))(p)
    g4 = grad(lambda q: loss(q, 4))(p)
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), g4[k].numpy(), rtol=5e-4, atol=5e-5, err_msg=k)
        assert torch.isfinite(g4[k]).all()


def test_moe_dropped_pairs_add_nothing():
    """A (token, k) pair past its expert's capacity adds nothing to its
    token's output, at both combines: with one expert's capacity exhausted,
    the output equals a dense evaluation of the kept pairs alone."""
    js, ts = _specs("granite", None)
    p, x, _ = _inputs(js, shape=(1, 64))
    tp, tx = params_from_numpy(p, CPU), torch.from_numpy(x)
    for groups in (1, 4):
        xg = tx.reshape(groups, -1, ts.d_model)
        _, gates, ids = L.moe_route(tp, xg, ts)
        Tg, K, E = xg.shape[1], ts.moe.top_k, ts.moe.num_experts
        cap = int(max(1, np.ceil(Tg * K / E * ts.moe.capacity_factor)))
        ref = torch.zeros_like(xg)
        for g in range(groups):
            seen = [0] * E
            for t in range(Tg):
                for k in range(K):
                    e = int(ids[g, t, k])
                    if seen[e] < cap:
                        w1, w3, w2 = tp["w1"][e], tp["w3"][e], tp["w2"][e]
                        y = (torch.nn.functional.silu(xg[g, t] @ w1) * (xg[g, t] @ w3)) @ w2
                        ref[g, t] += gates[g, t, k] * y
                    seen[e] += 1
        out, _ = L.moe(tp, tx, ts, groups=groups)
        _assert_norm_close(out.reshape(groups, -1, ts.d_model).numpy(),
                           ref.numpy().astype(np.float64), f"groups {groups}")
