"""The VLM family (paligemma-3b, ROADMAP A14.4) and ``configs.shapes`` in the
port against the JAX package: the specs field by field, ``input_specs`` and
``concrete_inputs``, the prefix-LM mask in the attention kernels' plain
versions and in ``layers.attention``, ``SplittableModel``'s parameter tree,
forward, loss, gradients and decode, Engine A and Engine B step by step,
``engine_b_to_full`` and ``params_from_numpy`` on both layouts, Engine B's
tied-logit pad gap, and the refusals of both CLIs and ``api.run``.  Every
init is drawn once in JAX and carried through NumPy; batches are NumPy's.

Tolerances.  The attention plain versions against JAX's
``_sdpa(_mask_bias(...))`` and its ``jax.grad``: the attention kernels'
ATTN_TOL = 2e-5, rtol = atol for o and after max-normalising for the
gradients, as ``tests/test_kernels_swa.py`` holds its backward: the flash
backward's sums (dv = pᵀ·do over up to S rows) run in another order than
``jax.grad``'s, and at rtol = atol = 2e-5 a few elements near 0 miss by up
to 4e-5 of an |dv| of order 1.  The model: logits and loss rtol 1e-5 / atol
1e-5, gradients at a max-normalised 1e-5 per leaf (the dense family's).
Decode: logits and caches rtol 1e-5 / atol 1e-5 against JAX; teacher
forcing against the dense twin's forward (the same weights under
``family="dense", prefix_len=0``: what the JAX package's VLM decode
computes, text only and without the √d scale) at a max-normalised 1e-5.
The engines: losses rtol 1e-5, params atol 5e-6 / rtol 1e-4 (JAX's own
A == B).  Engine B's tied logits skip the pad mask in both packages
(ROADMAP §C), so at vocab 500 (padded to 512) its loss stands apart from
Engine A's; the port reproduces JAX's gap to within rtol 1e-4 of it.  The
gap (0.0234) sits beside losses of 6.2, whose f32 ulp is 4.8e-7 = 2.0e-5
of the gap, and from the second step each engine's params differ from
JAX's at f32 level (the A == B tolerance): measured 2.0e-5 of the gap at
step 0 and 6.1e-5 after, so 1e-5 is finer than the losses resolve.
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
from repro.configs import shapes as jshapes
from repro.core import (
    build_train_step_a as jax_step_a, build_train_step_b as jax_step_b,
    init_state_a as jax_init_a, init_state_b as jax_init_b,
)
from repro.core.engine import engine_b_to_full as jax_engine_b_to_full
from repro.core.tiers import default_plan as jax_plan
from repro.launch import serve as jserve, train as jtrain
from repro.models import layers as JL
from repro.models.model import SplittableModel as JaxModel
from repro.optim import sgd as jsgd
import repro_torch.configs as tconfigs
from repro_torch import api as T
from repro_torch.configs import shapes as tshapes
from repro_torch.core import (
    TrainState, build_train_step_a, build_train_step_b, default_plan, init_state_b,
    replicate_for_clients,
)
from repro_torch.core.engine import engine_b_to_full
from repro_torch.kernels.swa_attention import swa_attention, swa_attention_ref
from repro_torch.launch import serve as tserve, train as ttrain
from repro_torch.models import ModelSpec, SplittableModel, params_from_numpy, params_to_numpy
from repro_torch.models import layers as L
from repro_torch.optim import sgd

ARCH = "paligemma-3b"
CPU = torch.device("cpu")
ATTN_TOL = 2e-5
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
NORM_TOL = 1e-5
N, B, TEXT, STEPS = 8, 2, 12, 4  # the engines: clients, batch, text tokens, steps
LOSS_RTOL, LOSS_ATOL, ATOL, RTOL = 1e-5, 1e-6, 5e-6, 1e-4
# tests/test_engines_equal.py's plan shapes for a 2-unit model: tier 2
# empty, then tier 3 empty
PLANS = {"cuts11": ((1, 1), (2, 4, 1)), "cuts12": ((1, 2), (3, 2, 1))}
KERNEL_TILE = 32  # the kv tile of B4 and the dq pass, the q tile of dk/dv


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


def _port_spec(jspec) -> ModelSpec:
    """The port's ModelSpec of a JAX spec without MoE or SSM sections."""
    return ModelSpec(**dataclasses.asdict(jspec))


@functools.lru_cache(maxsize=None)
def _init(vocab=None):
    """One JAX init of REDUCED paligemma (``PRNGKey(0)``), as NumPy arrays."""
    return params_to_numpy(JaxModel(_jspec(vocab)).init_params(jax.random.PRNGKey(0)))


def _jspec(vocab=None):
    s = jconfigs.get_reduced(ARCH)
    return s if vocab is None else dataclasses.replace(s, vocab_size=vocab)


def _tspec(vocab=None):
    s = tconfigs.get_reduced(ARCH)
    return s if vocab is None else dataclasses.replace(s, vocab_size=vocab)


def _perturbed(seed=0):
    """The JAX init with every leaf nudged, so zero-initialised norms take
    part in the comparison."""
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(x.dtype),
                        _init())


def _vlm_batch(spec, lead, text, seed):
    """patch_embeds [*lead, P, d] normal; tokens and labels [*lead, text]
    in [0, V), the first three labels masked (-1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, spec.vocab_size, tuple(lead) + (text + 1,)).astype(np.int32)
    labels = toks[..., 1:].copy()
    labels[..., :3] = -1
    pe = rng.normal(size=tuple(lead) + (spec.prefix_len, spec.d_model)).astype(np.float32)
    return {"patch_embeds": pe, "tokens": toks[..., :-1], "labels": labels}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# specs and shapes
# --------------------------------------------------------------------------- #


def test_specs_match_jax_field_by_field():
    for variant in ("SPEC", "REDUCED"):
        t = getattr(tconfigs._mod(ARCH), variant)
        j = getattr(jconfigs._mod(ARCH), variant)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.hd, t.padded_vocab, t.n_units, t.layers_per_unit, t.prefix_len) == (
            j.hd, j.padded_vocab, j.n_units, j.layers_per_unit, j.prefix_len)
        assert t.total_param_count() == j.total_param_count()
        for b, s in ((1, 64), (2, 512)):
            assert t.unit_flops_fwd(0, b, s) == j.unit_flops_fwd(0, b, s)
    spec = tconfigs.get_spec(ARCH)
    # the full-width sizes that PERF.md and the card's [vlm] phase rely on
    assert (spec.hd, spec.num_heads, spec.num_kv_heads, spec.padded_vocab) == (256, 8, 1, 257280)
    assert spec.total_param_count() == 2_508_793_856
    assert (tshapes.LONG_CONTEXT_WINDOW, list(tshapes.SHAPES)) == (
        jshapes.LONG_CONTEXT_WINDOW, list(jshapes.SHAPES))
    for name, shape in tshapes.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshapes.SHAPES[name])


_NP = {torch.int32: np.dtype(np.int32), torch.float32: np.dtype(np.float32),
       torch.bfloat16: np.dtype(jnp.bfloat16)}


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_input_specs_match_jax_for_every_arch(shape):
    """Keys, shapes and dtypes of every arch's inputs (the audio one from
    JAX's spec, which the port's registry does not resolve yet), on the
    meta device, allocating nothing."""
    for arch in jconfigs.ARCH_IDS:
        for bf16 in (False, True):
            jspec = jconfigs.get_spec(arch)
            if bf16:
                jspec = jspec.with_dtypes("float32", "bfloat16")
            tspec = _port_spec(dataclasses.replace(jspec, moe=None, ssm=None))
            j = jshapes.input_specs(jspec, jshapes.SHAPES[shape])
            t = tshapes.input_specs(tspec, tshapes.SHAPES[shape])
            assert t.keys() == j.keys(), arch
            for k in j:
                assert t[k].device.type == "meta"
                assert tuple(t[k].shape) == tuple(j[k].shape), (arch, k)
                assert _NP[t[k].dtype] == np.dtype(j[k].dtype), (arch, k)


@pytest.mark.parametrize("arch", ["smollm-135m", ARCH, "whisper-large-v3"])
def test_concrete_inputs_keys_shapes_dtypes_and_ranges(arch):
    """JAX's keys, shapes, dtypes and ranges: tokens and labels in [0, V),
    the embeddings standard normal; one seed gives one batch."""
    jspec = jconfigs.get_reduced(arch)
    tspec = _port_spec(dataclasses.replace(jspec, moe=None, ssm=None))
    j = jshapes.concrete_inputs(jspec, 4, 40, jax.random.PRNGKey(0))
    t = tshapes.concrete_inputs(tspec, 4, 40, torch.Generator().manual_seed(0), CPU)
    again = tshapes.concrete_inputs(tspec, 4, 40, torch.Generator().manual_seed(0), CPU)
    assert t.keys() == j.keys()
    for k in j:
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        assert _NP[t[k].dtype] == np.dtype(j[k].dtype), k
        assert torch.equal(t[k], again[k])
        if t[k].dtype == torch.int32:
            assert int(t[k].min()) >= 0 and int(t[k].max()) < jspec.vocab_size
        else:
            assert abs(float(t[k].mean())) < 0.05 and abs(float(t[k].std()) - 1.0) < 0.05
    if arch == ARCH:
        assert t["tokens"].shape == (4, 40 - jspec.prefix_len)
        assert t["patch_embeds"].shape == (4, jspec.prefix_len, jspec.d_model)


# --------------------------------------------------------------------------- #
# the prefix-LM mask: the attention kernels' plain versions and the layer
# --------------------------------------------------------------------------- #

S_RAGGED = 100
PREFIXES = [1, 4, KERNEL_TILE - 1, KERNEL_TILE, S_RAGGED - 1, S_RAGGED, S_RAGGED + 3]


def _jax_attention(q, k, v, window, prefix):
    pos = jnp.arange(q.shape[1])
    return JL._sdpa(q, k, v, JL._mask_bias(pos, pos, True, window, prefix))


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("hd", [32, 256])
@pytest.mark.parametrize("window", [0, 64])
def test_plain_versions_with_a_prefix_match_jax(window, hd, G):
    """o and the gradients of q, k and v (through ``swa_attention``'s
    autograd, the flash backward's plain versions) against JAX's ``_sdpa``
    under ``_mask_bias`` and ``jax.grad``, at a ragged S and every prefix
    of ``PREFIXES``: 1, a few, around the kernels' tile, S - 1, S, past S."""
    K = 2 if G < 8 else 1
    H = G * K
    rng = np.random.default_rng(hd + G + window)
    q, do = (rng.normal(size=(2, S_RAGGED, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(2, S_RAGGED, K, hd)).astype(np.float32) for _ in range(2))
    for P in PREFIXES:
        jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
        jo = _jax_attention(jq, jk, jv, window, P)
        jg = jax.grad(lambda a, b, c: jnp.sum(_jax_attention(a, b, c, window, P) * jdo),
                      argnums=(0, 1, 2))(jq, jk, jv)
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        to = swa_attention(tq, tk, tv, window, P)
        ro, _ = swa_attention_ref(tq.detach(), tk.detach(), tv.detach(), window, P)
        assert torch.equal(to.detach(), ro)
        tg = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=ATTN_TOL,
                                   atol=ATTN_TOL, err_msg=f"o prefix {P}")
        for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
            _norm_close(a.numpy(), b, ATTN_TOL, f"{name} prefix {P}")


@pytest.mark.parametrize("window,prefix", [(0, 4), (0, 10), (6, 10)])
def test_layers_attention_with_a_prefix_matches_jax(window, prefix):
    jspec, tspec = _jspec().with_window(window), _tspec().with_window(window)
    unit0 = jax.tree.map(lambda a: a[0], _perturbed()["units"])
    x = np.random.default_rng(prefix).normal(size=(2, 24, jspec.d_model)).astype(np.float32)
    ja, _ = JL.attention(jax.tree.map(jnp.asarray, unit0["attn"]), jnp.asarray(x), jspec,
                         prefix_len=prefix)
    ta, cache = L.attention(params_from_numpy(unit0["attn"], CPU), torch.from_numpy(x), tspec,
                            prefix_len=prefix)
    assert cache is None
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **MODEL_TOL)
    # the prefix changes the output (the mask is not the causal one)
    causal, _ = L.attention(params_from_numpy(unit0["attn"], CPU), torch.from_numpy(x), tspec)
    assert not torch.allclose(causal, ta)


def test_decode_attention_takes_no_prefix():
    spec = _tspec()
    attn = params_from_numpy(jax.tree.map(lambda a: a[0], _init()["units"])["attn"], CPU)
    with pytest.raises(ValueError, match="no prefix"):
        L.attention(attn, torch.zeros(1, 1, spec.d_model), spec, prefix_len=2,
                    cache=L.init_attn_cache(spec, 1, 8, CPU))


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


def test_init_params_is_the_jax_tree():
    """Structure, shapes and dtypes leaf for leaf, ``frontend/proj`` [d, d]
    among them."""
    p = SplittableModel(_tspec()).init_params(torch.Generator().manual_seed(0), CPU)
    got, ref = _flat(p), _flat(_init())
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    d = _tspec().d_model
    assert got["frontend/proj"].shape == (d, d)


def test_forward_loss_and_grads_match_jax():
    """Logits over the prefix and the text, the loss on the text positions
    only, and every gradient (``frontend/proj`` included)."""
    jspec, tspec = _jspec(), _tspec()
    jm, tm = JaxModel(jspec), SplittableModel(tspec)
    p = _perturbed()
    batch = _vlm_batch(jspec, (2,), 20, seed=1)
    jp, jb = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, batch)
    jlogits, _ = jm.forward(jp, jb)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jp, jb)
    tp, tb = params_from_numpy(p, CPU), _to_torch(batch)
    tlogits, taux = tm.forward(tp, tb)
    assert tlogits.shape == (2, jspec.prefix_len + 20, jspec.padded_vocab)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), **MODEL_TOL)
    assert float(taux) == 0.0
    tloss = tm.loss_fn(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    leaves = list(_flat(tp).keys())
    live = [x.requires_grad_(True) for x in jax.tree.leaves(tp)]
    grads = torch.autograd.grad(tm.loss_fn(tp, tb), live)
    tg, jg = dict(zip(leaves, (g.numpy() for g in grads))), _flat(params_to_numpy(jgrads))
    assert tg.keys() == jg.keys()
    for k in jg:
        _norm_close(tg[k], jg[k], NORM_TOL, k)
    assert float(np.abs(tg["frontend/proj"]).max()) > 0.0


def test_decode_matches_jax_and_teacher_forcing_matches_the_dense_twin():
    """Six decode steps against JAX's (logits and every cache leaf after
    each step), then teacher forcing: the VLM decodes its text as a dense
    model, so its decode logits equal the forward of the same weights under
    ``family="dense", prefix_len=0``."""
    jspec, tspec = _jspec(), _tspec()
    jm, tm = JaxModel(jspec), SplittableModel(tspec)
    p = _perturbed()
    tp = params_from_numpy(p, CPU)
    Bd, C, steps = 2, 8, 6
    toks = np.random.default_rng(4).integers(0, jspec.vocab_size, (Bd, steps)).astype(np.int32)
    jcache, tcache = jm.init_caches(Bd, C), tm.init_caches(Bd, C, CPU)
    jp = jax.tree.map(jnp.asarray, p)
    step = jax.jit(jm.decode_step)
    got = []
    for i in range(steps):
        jlog, jcache = step(jp, jnp.asarray(toks[:, i:i + 1]), jcache, jnp.int32(i))
        tlog, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]), tcache, i)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **MODEL_TOL,
                                   err_msg=f"step {i}")
        a, b = _flat(tcache), _flat(jcache)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_allclose(a[k], b[k], **MODEL_TOL, err_msg=f"step {i} {k}")
        got.append(tlog)
    twin = SplittableModel(dataclasses.replace(tspec, family="dense", prefix_len=0))
    fwd, _ = twin.forward(tp, {"tokens": torch.from_numpy(toks)})
    _norm_close(torch.stack(got, 1).numpy(), fwd.detach().numpy(), NORM_TOL, "teacher forcing")


# --------------------------------------------------------------------------- #
# the engines
# --------------------------------------------------------------------------- #


class _Carried:
    def __init__(self, p0):
        self.p0 = p0

    def init_params(self, generator, device=None):
        return params_from_numpy(self.p0, device)


def _batches(spec, steps=STEPS, seed=0):
    return [_vlm_batch(spec, (N, B), TEXT, seed + t) for t in range(steps)]


def _plans(key, n_units=2):
    cuts, intervals = PLANS[key]
    kw = dict(cuts=cuts, intervals=intervals, entities=(N, 4, 1))
    return jax_plan(n_units, N, **kw), default_plan(n_units, N, **kw)


@functools.lru_cache(maxsize=None)
def _runs(key, vocab=None, steps=STEPS):
    """(losses, params) after every step of JAX's Engine A and B and the
    port's A and B, sgd 1e-2, from one init."""
    jspec, tspec = _jspec(vocab), _tspec(vocab)
    jp, tp = _plans(key)
    jm, tm = JaxModel(jspec), SplittableModel(tspec)
    batches = _batches(jspec, steps)
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
    params = replicate_for_clients(params_from_numpy(p0, CPU), N)
    states = {"port_a": (TrainState(params, (), 0), build_train_step_a(tm, tp, sgd(1e-2))),
              "port_b": (init_state_b(_Carried(p0), tp, sgd(1e-2), torch.Generator(), CPU),
                         build_train_step_b(tm, tp, sgd(1e-2)))}
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
        a, b = jax.tree.leaves(to_numpy(tp)), jax.tree.leaves(jp)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == np.asarray(y).shape
            np.testing.assert_allclose(x, np.asarray(y), atol=ATOL, rtol=RTOL, err_msg=f"step {t}")


@pytest.mark.parametrize("key", list(PLANS))
def test_engine_a_matches_jax(key):
    """N = 8, J₂ = 4, batch 2, 4 + 12 tokens, 4 steps, sgd 1e-2: losses
    rtol 1e-5, the client-stacked params atol 5e-6 / rtol 1e-4 after every
    step."""
    r = _runs(key)
    _steps_close(r["port_a"], r["jax_a"])


@pytest.mark.parametrize("key", list(PLANS))
def test_engine_b_matches_jax(key):
    """Every tier's entity stacks after every step: the prefix mask on
    every tier, the prefix's logits dropped before the loss."""
    r = _runs(key)
    _steps_close(r["port_b"], r["jax_b"])


@pytest.mark.parametrize("key", list(PLANS))
def test_port_engine_a_equals_engine_b(key):
    r = _runs(key)
    tm = SplittableModel(_tspec())
    _, tp = _plans(key)
    full = [(lb, engine_b_to_full(tm, tp, pb)) for lb, pb in r["port_b"]]
    _steps_close([(la, pa) for la, pa in r["port_a"]],
                 [(lb, params_to_numpy(pb)) for lb, pb in full])


@pytest.mark.parametrize("key", list(PLANS))
def test_params_from_numpy_and_engine_b_to_full_on_both_layouts(key):
    """JAX's client-stacked state (Engine A) and per-tier list (Engine B)
    cross to the port leaf for leaf, ``frontend/proj`` on tier 1 with its
    clients' axis; the port's ``engine_b_to_full`` equals JAX's on them."""
    jm = JaxModel(_jspec())
    jp, tp = _plans(key)
    sa = jax_init_a(jm, jp, jsgd(1e-2), jax.random.PRNGKey(0))
    sb = jax_init_b(jm, jp, jsgd(1e-2), jax.random.PRNGKey(0))
    for state in (sa, sb):
        ref = params_to_numpy(state.params)
        got = params_from_numpy(ref, CPU)
        a, b = _flat(got), _flat(ref)
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    d = _jspec().d_model
    tiers = params_from_numpy(params_to_numpy(sb.params), CPU)
    assert isinstance(tiers, list) and tiers[0]["frontend"]["proj"].shape == (N, d, d)
    assert _flat(params_from_numpy(params_to_numpy(sa.params), CPU))[
        "frontend/proj"].shape == (N, d, d)
    full = engine_b_to_full(SplittableModel(_tspec()), tp, tiers)
    ref = _flat(params_to_numpy(jax_engine_b_to_full(jm, jp, sb.params)))
    got = _flat(full)
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def test_engine_b_pad_gap_reproduces_jax():
    """Vocab 500, padded to 512: Engine B's tied logits skip the pad mask in
    both packages (ROADMAP §C), so its loss differs from Engine A's by
    about ln(512 / 500) at near-uniform logits; the port's gap equals JAX's
    to within rtol 1e-4 of it at every step (see the module's tolerances)."""
    r = _runs("cuts12", vocab=500, steps=3)
    for t in range(3):
        jgap = r["jax_b"][t][0] - r["jax_a"][t][0]
        tgap = r["port_b"][t][0] - r["port_a"][t][0]
        assert 0.5 * np.log(512 / 500) < jgap < 2.0 * np.log(512 / 500), jgap
        assert abs(tgap - jgap) <= 1e-4 * abs(jgap), (t, tgap, jgap)


# --------------------------------------------------------------------------- #
# the CLIs and the API
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("cli", ["train", "serve"])
def test_clis_refuse_the_vlm_with_jax_s_words(cli):
    j, t = {"train": (jtrain, ttrain), "serve": (jserve, tserve)}[cli]
    argv = ["--arch", ARCH]
    with pytest.raises(SystemExit) as jerr:
        j.main(argv)
    with pytest.raises(SystemExit) as terr:
        t.main(["--device", "cpu"] + argv)
    assert str(terr.value) == str(jerr.value)
    assert str(jerr.value).startswith(f"{ARCH}: ")


def test_api_run_on_the_vlm_fails_before_any_step_in_both_packages(monkeypatch):
    """The capability check lets paligemma-3b through, as JAX's build does;
    then ``run`` trains on the LM stream, which carries no image-prefix
    embeddings, and both packages fail on the missing ``patch_embeds``
    before any step completes."""
    js = J.paper_spec().replace(
        model=J.ModelCfg(arch=ARCH, variant="reduced", batch=2, seq=32),
        system=J.SystemCfg(num_clients=4, num_edges=2),
        solver=J.SolverCfg(kind="fixed", cuts=(1, 1), intervals=(2, 2, 1)),
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
    with pytest.raises(KeyError, match="patch_embeds"):
        J.run(js)
    with pytest.raises(KeyError, match="patch_embeds"):
        T.run(ts, device="cpu")
    assert steps == []
