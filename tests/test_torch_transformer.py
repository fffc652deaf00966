"""The port's dense transformer path against the JAX package: the specs and
their analytic counts, the layers, ``SplittableModel`` and Engine A, from
one JAX init carried over as numpy and the same batches.  The port's
attention runs the flash-attention Functions (their plain versions on the
CPU); the JAX model runs ``_sdpa``."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

import repro.configs as jconfigs
from repro.core import build_train_step_a as jax_build_step, init_state_a as jax_init
from repro.core.tiers import default_plan as jax_default_plan
from repro.models import layers as JL
from repro.models.model import SplittableModel as JaxModel
from repro.optim import adam as jadam, sgd as jsgd
import repro_torch.configs as tconfigs
from repro_torch.core import TrainState, build_train_step_a, default_plan, init_state_a
from repro_torch.launch import train
from repro_torch.models import (
    ModelSpec, MoeSpec, SplittableModel, build_model, params_from_numpy, params_to_numpy,
)
from repro_torch.models import layers as L
from repro_torch.optim import adam, sgd

CPU = torch.device("cpu")
DENSE = ["smollm-135m", "qwen2-1.5b", "qwen2.5-14b", "qwen3-32b"]
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, prefix + (str(key),)).items()}
    if isinstance(tree, torch.Tensor):
        return {"/".join(prefix): tree.detach().numpy()}
    return {"/".join(prefix): np.asarray(tree)}


def _perturbed_init(jspec, seed=0):
    """The JAX init with every leaf nudged, so zero-initialised norms and
    biases take part in the comparison."""
    p = params_to_numpy(JaxModel(jspec).init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def nudge(x):
        return (x + 0.05 * rng.normal(size=x.shape)).astype(x.dtype)

    return jax.tree.map(nudge, p)


def _tokens(vocab, shape, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape[:-1] + (shape[-1] + 1,)).astype(np.int32)
    labels = toks[..., 1:].copy()
    labels[..., :3] = -1  # masked label positions
    return {"tokens": toks[..., :-1], "labels": labels}


# --------------------------------------------------------------------------- #
# specs and registry
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", DENSE)
def test_spec_counts_match_jax(arch):
    for variant in ("SPEC", "REDUCED"):
        t = getattr(tconfigs._mod(arch), variant)
        j = getattr(jconfigs._mod(arch), variant)
        for f in dataclasses.fields(j):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert (t.hd, t.padded_vocab, t.n_units, t.layers_per_unit) == (
            j.hd, j.padded_vocab, j.n_units, j.layers_per_unit)
        for u in range(t.n_units):
            assert t.unit_param_count(u) == j.unit_param_count(u)
        for b, s in ((1, 64), (2, 1024), (4, 4096)):
            assert t.unit_flops_fwd(0, b, s) == j.unit_flops_fwd(0, b, s)
            assert t.with_window(128).unit_flops_fwd(0, b, s) == \
                j.with_window(128).unit_flops_fwd(0, b, s)
            assert t.unit_act_bytes(b, s) == j.unit_act_bytes(b, s)
        assert t.frontend_param_count() == j.frontend_param_count()
        assert t.head_param_count() == j.head_param_count()
        assert t.total_param_count() == j.total_param_count()
        assert t.active_param_count() == j.active_param_count()
        assert t.pdtype == torch.float32 and t.cdtype == torch.float32
        bf = t.with_dtypes("bfloat16", "bfloat16")
        assert bf.pdtype == bf.cdtype == torch.bfloat16
    assert tconfigs.get_spec("smollm-135m").total_param_count() == 134_515_008


def test_spec_counts_of_the_other_families_match_jax():
    """The counts are plain Python and cover every family, ported or not."""
    for arch in jconfigs.ARCH_IDS:
        j = jconfigs.get_spec(arch)
        fields = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        if j.moe is not None:
            fields["moe"] = MoeSpec(**dataclasses.asdict(j.moe))
        if j.ssm is not None:
            from repro_torch.models import SsmSpec
            fields["ssm"] = SsmSpec(**dataclasses.asdict(j.ssm))
        t = ModelSpec(**fields)
        assert t.n_units == j.n_units
        assert t.total_param_count() == j.total_param_count()
        assert t.active_param_count() == j.active_param_count()
        assert t.unit_flops_fwd(t.n_units - 1, 2, 2048) == j.unit_flops_fwd(j.n_units - 1, 2, 2048)


def test_registry_matches_jax_and_names_roadmap_for_the_rest():
    """Every id resolves to JAX's configs: the dense, MoE, SSM, hybrid and
    VLM ids, and since A14.5 the audio id (whisper-large-v3) too; an
    unknown id raises ``KeyError`` in both packages."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS:
        for get in ("get_spec", "get_reduced"):
            t, j = getattr(tconfigs, get)(arch), getattr(jconfigs, get)(arch)
            assert (t.name, t.family, t.n_units) == (j.name, j.family, j.n_units)
    for get in (tconfigs.get_spec, jconfigs.get_spec):
        with pytest.raises(KeyError, match="unknown arch"):
            get("whisper-tiny")
    for get in ("get_spec", "get_reduced"):
        t, j = getattr(tconfigs, get)("paligemma-3b"), getattr(jconfigs, get)("paligemma-3b")
        assert (t.family, t.prefix_len, t.hd, t.num_kv_heads) == (j.family, j.prefix_len, j.hd,
                                                                 j.num_kv_heads)
    assert tconfigs.get_spec("vgg16-cifar10").name == "vgg16-cifar10"
    with pytest.raises(KeyError):
        tconfigs.get_spec("gpt-5")


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 256, 4, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), rtol=1e-6, atol=1e-6)
    pos = np.arange(256)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy(),
            np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)), atol=2e-6)


@pytest.mark.parametrize("arch,window", [("smollm-135m", 0), ("qwen2-1.5b", 128),
                                         ("qwen3-32b", 0)])
def test_attention_and_mlp_match_jax(arch, window):
    jspec = jconfigs.get_reduced(arch).with_window(window)
    tspec = tconfigs.get_reduced(arch).with_window(window)
    p = _perturbed_init(jspec)
    unit0 = jax.tree.map(lambda a: a[0], p["units"])
    x = np.random.default_rng(2).normal(size=(2, 256, jspec.d_model)).astype(np.float32)
    ja, _ = JL.attention(jax.tree.map(jnp.asarray, unit0["attn"]), jnp.asarray(x), jspec)
    ta, cache = L.attention(params_from_numpy(unit0["attn"], CPU), torch.from_numpy(x), tspec)
    assert cache is None
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **MODEL_TOL)
    jm = JL.mlp(jax.tree.map(jnp.asarray, unit0["mlp"]), jnp.asarray(x))
    tm = L.mlp(params_from_numpy(unit0["mlp"], CPU), torch.from_numpy(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **MODEL_TOL)
    # the GELU variant (no w3): jax.nn.gelu's tanh approximation
    gelu = {k: v for k, v in unit0["mlp"].items() if k != "w3"}
    np.testing.assert_allclose(
        L.mlp(params_from_numpy(gelu, CPU), torch.from_numpy(x)).numpy(),
        np.asarray(JL.mlp(jax.tree.map(jnp.asarray, gelu), jnp.asarray(x))), **MODEL_TOL)


def test_unported_layer_paths_raise_naming_a14():
    spec = tconfigs.get_reduced("smollm-135m")
    p = SplittableModel(spec).init_params(torch.Generator().manual_seed(0), CPU)
    attn = {k: v[0] for k, v in p["units"]["attn"].items()}
    x = torch.zeros(1, 4, spec.d_model)
    # the prefix-LM mask (A14.4) is ported: it is JAX's _mask_bias rule
    # (tests/test_torch_vlm.py holds it against JAX)
    out, _ = L.attention(attn, torch.randn(1, 4, spec.d_model), spec, prefix_len=2)
    assert out.shape == (1, 4, spec.d_model) and bool(torch.isfinite(out).all())
    # cross-attention and bidirectional attention (A14.5) are ported
    # (tests/test_torch_audio.py holds them against JAX)
    kv = torch.randn(1, 6, spec.num_kv_heads, spec.hd)
    for kw in (dict(kv_override=(kv, kv)), dict(causal=False)):
        out, _ = L.attention(attn, torch.randn(1, 4, spec.d_model), spec, **kw)
        assert out.shape == (1, 4, spec.d_model) and bool(torch.isfinite(out).all())
    # the decode cache (A14.3) is ported: it takes one token a step, and
    # positions other than 0..S-1 only with a cache
    with pytest.raises(ValueError, match="one token a step"):
        L.attention(attn, x, spec, cache=L.init_attn_cache(spec, 1, 8, CPU))
    with pytest.raises(ValueError, match="need a cache"):
        L.attention(attn, x, spec, positions=torch.arange(4) + 1)
    # unit rematerialisation (A14.6) is ported (tests/test_torch_remat.py
    # holds it against the model without it and against JAX)
    assert SplittableModel(dataclasses.replace(spec, remat=True)).spec.remat
    assert build_model(dataclasses.replace(spec, family="vlm", prefix_len=2)).prefix_len == 2
    audio = dataclasses.replace(spec, family="audio", encoder_layers=2, encoder_len=8)
    assert build_model(audio).spec.n_units == spec.num_layers + 2  # A14.5: enc ++ dec
    # the MoE family builds now (tests/test_torch_zoo.py holds it against JAX)
    assert build_model(dataclasses.replace(spec, family="moe", moe=MoeSpec(4, 2))).moe_groups == 1
    with pytest.raises(TypeError):
        build_model(jconfigs.get_reduced("smollm-135m"))  # the JAX package's spec


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


def test_init_params_is_the_jax_tree_stacked():
    for arch in DENSE:
        spec = tconfigs.get_reduced(arch)
        p = SplittableModel(spec).init_params(torch.Generator().manual_seed(0), CPU)
        j = params_to_numpy(JaxModel(jconfigs.get_reduced(arch)).init_params(
            jax.random.PRNGKey(0)))
        got, ref = _flat(p), _flat(j)
        assert got.keys() == ref.keys(), arch
        for k in got:
            assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        assert p["units"]["attn"]["wq"].shape[0] == spec.n_units
        q = SplittableModel(spec).init_params(torch.Generator().manual_seed(0), CPU)
        assert all(np.array_equal(a, b) for a, b in zip(_flat(p).values(), _flat(q).values()))


MODEL_CASES = [("smollm-135m", 0, 256), ("smollm-135m", 128, 256), ("smollm-135m", 0, 64),
               ("qwen2-1.5b", 0, 256), ("qwen2-1.5b", 0, 64), ("qwen2.5-14b", 0, 256),
               ("qwen3-32b", 0, 256), ("qwen3-32b", 128, 64)]


@pytest.mark.parametrize("arch,window,S", MODEL_CASES)
def test_model_logits_loss_and_grads_match_jax(arch, window, S):
    jspec = jconfigs.get_reduced(arch).with_window(window)
    jm, tm = JaxModel(jspec), SplittableModel(tconfigs.get_reduced(arch).with_window(window))
    p = _perturbed_init(jspec)
    batch = _tokens(jspec.vocab_size, (2, S), seed=S + window)
    jb = jax.tree.map(jnp.asarray, batch)
    jp = jax.tree.map(jnp.asarray, p)
    jlogits, _ = jm.forward(jp, jb)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jp, jb)
    tp = params_from_numpy(p, CPU)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits, aux = tm.forward(tp, tb)
    assert float(aux) == 0.0
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), **MODEL_TOL)
    np.testing.assert_allclose(float(tm.loss_fn(tp, tb)), float(jloss), rtol=1e-5)
    tg, jg = _flat(grad(tm.loss_fn)(tp, tb)), _flat(params_to_numpy(jgrads))
    assert tg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **MODEL_TOL)


def test_apply_units_in_pieces_equals_the_whole():
    spec = tconfigs.get_reduced("qwen2-1.5b")
    m = SplittableModel(spec)
    p = params_from_numpy(_perturbed_init(jconfigs.get_reduced("qwen2-1.5b")), CPU)
    tb = {k: torch.from_numpy(v) for k, v in _tokens(spec.vocab_size, (2, 64), 3).items()}
    carry = m.frontend_apply(p["frontend"], tb)
    whole = m.apply_units(p["units"], carry, 0, 2)
    parts = m.apply_units(p["units"], m.apply_units(p["units"], carry, 0, 1), 1, 2)
    assert m.apply_units(p["units"], carry, 1, 1) is carry
    torch.testing.assert_close(parts["h"], whole["h"], rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# Engine A end to end
# --------------------------------------------------------------------------- #

N, B, S, ROUNDS = 4, 2, 64, 4
CUTS, INTERVALS, ENTITIES = (1, 1), (2, 2, 1), (4, 2, 1)
# Adam's step is lr·m̂/(√v̂ + eps): a gradient element within ~eps of zero
# turns an f32 rounding difference δ of the gradient into an update
# difference of up to lr·δ/eps.  At eps 1e-8 that is 1e-5 on a few
# embedding elements whose gradient cancels to ~5e-9; eps 1e-4 keeps the
# comparison about the engine (ROADMAP §C).
OPTS = {"sgd": (jsgd, sgd), "adam": (lambda lr: jadam(lr, eps=1e-4),
                                     lambda lr: adam(lr, eps=1e-4))}


def _lm_batches(vocab, seed=0):
    return [_tokens(vocab, (N, B, S), seed + r) for r in range(ROUNDS)]


@pytest.mark.parametrize("arch,opt_name", [("smollm-135m", "sgd"), ("smollm-135m", "adam"),
                                           ("qwen3-32b", "sgd")])
def test_engine_a_matches_jax(arch, opt_name):
    """REDUCED model, N=4, J2=2, batch 2, S=64, cuts (1, 1), intervals
    (2, 2, 1), 4 rounds through the per-round-type dispatch on both sides:
    losses to rtol 1e-4, params to atol 1e-5."""
    jspec, tspec = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    lr = 0.05 if opt_name == "sgd" else 1e-3
    jopt, topt = (make(lr) for make in OPTS[opt_name])
    jmodel = JaxModel(jspec)
    plan = jax_default_plan(jspec.n_units, N, cuts=CUTS, intervals=INTERVALS,
                            entities=ENTITIES)
    state = jax_init(jmodel, plan, jopt, jax.random.PRNGKey(0))
    init = params_to_numpy(state.params)
    batches = _lm_batches(jspec.vocab_size)
    cache, jl = {}, []
    for r, batch in enumerate(batches):
        fed = tuple((r + 1) % I == 0 if I > 1 else True for I in plan.intervals)
        if fed not in cache:
            cache[fed] = jax.jit(jax_build_step(jmodel, plan, jopt, fed_round=fed,
                                                sync_opt_state=opt_name == "adam"))
        state, loss = cache[fed](state, jax.tree.map(jnp.asarray, batch))
        jl.append(float(loss))
    jp = params_to_numpy(state.params)

    tplan = default_plan(tspec.n_units, N, cuts=CUTS, intervals=INTERVALS,
                         entities=ENTITIES)
    tmodel = SplittableModel(tspec)
    params = params_from_numpy(init, CPU)
    tstate = TrainState(params, topt.init(params), 0)
    cache, tl = {}, []
    for r, batch in enumerate(batches):
        fed = tuple((r + 1) % I == 0 if I > 1 else True for I in tplan.intervals)
        if fed not in cache:
            cache[fed] = build_train_step_a(tmodel, tplan, topt, fed_round=fed,
                                            sync_opt_state=opt_name == "adam")
        tstate, loss = cache[fed](tstate, train.to_device(batch, CPU))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    got, ref = _flat(tstate.params), _flat(jp)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)
    # the top tier (unit 1 and the head) is synced every round
    head = tstate.params["head"]["norm"]
    assert torch.equal(head, head[:1].expand_as(head))


def test_init_state_a_replicates_the_stacked_tree():
    spec = tconfigs.get_reduced("smollm-135m")
    plan = default_plan(spec.n_units, N, cuts=CUTS, intervals=INTERVALS, entities=ENTITIES)
    from repro_torch.core import replicate_for_clients, unreplicate
    state = init_state_a(SplittableModel(spec), plan, sgd(0.1),
                         torch.Generator().manual_seed(0), CPU)
    wq = state.params["units"]["attn"]["wq"]
    assert wq.shape == (N, spec.n_units, spec.d_model, spec.num_heads * spec.hd)
    assert wq.is_contiguous() and torch.equal(wq, wq[:1].expand_as(wq))
    again = replicate_for_clients(unreplicate(state.params), N)
    assert all(np.array_equal(a, b) for a, b in zip(_flat(again).values(),
                                                    _flat(state.params).values()))


def test_train_main_runs_a_dense_arch_on_cpu(tmp_path, capsys):
    ckpt = tmp_path / "lm.npz"
    rc = train.main(["--device", "cpu", "--arch", "smollm-135m", "--rounds", "2",
                     "--clients", "4", "--edges", "2", "--batch", "2", "--log-every", "1",
                     "--checkpoint", str(ckpt)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=smollm-135m units=2" in out
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.startswith("round")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    from repro.checkpoint import load_checkpoint as jax_load
    from repro.core.engine import replicate_for_clients as jax_replicate
    template = jax_replicate(JaxModel(jconfigs.get_reduced("smollm-135m")).init_params(
        jax.random.PRNGKey(1)), 4)
    tree, step, meta = jax_load(str(ckpt), template)
    assert step == 2 and np.asarray(tree["units"]["attn"]["wq"]).shape[:2] == (4, 2)
    # the VLM exits as the JAX CLI does (its LM stream has no image prefix)
    with pytest.raises(SystemExit, match="frontend is a stub"):
        train.main(["--device", "cpu", "--arch", "paligemma-3b", "--rounds", "1"])
