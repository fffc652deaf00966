"""The port's per-class (ragged) sync against the JAX package: B3's and its
twin's plain versions, ``class_tier_members``, ``ragged_synchronize`` and
Engine A with ``class_members``, from the same numpy inputs on both sides.

On the CPU the wrappers run their plain versions; the CUDA kernels are held
against those on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.compress import Int8Stochastic as JaxInt8, TopK as JaxTopK
from repro.configs.vgg16_cifar10 import REDUCED as JAX_REDUCED
from repro.core import build_train_step_a as jax_build_step, init_state_a as jax_init
from repro.core.tiers import (
    _ragged_units_mean as jax_ragged_units_mean,
    class_tier_members as jax_class_tier_members,
    default_plan as jax_default_plan,
    ragged_synchronize as jax_ragged_synchronize,
)
from repro.kernels.tiered_aggregate.ops import (
    ragged_tiered_aggregate_q8 as jax_ragged_q8,
)
from repro.kernels.tiered_aggregate.ref import (
    ragged_quantized_tiered_aggregate_ref as jax_b3_ref,
)
from repro.models.model import SplittableModel as JaxModel
from repro.models.vgg import VggModel as JaxVgg
from repro.optim import adam as jadam, momentum as jmomentum, sgd as jsgd
from repro_torch.compress import Identity, Int8Stochastic, TopK
from repro_torch.compress.quantize import q8_quantize
from repro_torch.configs.vgg16_cifar10 import REDUCED
from repro_torch.core import (
    TrainState, build_train_step_a, class_tier_members, default_plan,
    ragged_synchronize, synchronize,
)
from repro_torch.kernels.tiered_aggregate import (
    launches, ragged_aggregate_tree, ragged_quantized_tiered_aggregate,
    ragged_tiered_aggregate, ragged_tiered_aggregate_q8, reset_launches,
)
from repro_torch.launch import train
from repro_torch.models import VggModel, params_from_numpy, params_to_numpy
from repro_torch.optim import adam, momentum, sgd

CPU = torch.device("cpu")
FLAGS = [(0, 0), (0, 1), (1, 0), (1, 1)]
# (N, J, P, tile): the JAX package's ragged-kernel test shapes
B3_SHAPES = [(20, 5, 999, 128), (6, 2, 257, 128), (16, 4, 2048, 256)]
# B3's plain version and the JAX oracle sum in different orders; the JAX
# Pallas interpret output is itself 1-3 f32 ulp off its oracle on this tree
ULP = dict(rtol=1e-6, atol=1e-7)
SYNC = dict(rtol=1e-5, atol=1e-6)


def _member_patterns(N, J):
    """All ones, alternating, an entity group with no member, none."""
    per = N // J
    empty_group = np.ones(N, np.float32)
    empty_group[:per] = 0.0
    return {
        "ones": np.ones(N, np.float32),
        "mixed": (np.arange(N) % 2).astype(np.float32),
        "empty-group": empty_group,
        "none": np.zeros(N, np.float32),
    }


@pytest.mark.parametrize("pattern", ["ones", "mixed", "empty-group", "none"])
@pytest.mark.parametrize("N,J,P,tile", B3_SHAPES)
def test_b3_plain_matches_jax_oracle(N, J, P, tile, pattern):
    rng = np.random.default_rng(N * P)
    x = rng.normal(size=(N, P)).astype(np.float32)
    e = np.exp(rng.normal(size=N))
    w = (e / e.sum()).astype(np.float32)
    member = _member_patterns(N, J)[pattern]
    q, s = q8_quantize(torch.from_numpy(x), tile)
    for de, dg in FLAGS:
        got = ragged_quantized_tiered_aggregate(
            q, s, torch.from_numpy(w), torch.from_numpy(member), de, dg, J, tile)
        ref = jax_b3_ref(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), jnp.asarray(w),
                         jnp.asarray(member), jnp.array(bool(de)), jnp.array(bool(dg)),
                         J, tile)
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ULP,
                                   err_msg=f"{pattern} de={de} dg={dg}")


@pytest.mark.parametrize("N,J,P,tile", B3_SHAPES)
def test_b3_quantize_and_aggregate_matches_jax_ops(N, J, P, tile):
    """The wrapper that quantizes first: key-less int8 is bit-identical in
    both packages, so the results agree to B3's ulp tolerance."""
    rng = np.random.default_rng(P)
    x = rng.normal(size=(N, P)).astype(np.float32)
    w = np.full(N, 1.0 / N, np.float32)
    member = _member_patterns(N, J)["mixed"]
    for de, dg in FLAGS:
        got = ragged_tiered_aggregate_q8(torch.from_numpy(x), torch.from_numpy(w),
                                         torch.from_numpy(member), de, dg, J, tile)
        ref = jax_ragged_q8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(member),
                            jnp.array(bool(de)), jnp.array(bool(dg)), J, tile,
                            use_pallas=False)
        assert got.shape == (N, P)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ULP)


def _jax_levels(x, member, groups, do_entity, do_global):
    """The JAX ragged levels of one [N, P] unit: the entity level over
    ``groups``, then the one-group fed level, each ``_ragged_units_mean``."""
    xs, mem = [jnp.asarray(x)], jnp.asarray(member)[:, None]
    if do_entity:
        xs = jax_ragged_units_mean(xs, xs, mem, groups, None)
    if do_global:
        xs = jax_ragged_units_mean(xs, xs, mem, 1, None)
    return np.asarray(xs[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", ["ones", "mixed", "empty-group", "none"])
@pytest.mark.parametrize("N,J,P", [(8, 4, 700), (20, 5, 2049), (6, 2, 257)])
def test_twin_plain_matches_jax_ragged_units_mean(N, J, P, pattern, dtype):
    """The twin with fed weights 1 is the two JAX levels fused: the fed mean
    of identical entity means rounds apart by a few ulp."""
    rng = np.random.default_rng(P + N)
    x = rng.normal(size=(N, P)).astype(np.float32)
    member = _member_patterns(N, J)[pattern]
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for de, dg in FLAGS:
        out = ragged_tiered_aggregate(xt, torch.ones(N), torch.from_numpy(member),
                                      de, dg, J)
        assert out.dtype == xt.dtype and out.shape == (N, P)
        ref = _jax_levels(xt.float().numpy(), member, J, de, dg)
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), ref, **SYNC)
        else:  # one bf16 ulp beyond the f32 tolerance
            _, exp = np.frexp(ref)
            ulp = np.ldexp(np.ones_like(ref), exp - 8)
            err = np.abs(out.float().numpy() - ref)
            assert (err <= ulp + 1e-6 + 1e-5 * np.abs(ref)).all()
        # non-members keep their value bit for bit
        keep = member == 0
        assert torch.equal(out[torch.from_numpy(keep)], xt[torch.from_numpy(keep)])


def test_stacked_member_matrix_matches_per_unit_launches():
    """A [N, U] member over a [N, U·E] row equals U launches of [N] members
    on the unit slices (the twin, to the order of its sums); B3 over the
    whole row tiles each client row whole, as the JAX codec tiles a
    flattened stacked leaf."""
    rng = np.random.default_rng(5)
    N, J, U, E = 8, 4, 5, 37
    x = torch.from_numpy(rng.normal(size=(N, U * E)).astype(np.float32))
    member = torch.from_numpy((rng.random((N, U)) > 0.4).astype(np.float32))
    member[:, 2] = 0.0
    w = torch.ones(N)
    for de, dg in FLAGS:
        whole = ragged_tiered_aggregate(x, w, member, de, dg, J)
        for u in range(U):
            part = ragged_tiered_aggregate(x[:, u * E:(u + 1) * E].contiguous(), w,
                                           member[:, u].contiguous(), de, dg, J)
            torch.testing.assert_close(whole[:, u * E:(u + 1) * E], part, **ULP)
        q8 = ragged_tiered_aggregate_q8(x, w, member, de, dg, J, 128)
        ref = jax_ragged_q8(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                            jnp.ones(N), jnp.array(bool(de)), jnp.array(bool(dg)), J, 128,
                            use_pallas=False)
        # units held by every client agree with the all-member JAX wrapper
        full = [u for u in range(U) if bool(member[:, u].all())]
        for u in full:
            np.testing.assert_allclose(q8[:, u * E:(u + 1) * E].numpy(),
                                       np.asarray(ref)[:, u * E:(u + 1) * E], **ULP)


def test_member_validation():
    x, w = torch.zeros(4, 12), torch.ones(4)
    with pytest.raises(ValueError, match="member"):
        ragged_tiered_aggregate(x, w, torch.ones(3), 1, 1, 2)
    with pytest.raises(ValueError, match="member"):
        ragged_tiered_aggregate(x, w, torch.ones(4, dtype=torch.float64), 1, 1, 2)
    with pytest.raises(ValueError, match="divide"):
        ragged_tiered_aggregate(x, w, torch.ones(4, 5), 1, 1, 2)


# --------------------------------------------------------------------------- #
# class_tier_members and ragged_synchronize
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("class_cuts,class_of", [
    ([(3, 4), (1, 2)], [0, 1] * 4),
    ([(3, 3), (1, 2)], [0, 0, 1, 1, 0, 1, 1, 0]),
    ([(0, 5), (2, 2), (1, 4)], [2, 1, 0, 1, 2, 0, 0, 1]),
])
def test_class_tier_members_match_jax(class_cuts, class_of):
    got = class_tier_members(5, class_cuts, class_of, CPU)
    ref = jax_class_tier_members(5, class_cuts, class_of)
    assert len(got) == len(ref)
    for m, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.float32 and g.device == CPU
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(got.host[m], np.asarray(r) > 0)
        assert torch.equal(got.columns[m], g.t())
    np.testing.assert_array_equal(sum(g.numpy() for g in got), np.ones((8, 5)))


def test_class_tier_members_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        class_tier_members(5, [(1, 3)], [0, 0])


def _vgg_tree(N, seed):
    """A client-stacked REDUCED-VGG-shaped tree of random values."""
    rng = np.random.default_rng(seed)
    shapes = [((3, 3, 3, 16), 16), ((3, 3, 16, 16), 16), ((3, 3, 16, 32), 32),
              ((512, 64), 64), ((64, 10), 10)]
    units = [{"w": rng.normal(size=(N, *ws)).astype(np.float32),
              "b": rng.normal(size=(N, bs)).astype(np.float32)} for ws, bs in shapes]
    return {"frontend": {}, "units": units, "head": {}}


_SMOLLM_SHAPES = {}


def _smollm_tree(N, seed):
    """REDUCED smollm-135m's stacked tree (the JAX init's shapes), random
    per client, with a frontend and a head."""
    if not _SMOLLM_SHAPES:
        _SMOLLM_SHAPES["tree"] = params_to_numpy(JaxModel(
            jconfigs.get_reduced("smollm-135m")).init_params(jax.random.PRNGKey(0)))
    p = _SMOLLM_SHAPES["tree"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: rng.normal(size=(N,) + x.shape).astype(np.float32), p)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, prefix + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, prefix + (str(i),)).items()}
    if isinstance(tree, torch.Tensor):
        return {"/".join(prefix): tree.numpy()}
    return {"/".join(prefix): np.asarray(tree)}


CODECS = {
    None: (None, None),
    "int8": (JaxInt8(tile=128), Int8Stochastic(128)),
    "topk": (JaxTopK(0.3), TopK(0.3)),
}


def _jitted_jax_sync(plan, members, jc):
    """The JAX ragged sync, jitted once over (params, step) for the codec."""
    compress_fn = None
    if jc is not None:
        compress_fn = lambda x: jax.vmap(lambda v: jc.transform(v))(x)  # noqa: E731
    return jax.jit(lambda p, step: jax_ragged_synchronize(
        p, plan, members, step, compress_fn=compress_fn))


def _tolerance(codec, x):
    """int8: an f32 entity mean that rounds differently may flip a value by
    one quantization step (max|x|/127); else the f32 sync tolerance."""
    if codec == "int8":
        return dict(rtol=1e-5, atol=float(np.abs(x).max()) / 127.0)
    return SYNC


@pytest.mark.parametrize("codec", [None, "int8", "topk"])
@pytest.mark.parametrize("class_cuts", [((3, 4), (1, 2)), ((3, 3), (1, 2))],
                         ids=["mixed", "empty-tier"])
def test_ragged_synchronize_vgg_matches_jax(class_cuts, codec):
    """REDUCED VGG (5 per-unit leaves), N=8, J2=4, intervals (2, 3, 1),
    steps 0-5 (every combination of fed levels); ((3, 3), (1, 2)) leaves
    class 0 without a tier-1 unit."""
    N = 8
    class_of = [0, 1] * 4
    plan = default_plan(5, N, cuts=class_cuts[0], intervals=(2, 3, 1), entities=(N, 4, 1))
    jc, tc = CODECS[codec]
    jm = jax_class_tier_members(5, class_cuts, class_of)
    tm = class_tier_members(5, class_cuts, class_of, CPU)
    jax_sync = _jitted_jax_sync(plan, jm, jc)
    for step in range(6):
        np_tree = _vgg_tree(N, seed=step)
        ref = jax_sync(jax.tree.map(jnp.asarray, np_tree), jnp.int32(step))
        got = ragged_synchronize(params_from_numpy(np_tree, CPU), plan, tm, step,
                                 compressor=tc)
        g, r = _flat(got), _flat(ref)
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_allclose(g[k], r[k], **_tolerance(codec, r[k]),
                                       err_msg=f"step {step} {k}")


@pytest.mark.parametrize("codec", [None, "int8", "topk"])
def test_ragged_synchronize_stacked_smollm_matches_jax(codec):
    """REDUCED smollm-135m's stacked tree [N, U, ...]: one launch per leaf
    and tier with the [N, U] member; the frontend joins tier 0 and the head
    the top tier, over every client."""
    N = 4
    spec = jconfigs.get_reduced("smollm-135m")
    U = spec.n_units
    class_cuts, class_of = [(0, 1), (1, 1)], [0, 1, 1, 0]
    plan = default_plan(U, N, cuts=class_cuts[0], intervals=(2, 2, 1), entities=(N, 2, 1))
    jc, tc = CODECS[codec]
    jm = jax_class_tier_members(U, class_cuts, class_of)
    tm = class_tier_members(U, class_cuts, class_of, CPU)
    jax_sync = _jitted_jax_sync(plan, jm, jc)
    for step in range(6):
        np_tree = _smollm_tree(N, seed=10 + step)
        ref = jax_sync(jax.tree.map(jnp.asarray, np_tree), jnp.int32(step))
        got = ragged_synchronize(params_from_numpy(np_tree, CPU), plan, tm, step,
                                 compressor=tc)
        g, r = _flat(got), _flat(ref)
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_allclose(g[k], r[k], **_tolerance(codec, r[k]),
                                       err_msg=f"step {step} {k}")


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_non_members_keep_their_pre_compression_replica(codec):
    """On a compressed fed level the mean reaches members only: every other
    client's replica of the unit is its input, bit for bit, not the codec's
    output (the JAX ``keep`` tree)."""
    N = 8
    # tier 0 holds units 0-2 for class 0 and unit 0 for class 1; class 1
    # holds units 1-2 in tier 1, which has no entity level (J = N) and whose
    # fed level is skipped, and nobody holds a unit in the top tier
    class_cuts, class_of = [(3, 5), (1, 5)], [0, 1] * 4
    plan = default_plan(5, N, cuts=(3, 5), intervals=(2, 2, 1), entities=(N, N, 1))
    tm = class_tier_members(5, class_cuts, class_of, CPU)
    tree = params_from_numpy(_vgg_tree(N, seed=3), CPU)
    _, tc = CODECS[codec]
    out = ragged_synchronize(tree, plan, tm, 1, fed_round=(True, False, True),
                             compressor=tc)
    for u in range(3):
        col = torch.from_numpy(tm.host[0][:, u])
        assert int(col.sum()) == (8 if u == 0 else 4)
        for k in ("w", "b"):
            a, x = out["units"][u][k], tree["units"][u][k]
            assert torch.equal(a[~col], x[~col])
            # members took one mean of the lossy uploads
            assert torch.equal(a[col], a[col][:1].expand_as(a[col]))
            assert not torch.equal(a[col], x[col])


def test_per_member_set_replicas_agree_after_a_full_cycle():
    """After a round where every fed level runs, the clients whose class
    holds unit u in tier m hold one value; clients holding u in different
    tiers need not agree."""
    N = 8
    class_cuts, class_of = [(3, 4), (1, 2)], [0, 1] * 4
    plan = default_plan(5, N, cuts=(3, 4), intervals=(2, 3, 1), entities=(N, 4, 1))
    tm = class_tier_members(5, class_cuts, class_of, CPU)
    out = ragged_synchronize(params_from_numpy(_vgg_tree(N, seed=4), CPU), plan, tm, 5)
    split = 0
    for u in range(5):
        rows = {m: np.flatnonzero(tm.host[m][:, u]) for m in range(3)}
        for k in ("w", "b"):
            x = out["units"][u][k]
            for m, idx in rows.items():
                if len(idx):
                    assert torch.equal(x[idx], x[idx[:1]].expand_as(x[idx]))
            held = [m for m in rows if len(rows[m])]
            split += len(held) > 1 and not torch.equal(x[rows[held[0]][0]],
                                                      x[rows[held[1]][0]])
    assert split > 0


@pytest.mark.parametrize("step", range(4))
@pytest.mark.parametrize("codec", [None, "int8", "identity"])
def test_identical_classes_collapse_onto_synchronize(step, codec):
    """Same cuts in every class: the member matrices are the plan's tier
    slices and the ragged sync equals ``synchronize`` to f32 rounding.  B1
    sums w·y with w = 1/N where the twin divides Σ y by N, so the two are
    held at the sync's tolerance, not bit for bit (JAX collapses exactly)."""
    N = 8
    plan = default_plan(5, N, cuts=(2, 4), intervals=(1, 2, 1), entities=(N, 4, 1))
    tm = class_tier_members(5, [(2, 4)] * 2, [i % 2 for i in range(N)], CPU)
    comp = {None: None, "int8": Int8Stochastic(128), "identity": Identity()}[codec]
    tree = _vgg_tree(N, seed=20 + step)
    dense = synchronize(params_from_numpy(tree, CPU), plan, step, compressor=comp)
    ragged = ragged_synchronize(params_from_numpy(tree, CPU), plan, tm, step,
                                compressor=comp)
    d, r = _flat(dense), _flat(ragged)
    for k in d:
        np.testing.assert_allclose(r[k], d[k], **_tolerance(codec, d[k]), err_msg=k)


def test_ragged_launches_follow_the_host_tables():
    """On the CPU the plain versions run and no launch is counted; the
    (unit, tier) pairs that no client holds are left as they are."""
    N = 8
    plan = default_plan(5, N, cuts=(3, 4), intervals=(2, 3, 1), entities=(N, 4, 1))
    tm = class_tier_members(5, [(3, 4), (3, 4)], [0, 1] * 4, CPU)
    tree = params_from_numpy(_vgg_tree(N, seed=6), CPU)
    reset_launches()
    out = ragged_synchronize(tree, plan, tm, 0)
    assert launches == dict.fromkeys(launches, 0)
    # round 1: tier 0 (units 0-2) has no level that runs, so it is kept
    for u in range(3):
        assert out["units"][u]["w"] is tree["units"][u]["w"]


def test_ragged_aggregate_tree_skips_empty_leaves():
    tree = {"a": torch.zeros(4, 0), "b": torch.randn(4, 3)}
    out = ragged_aggregate_tree(tree, torch.ones(4), torch.ones(4), 1, 1, 2)
    assert out["a"] is tree["a"]
    assert torch.allclose(out["b"], tree["b"].mean(0, keepdim=True).expand(4, 3))


def test_ragged_synchronize_refusals():
    N = 4
    plan = default_plan(5, N, cuts=(1, 3), intervals=(2, 2, 1), entities=(N, 2, 1))
    tm = class_tier_members(5, [(1, 3)], [0] * N, CPU)
    tree = params_from_numpy(_vgg_tree(N, seed=2), CPU)
    with pytest.raises(ValueError, match="one member matrix per tier"):
        ragged_synchronize(tree, plan, tm[:2], 0)
    audio = {"frontend": {}, "units": {"enc": {}, "dec": {}}, "head": {}}
    with pytest.raises(NotImplementedError, match="enc/dec"):
        ragged_synchronize(audio, plan, tm, 0)


def test_plain_member_tensors_are_accepted():
    """A plain list of member tensors (the JAX return type) works: its host
    tables are read from it once."""
    N = 8
    plan = default_plan(5, N, cuts=(3, 4), intervals=(2, 3, 1), entities=(N, 4, 1))
    tm = class_tier_members(5, [(3, 4), (1, 2)], [0, 1] * 4, CPU)
    tree = _vgg_tree(N, seed=8)
    a = ragged_synchronize(params_from_numpy(tree, CPU), plan, tm, 5)
    b = ragged_synchronize(params_from_numpy(tree, CPU), plan, list(tm), 5)
    for k, v in _flat(a).items():
        np.testing.assert_array_equal(_flat(b)[k], v)


# --------------------------------------------------------------------------- #
# Engine A with class_members
# --------------------------------------------------------------------------- #

N_ENG, B_ENG, ROUNDS = 8, 2, 6
CLASS_CUTS, CLASS_OF = [(3, 4), (1, 2)], [0, 1] * 4
INTERVALS, ENTITIES = (3, 2, 1), (8, 4, 1)
OPTS = {"sgd": (jsgd, sgd), "momentum": (jmomentum, momentum), "adam": (jadam, adam)}


def _batches():
    rng = np.random.default_rng(0)
    hw = REDUCED.image_size
    return [{"images": rng.normal(size=(N_ENG, B_ENG, hw, hw, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (N_ENG, B_ENG)).astype(np.int32)}
            for _ in range(ROUNDS)]


def _fed(plan, r):
    return tuple((r + 1) % I == 0 if I > 1 else True for I in plan.intervals)


def _run_engines(opt_name, codec):
    lr = 1e-3 if opt_name == "adam" else 0.05
    sync_opt_state = opt_name != "sgd"
    jc, tc = CODECS[codec]
    jmodel = JaxVgg(JAX_REDUCED)
    jplan = jax_default_plan(REDUCED.n_units, N_ENG, cuts=CLASS_CUTS[0],
                             intervals=INTERVALS, entities=ENTITIES)
    jopt = OPTS[opt_name][0](lr)
    jm = jax_class_tier_members(REDUCED.n_units, CLASS_CUTS, CLASS_OF)
    state = jax_init(jmodel, jplan, jopt, jax.random.PRNGKey(0))
    init = params_to_numpy(state.params)
    cache, jl = {}, []
    for r, batch in enumerate(_batches()):
        fed = _fed(jplan, r)
        if fed not in cache:
            cache[fed] = jax.jit(jax_build_step(
                jmodel, jplan, jopt, fed_round=fed, sync_opt_state=sync_opt_state,
                compressor=jc, class_members=jm))
        state, loss = cache[fed](state, jax.tree.map(jnp.asarray, batch))
        jl.append(float(loss))
    jp = params_to_numpy(state.params)

    plan = default_plan(REDUCED.n_units, N_ENG, cuts=CLASS_CUTS[0], intervals=INTERVALS,
                        entities=ENTITIES)
    topt = OPTS[opt_name][1](lr)
    tm = class_tier_members(REDUCED.n_units, CLASS_CUTS, CLASS_OF, CPU)
    params = params_from_numpy(init, CPU)
    tstate = TrainState(params, topt.init(params), 0)
    cache, tl = {}, []
    for r, batch in enumerate(_batches()):
        fed = _fed(plan, r)
        if fed not in cache:
            cache[fed] = build_train_step_a(
                VggModel(REDUCED), plan, topt, fed_round=fed,
                sync_opt_state=sync_opt_state, compressor=tc, class_members=tm)
        tstate, loss = cache[fed](tstate, train.to_device(batch, CPU))
        tl.append(float(loss))
    return jl, jp, tl, params_to_numpy(tstate.params)


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adam"])
def test_engine_a_class_members_matches_jax(opt_name):
    """REDUCED VGG, N=8, J2=4, batch 2, class cuts ((3, 4), (1, 2)),
    intervals (3, 2, 1), 6 rounds (one full cycle); momentum and Adam
    sync their moments ragged too.  Losses rtol 1e-4, params atol 1e-5."""
    jl, jp, tl, tp = _run_engines(opt_name, None)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    g, r = _flat(tp), _flat(jp)
    for k in r:
        np.testing.assert_allclose(g[k], r[k], atol=1e-5, err_msg=k)


def test_engine_a_class_members_int8_wire_matches_jax():
    """The int8 fed wire through B3's plain version: a sum that rounds
    differently can flip one quantized value by one step."""
    jl, jp, tl, tp = _run_engines("sgd", "int8")
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    g, r = _flat(tp), _flat(jp)
    for k in r:
        lsb = float(np.abs(r[k]).max()) / 127.0
        np.testing.assert_allclose(g[k], r[k], atol=lsb, err_msg=k)
