"""The port's tier plan and kernel-backed ``synchronize`` against the JAX
package's ``repro.core.tiers``."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import Int8Stochastic as JaxInt8
from repro.core.tiers import (
    TierPlan as JaxPlan, default_plan as jax_default_plan,
    synchronize as jax_synchronize, tier_subtrees as jax_tier_subtrees,
)
from repro_torch.compress import Int8Stochastic
from repro_torch.core import TierPlan, combine_tiers, default_plan, synchronize, tier_subtrees
from repro_torch.kernels.tiered_aggregate import ops
from repro_torch.models import params_from_numpy

CPU = torch.device("cpu")
BAD_PLANS = [
    dict(n_units=5, num_clients=4, cuts=(1,), intervals=(2, 2, 1), entities=(4, 2, 1)),
    dict(n_units=5, num_clients=4, cuts=(3, 1), intervals=(2, 2, 1), entities=(4, 2, 1)),
    dict(n_units=5, num_clients=4, cuts=(1, 6), intervals=(2, 2, 1), entities=(4, 2, 1)),
    dict(n_units=5, num_clients=4, cuts=(1, 3), intervals=(2, 2, 2), entities=(4, 2, 1)),
    dict(n_units=5, num_clients=4, cuts=(1, 3), intervals=(2, 2, 1), entities=(4, 1)),
    dict(n_units=5, num_clients=4, cuts=(1, 3), intervals=(2, 2, 1), entities=(4, 3, 1)),
    dict(n_units=5, num_clients=4, cuts=(1, 3), intervals=(2, 2, 1), entities=(4, 0, 1)),
]


@pytest.mark.parametrize("kw", BAD_PLANS)
def test_plan_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JaxPlan(**kw)
    with pytest.raises(ValueError) as terr:
        TierPlan(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("args", [
    (16, 20, None, None, (20, 5, 1)),   # the paper's full-width plan
    (5, 4, (1, 3), (2, 2, 1), (4, 2, 1)),
    (5, 4, (0, 5), (3, 1, 1), (4, 4, 1)),
    (7, 8, (2, 2), (1, 4, 1), (2, 8, 1)),
    (5, 1, (1, 3), (2, 2, 1), (1, 1, 1)),
])
def test_levels_and_bounds_match_jax(args):
    n_units, N, cuts, intervals, entities = args
    jp = jax_default_plan(n_units, N, cuts=cuts, intervals=intervals, entities=entities)
    tp = default_plan(n_units, N, cuts=cuts, intervals=intervals, entities=entities)
    assert (tp.cuts, tp.intervals, tp.entities) == (jp.cuts, jp.intervals, jp.entities)
    for m in range(tp.M):
        assert tp.levels(m) == jp.levels(m)
        assert tp.tier_bounds(m) == jp.tier_bounds(m)
    for u in range(n_units):
        assert tp.tier_of_unit(u) == jp.tier_of_unit(u)
    if N > 1:
        # the top tier: an entity level of one group, then the cloud level
        assert tp.levels(tp.M - 1) == [(1, 1), (1, 1)]
    pods = TierPlan(n_units, 8, (1, 3), (2, 2, 1), (8, 2, 1), pod_interval=4, num_pods=2)
    assert pods.levels(2) == JaxPlan(n_units, 8, (1, 3), (2, 2, 1), (8, 2, 1),
                                     pod_interval=4, num_pods=2).levels(2)


def _stacked_tree(N, seed):
    """A client-stacked REDUCED-VGG-shaped tree of random values."""
    rng = np.random.default_rng(seed)
    shapes = [((3, 3, 3, 16), 16), ((3, 3, 16, 16), 16), ((3, 3, 16, 32), 32),
              ((512, 64), 64), ((64, 10), 10)]
    units = [{"w": rng.normal(size=(N, *ws)).astype(np.float32),
              "b": rng.normal(size=(N, bs)).astype(np.float32)} for ws, bs in shapes]
    return {"frontend": {}, "units": units, "head": {}}


def test_tier_subtrees_round_trip():
    tree = params_from_numpy(_stacked_tree(4, 0), CPU)
    plan = default_plan(5, 4, cuts=(1, 3), intervals=(2, 2, 1), entities=(4, 2, 1))
    parts = tier_subtrees(tree, plan)
    jparts = jax_tier_subtrees(_stacked_tree(4, 0), plan)
    assert [sorted(p) for p in parts] == [sorted(p) for p in jparts]
    assert [len(p["units"]) for p in parts] == [1, 2, 2]
    back = combine_tiers(parts, tree)
    assert all(a is b for a, b in zip(back["units"], tree["units"]))
    assert back["frontend"] == {} and back["head"] == {}


@pytest.mark.parametrize("codec", [None, 128])
@pytest.mark.parametrize("fed", [False, True, None])
@pytest.mark.parametrize("step", [0, 1])
def test_synchronize_matches_jax(fed, codec, step):
    """Every tier's levels at N=8, J2=2, intervals (2, 2, 1).  With the
    codec, both quantize the same rows, but an f32 entity mean that rounds
    differently may flip one value by one quantization step (max|x|/127)."""
    N = 8
    np_tree = _stacked_tree(N, seed=step + 3)
    plan = default_plan(5, N, cuts=(1, 3), intervals=(2, 2, 1), entities=(N, 2, 1))
    compress_fn = None
    if codec:
        jc = JaxInt8(tile=codec)
        compress_fn = lambda x: jax.vmap(lambda v: jc.transform(v))(x)  # noqa: E731
    ref = jax_synchronize(jax.tree.map(jnp.asarray, np_tree), plan, jnp.int32(step),
                          fed_round=fed, compress_fn=compress_fn)
    got = synchronize(params_from_numpy(np_tree, CPU), plan, step, fed_round=fed,
                      compressor=Int8Stochastic(codec) if codec else None)
    assert got["frontend"] == {} and got["head"] == {}
    for u, (g, r) in enumerate(zip(got["units"], ref["units"])):
        for k in ("w", "b"):
            atol = 1e-6
            if codec:
                atol = float(np.abs(np_tree["units"][u][k]).max()) / 127.0
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                       rtol=1e-5, atol=atol, err_msg=f"units/{u}/{k}")


def test_synchronize_per_tier_fed_round_and_replicas():
    """A per-tier fed_round tuple; a tier whose fed level ran holds one value
    in every client row (the kernel writes the fed mean to all rows)."""
    N = 4
    tree = params_from_numpy(_stacked_tree(N, seed=9), CPU)
    plan = default_plan(5, N, cuts=(1, 3), intervals=(2, 2, 1), entities=(N, 2, 1))
    out = synchronize(tree, plan, 0, fed_round=(False, True, True))
    assert torch.equal(out["units"][0]["w"], tree["units"][0]["w"])  # tier 0 skipped
    for u in range(1, 5):
        x = out["units"][u]["w"]
        assert torch.equal(x, x[:1].expand_as(x))


def test_sync_kernel_mapping_counts_no_plain_launches():
    """On the CPU the plain version runs and no kernel launch is counted."""
    ops.reset_launches()
    plan = default_plan(5, 4, cuts=(1, 3), intervals=(2, 2, 1), entities=(4, 2, 1))
    synchronize(params_from_numpy(_stacked_tree(4, 1), CPU), plan, 1,
                compressor=Int8Stochastic(128))
    assert ops.launches == dict.fromkeys(ops.launches, 0)
    assert set(ops.launches) == {"tiered_aggregate", "tiered_aggregate_q8",
                                 "ragged_tiered_aggregate", "ragged_tiered_aggregate_q8",
                                 "masked_tiered_aggregate", "masked_tiered_aggregate_q8",
                                 "masked_ragged_tiered_aggregate",
                                 "masked_ragged_tiered_aggregate_q8"}


def test_unported_paths_raise_naming_their_roadmap_item():
    """The audio model's two unit stacks (ROADMAP A14.5, once unported)
    are one layout enc ++ dec: synchronizing them, masked or not, equals
    JAX's sync of the same tree, with a cut inside the encoder and one
    inside the decoder."""
    N = 4
    rng = np.random.default_rng(11)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    np_tree = {"frontend": {"embed": r(N, 16, 8)},
               "units": {"enc": {"w": r(N, 2, 8, 4)}, "dec": {"w": r(N, 3, 8, 4)}},
               "head": {"norm": r(N, 8)}}
    plan = default_plan(5, N, cuts=(1, 3), intervals=(2, 2, 1), entities=(N, 2, 1))
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    for m in (None, mask):
        ref = jax_synchronize(jax.tree.map(jnp.asarray, np_tree), plan, jnp.int32(1),
                              mask=None if m is None else jnp.asarray(m))
        got = synchronize(params_from_numpy(np_tree, CPU), plan, 1,
                          mask=None if m is None else torch.from_numpy(m))
        g, r_ = _flat_tree(got), _flat_tree(ref)
        assert g.keys() == r_.keys()
        for k in r_:
            np.testing.assert_allclose(g[k], r_[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _stacked_units_tree(N, U, seed):
    """A client-stacked tree with units stacked on axis 1, as the
    transformer's: {"frontend": {"embed"}, "units": {"attn", "mlp"}, "head"}."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {"frontend": {"embed": r(N, 16, 8)},
            "units": {"attn": {"wq": r(N, U, 8, 12), "norm": r(N, U, 8)},
                      "mlp": {"w1": r(N, U, 8, 6), "w2": r(N, U, 6, 8)}},
            "head": {"norm": r(N, 8)}}


@pytest.mark.parametrize("cuts", [(1, 3), (0, 5), (2, 2), (5, 5)])
def test_stacked_tier_subtrees_and_combine_match_jax(cuts):
    """Tier slices of stacked units are x[:, lo:hi]; combine_tiers
    concatenates them back on the unit axis."""
    np_tree = _stacked_units_tree(4, 5, seed=sum(cuts))
    plan = default_plan(5, 4, cuts=cuts, intervals=(2, 2, 1), entities=(4, 2, 1))
    parts = tier_subtrees(params_from_numpy(np_tree, CPU), plan)
    jparts = jax_tier_subtrees(jax.tree.map(jnp.asarray, np_tree), plan)
    for p, jp in zip(parts, jparts):
        assert sorted(p) == sorted(jp)
        for path, leaf in zip(("attn/wq", "attn/norm", "mlp/w1", "mlp/w2"),
                              (p["units"]["attn"]["wq"], p["units"]["attn"]["norm"],
                               p["units"]["mlp"]["w1"], p["units"]["mlp"]["w2"])):
            a, b = path.split("/")
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jp["units"][a][b]))
    back = combine_tiers(parts, params_from_numpy(np_tree, CPU))
    for a in ("attn", "mlp"):
        for k, v in np_tree["units"][a].items():
            np.testing.assert_array_equal(back["units"][a][k].numpy(), v)
    assert back["frontend"]["embed"] is parts[0]["frontend"]["embed"]
    assert back["head"]["norm"] is parts[-1]["head"]["norm"]


@pytest.mark.parametrize("fed", [False, True])
@pytest.mark.parametrize("cuts", [(1, 3), (0, 2)])
def test_synchronize_stacked_tree_matches_jax(fed, cuts):
    """The sync of a stacked tree: every tier's slice through B1's plain
    version (one call per leaf), an empty tier left as it is."""
    N = 8
    np_tree = _stacked_units_tree(N, 5, seed=7)
    plan = default_plan(5, N, cuts=cuts, intervals=(2, 2, 1), entities=(N, 2, 1))
    ref = jax_synchronize(jax.tree.map(jnp.asarray, np_tree), plan, jnp.int32(0),
                          fed_round=fed)
    got = synchronize(params_from_numpy(np_tree, CPU), plan, 0, fed_round=fed)
    g, r = _flat_tree(got), _flat_tree(ref)
    assert g.keys() == r.keys()
    for k in r:
        assert g[k].shape == r[k].shape
        np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _flat_tree(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat_tree(sub, prefix + (key,)).items()}
    return {"/".join(prefix): np.asarray(tree)}
