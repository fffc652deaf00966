"""Engine-A state migration in the port (``control.migrate``) against the
JAX package's: ``migrate_params_a`` / ``migrate_state_a`` at rtol 1e-6 (one
B1 entity-level launch per leaf against JAX's group mean), the client mean
kept, idempotence, the optimizer moments carried; ``resume_with_migration``
from a checkpoint either package wrote, params or a whole ``TrainState``;
Engine B's migration (``migrate_params_b`` / ``migrate_state_b``) against
JAX's."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save
from repro.control.migrate import (
    _entity_stack as jax_entity_stack, migrate_params_a as jax_migrate,
    migrate_params_b as jax_migrate_b_params, migrate_state_a as jax_migrate_state,
    migrate_state_b as jax_migrate_state_b, resume_with_migration as jax_resume,
)
from repro.core.engine import TrainState as JaxState, engine_b_to_full as jax_engine_b_to_full
from repro.core.tiers import default_plan as jax_default_plan, tier_subtrees as jax_tier_subtrees
from repro.optim import adam as jadam, momentum as jmomentum, sgd as jsgd
from repro_torch._tree import tree_leaves
from repro_torch.checkpoint import save_checkpoint
from repro_torch.control import (
    migrate_params_a, migrate_state, migrate_state_a, resume_with_migration,
)
from repro_torch.control.migrate import _entity_stack, migrate_params_b, migrate_state_b
from repro_torch.core import TrainState, default_plan
from repro_torch.core.engine import engine_b_to_full
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.optim import adam, momentum, sgd

CPU = torch.device("cpu")
N, U = 4, 6


def _np_tree(seed, d=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"frontend": {"embed": f(N, 8, d)}, "units": {"w": f(N, U, d, d)},
            "head": {"norm": f(N, d)}}


def _plans(cuts, intervals=(2, 2, 1)):
    kw = dict(cuts=cuts, intervals=intervals, entities=(N, 2, 1))
    return jax_default_plan(U, N, **kw), default_plan(U, N, **kw)


def _by_key(tree):
    return {(a, b): tree[a][b] for a, b in (("frontend", "embed"), ("units", "w"),
                                            ("head", "norm"))}


def _close(got, ref, rtol=1e-6):
    for k, v in _by_key(ref).items():
        np.testing.assert_allclose(_by_key(got)[k].numpy(), np.asarray(v), rtol=rtol,
                                   atol=1e-7, err_msg=str(k))


@pytest.mark.parametrize("cuts", [(1, 4), (2, 3), (0, 6), (3, 3)])
def test_migrate_params_a_matches_jax_and_keeps_the_client_mean(cuts):
    tree = _np_tree(0)
    jp, tp = _plans(cuts)
    ref = jax_migrate(jax.tree.map(jnp.asarray, tree), jp)
    out = migrate_params_a(params_from_numpy(tree, CPU), tp)
    _close(out, ref)
    for k, v in _by_key(tree).items():
        np.testing.assert_allclose(_by_key(out)[k].mean(0).numpy(), v.mean(0), rtol=1e-5,
                                   atol=1e-6)
    # re-applying the same plan changes nothing (groups of 2: exact means)
    again = migrate_params_a(out, tp)
    for a, b in zip(tree_leaves(again), tree_leaves(out)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adam"])
def test_migrate_state_a_carries_optimizer_moments_as_jax(opt_name):
    jopt = {"sgd": jsgd, "momentum": jmomentum, "adam": jadam}[opt_name](1e-2)
    topt = {"sgd": sgd, "momentum": momentum, "adam": adam}[opt_name](1e-2)
    params = _np_tree(1)
    if opt_name == "sgd":
        jo, to = (), ()
    elif opt_name == "momentum":
        jo, to = jax.tree.map(jnp.asarray, _np_tree(2)), params_from_numpy(_np_tree(2), CPU)
    else:
        m, v = _np_tree(3), jax.tree.map(np.abs, _np_tree(4))
        jo = {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
              "t": jnp.asarray(5, jnp.int32)}
        to = {"m": params_from_numpy(m, CPU), "v": params_from_numpy(v, CPU),
              "t": torch.tensor(5, dtype=torch.int32)}
    jp, tp = _plans((2, 3))
    ref = jax_migrate_state(JaxState(jax.tree.map(jnp.asarray, params), jo, 7), jp, jopt)
    out = migrate_state_a(TrainState(params_from_numpy(params, CPU), to, 7), tp, topt)
    assert out.step == 7
    _close(out.params, ref.params)
    if opt_name == "momentum":
        _close(out.opt_state, ref.opt_state)
    elif opt_name == "adam":
        _close(out.opt_state["m"], ref.opt_state["m"])
        _close(out.opt_state["v"], ref.opt_state["v"])
        assert int(out.opt_state["t"]) == 5
    else:
        assert out.opt_state == ()
    assert migrate_state(TrainState(out.params, to, 7), tp, topt).step == 7


@pytest.mark.parametrize("cuts", [(1, 4), (0, 6), (3, 3)])
def test_engine_b_migration_matches_jax(cuts):
    """Engine-B tier stacks (cut (2, 3): tier 0 per client, tier 1 two
    entities, tier 2 one) migrated to ``cuts``: ``migrate_params_b``,
    ``migrate_state_b`` (momentum carried) and ``migrate_state(engine="b")``
    equal JAX's at rtol 1e-6, the client mean of the materialized model is
    kept, and the dispatcher needs the model and the old plan."""
    tree = _np_tree(10)
    jp_old, tp_old = _plans((2, 3))
    jp_new, tp_new = _plans(cuts)
    # each tier's entity rows: the first client row of each entity group
    tiers = [jax.tree.map(lambda x, per=N // jp_old.entities[m]: x[::per], part)
             for m, part in enumerate(jax_tier_subtrees(tree, jp_old))]
    moments = [jax.tree.map(lambda x: 0.5 * x, t) for t in tiers]
    ref = jax_migrate_b_params(None, jax.tree.map(jnp.asarray, tiers), jp_old, jp_new)
    ref_state = jax_migrate_state_b(
        JaxState(jax.tree.map(jnp.asarray, tiers), jax.tree.map(jnp.asarray, moments), 3),
        None, jp_old, jp_new, jmomentum(1e-2))
    got = migrate_params_b(None, params_from_numpy(tiers, CPU), tp_old, tp_new)
    state = TrainState(params_from_numpy(tiers, CPU), params_from_numpy(moments, CPU), 3)
    got_state = migrate_state_b(state, None, tp_old, tp_new, momentum(1e-2))
    via = migrate_state(state, tp_new, momentum(1e-2), engine="b", model=object(),
                        old_plan=tp_old)
    for out, want in ((got, ref), (got_state.params, ref_state.params),
                      (got_state.opt_state, ref_state.opt_state), (via.params, ref)):
        x, y = jax.tree.leaves(params_to_numpy(out)), jax.tree.leaves(want)
        assert len(x) == len(y)
        for a, b in zip(x, y):
            assert a.shape == np.asarray(b).shape
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    assert got_state.step == 3
    full = engine_b_to_full(None, tp_new, got)
    for k, v in _by_key(_jax_full(tiers, jp_old)).items():
        np.testing.assert_allclose(_by_key(full)[k].mean(0).numpy(), v.mean(0), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="engine-b migration needs model and old_plan"):
        migrate_state(state, tp_new, sgd(0.1), engine="b")


def _jax_full(tiers, plan):
    """JAX's client-stacked view of Engine-B tier stacks."""
    return jax.tree.map(np.asarray, jax_engine_b_to_full(None, plan,
                                                         jax.tree.map(jnp.asarray, tiers)))


def test_entity_stack_matches_jax():
    tree = _np_tree(5)
    ref = jax_entity_stack(jax.tree.map(jnp.asarray, tree), 2, N)
    out = _entity_stack(params_from_numpy(tree, CPU), 2, N)
    _close(out, ref)
    assert out["units"]["w"].shape == (2, U, 4, 4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_with_migration_matches_jax(tmp_path, writer):
    """A checkpoint saved under cuts (1, 4) by either package: resumed under
    the same plan it comes back bit for bit; under moved cuts it migrates,
    as JAX's does, at rtol 1e-6."""
    tree = _np_tree(6)
    path = str(tmp_path / "ck.npz")
    if writer == "jax":
        jax_save(path, jax.tree.map(jnp.asarray, tree), step=3, meta={"cuts": [1, 4]})
    else:
        save_checkpoint(path, params_from_numpy(tree, CPU), step=3, meta={"cuts": [1, 4]})
    template = params_from_numpy(_np_tree(7), CPU)
    jp_same, tp_same = _plans((1, 4))
    got, step, meta = resume_with_migration(path, template, tp_same)
    assert step == 3 and meta == {"cuts": [1, 4]}
    for k, v in _by_key(tree).items():
        assert np.array_equal(_by_key(got)[k].numpy(), v)
    jp_moved, tp_moved = _plans((2, 3))
    moved, _, _ = resume_with_migration(path, template, tp_moved)
    ref, _, _ = jax_resume(path, jax.tree.map(jnp.asarray, _np_tree(7)), jp_moved)
    _close(moved, ref)


def test_resume_a_whole_train_state(tmp_path):
    """The fault-tolerant loop checkpoints the whole ``TrainState``
    (params under ``0``, the optimizer state under ``1``, the step under
    ``2``, as the JAX package writes its pytree node); it resumes bit for
    bit."""
    params = params_from_numpy(_np_tree(8), CPU)
    opt = adam(1e-2)
    state = TrainState(params, opt.init(params), 4)
    state.opt_state["t"] = torch.tensor(4, dtype=torch.int32)
    path = str(tmp_path / "engine.npz")
    save_checkpoint(path, state, step=4, meta={"cuts": [1, 4]})
    zeros = TrainState(params_from_numpy(_np_tree(9), CPU), opt.init(params), 0)
    _, tp = _plans((1, 4))
    back, step, _ = resume_with_migration(path, zeros, tp)
    assert step == 4 and back.step == 4 and isinstance(back, TrainState)
    for a, b in zip(tree_leaves(back.params) + tree_leaves(back.opt_state),
                    tree_leaves(state.params) + tree_leaves(state.opt_state)):
        assert torch.equal(a, b)
    with np.load(path) as z:
        assert "0/units/w" in z and "1/m/units/w" in z and int(z["2"]) == 4
    assert params_to_numpy(back.params)["units"]["w"].shape == (N, U, 4, 4)
