"""Fault injection and the guarded sync in the port, against the JAX
package's ``repro.faults`` and ``tiers.guard_health`` / ``synchronize(guard=)``:

* the NumPy modules (``FaultSpec``, per-round streams, faulty traces, retry
  pricing, q-deflation, the outage assignment) equal JAX's with ``==``;
* ``apply_corruption`` and the guard's sanitized tree equal JAX's bit for
  bit; the guard's health decision equals JAX's, also where N is even and
  ``torch.median`` (the lower middle value) would decide otherwise;
* the guarded and masked syncs — dense on B1m's plain version, per class on
  B3m's — and the reroute at rtol 1e-5 / atol 1e-6;
* Engine A under the guard with injected corruption: losses at rtol 1e-4
  over 4 REDUCED rounds; an all-healthy guard is the all-ones mask's step
  bit for bit, its loss the unguarded one exactly.
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.faults as jf
import repro_torch.faults as tf
from repro.compress import Int8Stochastic as JaxInt8
from repro.configs.vgg16_cifar10 import REDUCED as JAX_REDUCED, SPEC as JAX_VGG
from repro.core import (
    HsflProblem as JaxProblem, SystemSpec as JaxSystem, build_profile as jax_profile,
    build_train_step_a as jax_build_step, init_state_a as jax_init,
    synthetic_hyperspec as jax_hyper,
)
from repro.core.convergence import ParticipationSpec as JaxPart
from repro.core.tiers import (
    GuardSpec as JaxGuard, _ragged_units_mean as jax_ragged_units_mean,
    class_tier_members as jax_members, default_plan as jax_default_plan,
    guard_health as jax_guard_health, ragged_synchronize as jax_ragged_sync,
    synchronize as jax_synchronize,
)
from repro.models.vgg import VggModel as JaxVgg
from repro.optim import sgd as jsgd
from repro.sim import make_trace as jax_make_trace
from repro_torch.compress import Int8Stochastic
from repro_torch.configs.vgg16_cifar10 import REDUCED, SPEC as VGG
from repro_torch.core import (
    HsflProblem, SystemSpec, TrainState, build_profile, build_train_step_a,
    class_tier_members, default_plan, synthetic_hyperspec, synchronize,
)
from repro_torch.core.convergence import ParticipationSpec, theorem1_bound
from repro_torch.core.tiers import GuardSpec, _median, guard_health, ragged_synchronize
from repro_torch.kernels.tiered_aggregate import (
    launches, masked_ragged_aggregate_tree, masked_ragged_quantized_tiered_aggregate,
    masked_ragged_tiered_aggregate, masked_ragged_tiered_aggregate_ref, reset_launches,
)
from repro_torch.launch import train
from repro_torch.models import VggModel, params_from_numpy, params_to_numpy
from repro_torch.optim import sgd
from repro_torch.sim import make_trace, simulate, simulate_rounds

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
N = 8
ENTITIES = (N, 4, 1)


def storm_kw(seed=0, **kw):
    base = dict(seed=seed, crash_rate=0.1, corrupt_rate=0.1, link_fail_rate=0.2,
                link_retries=2, outage_cells=(0,), outage_tier=1, outage_start=2,
                outage_len=3)
    base.update(kw)
    return base


def _np_params(seed, n=N, U=8, d=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"frontend": {"embed": f(n, 8, d)}, "units": {"w": f(n, U, d, d)},
            "head": {"norm": f(n, d)}}


def _vgg_tree(seed, n=N):
    rng = np.random.default_rng(seed)
    shapes = [((3, 3, 3, 16), 16), ((3, 3, 16, 16), 16), ((3, 3, 16, 32), 32),
              ((512, 64), 64), ((64, 10), 10)]
    return {"frontend": {}, "head": {}, "units": [
        {"w": rng.normal(size=(n, *ws)).astype(np.float32),
         "b": rng.normal(size=(n, bs)).astype(np.float32)} for ws, bs in shapes]}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_leaves(tree):
    from repro_torch._tree import tree_leaves

    return [x.numpy() for x in tree_leaves(tree)]


def _sorted_leaves(tree):
    """Port tree leaves in JAX's sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    if isinstance(tree, torch.Tensor):  # bf16 as its bits: numpy has no bf16
        return [(tree.view(torch.int16) if tree.dtype == torch.bfloat16 else tree).numpy()]
    return [np.asarray(tree)]


# --------------------------------------------------------------------------- #
# the NumPy modules, verbatim: equal with ==
# --------------------------------------------------------------------------- #


def test_fault_spec_json_and_properties_equal_jax():
    for kw in (storm_kw(seed=7, corrupt_mode="bitflip", crash_stage="downlink"), {},
               dict(link_fail_rate=0.2), dict(outage_cells=(1,), outage_len=1)):
        js, ts = jf.FaultSpec(**kw), tf.FaultSpec(**kw)
        assert ts.to_dict() == js.to_dict()
        assert tf.FaultSpec.from_dict(json.loads(json.dumps(js.to_dict()))) == ts
        assert (ts.is_null, ts.retry_mult, ts.has_outage) == (
            js.is_null, js.retry_mult, js.has_outage)
    for p, k in ((0.0, 5), (0.3, 4), (0.25, 3)):
        assert tf.retry_attempts(p, k) == jf.retry_attempts(p, k)
    assert tf.CORRUPT_MODES == jf.CORRUPT_MODES and tf.CRASH_STAGES == jf.CRASH_STAGES


@pytest.mark.parametrize("kw,match", [
    (dict(crash_rate=1.5), "crash_rate"), (dict(link_fail_rate=1.0), "link_fail_rate"),
    (dict(crash_stage="teleport"), "crash_stage"), (dict(corrupt_mode="gamma-ray"), "corrupt_mode"),
    (dict(corrupt_scale=0.0), "corrupt_scale"), (dict(link_retries=-1), "link_retries"),
    (dict(outage_len=3), "outage_cells"),
])
def test_fault_spec_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match) as terr:
        tf.FaultSpec(**kw)
    with pytest.raises(ValueError) as jerr:
        jf.FaultSpec(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("seed", [0, 3])
def test_expand_faults_equals_jax(seed):
    for kw in (storm_kw(seed=seed), dict(seed=seed, crash_rate=0.3),
               dict(seed=seed, corrupt_rate=0.3, link_fail_rate=0.2)):
        js, ts = jf.FaultSpec(**kw), tf.FaultSpec(**kw)
        for r in range(12):
            a, b = jf.expand_faults(js, r, N), tf.expand_faults(ts, r, N)
            for f in ("crashed", "corrupt", "attempts", "faulty"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
            assert (a.cell_out, a.n_faulty) == (b.cell_out, b.n_faulty)


def _traces(rounds=6, scenario="lognormal-heterogeneous", **kw):
    jt = jax_make_trace(scenario, jax_profile(JAX_VGG, batch=2),
                        JaxSystem.paper_three_tier(num_clients=N, num_edges=4, seed=0),
                        rounds=rounds, seed=0)
    tt = make_trace(scenario, build_profile(VGG, batch=2),
                    SystemSpec.paper_three_tier(num_clients=N, num_edges=4, seed=0),
                    rounds=rounds, seed=0)
    return jf.faulty_trace(jt, jf.FaultSpec(**kw)), tf.faulty_trace(tt, tf.FaultSpec(**kw))


@pytest.mark.parametrize("scenario", ["homogeneous-paper", "flaky-wan"])
def test_faulty_trace_equals_jax_and_events_equal_fleet(scenario):
    jt, tt = _traces(scenario=scenario, **storm_kw())
    assert tt.name == jt.name
    for r in range(6):
        a, b = jt.round_state(r), tt.round_state(r)
        assert np.array_equal(a.available, b.available)
        for f in ("compute_mult", "link_up_mult", "link_down_mult", "fed_up_mult",
                  "fed_down_mult"):
            for x, y in zip(getattr(a, f), getattr(b, f)):
                assert np.array_equal(x, y), f
    ev = simulate(tt, (3, 8), (2, 3, 1))
    fl = simulate_rounds(tt, (3, 8), (2, 3, 1), backend="numpy")
    for f in ("split", "agg", "fired", "total", "participants"):
        assert np.array_equal(getattr(ev, f), getattr(fl, f)), f
    base = _traces(scenario=scenario)[1]
    assert tf.faulty_trace(base, tf.FaultSpec()) is base
    assert tf.faulty_trace(base, None) is base


def test_all_crashed_round_raises_as_jax():
    _, tt = _traces(scenario="homogeneous-paper", crash_rate=1.0)
    with pytest.raises(ValueError, match="every client crashed"):
        tt.round_state(0)


def _problems(**fault_kw):
    jp = jax_profile(JAX_VGG, batch=2)
    jsys = JaxSystem.paper_three_tier(num_clients=N, num_edges=4, seed=0)
    jh = jax_hyper(jp.n_units, N, beta=3.0, seed=0)
    from repro.core.convergence import theorem1_bound as jax_bound

    jprob = JaxProblem(jp, jsys, jh, eps=6.0 * jax_bound(jh, 10**9, [1] * 3, (5, 11)))
    tp = build_profile(VGG, batch=2)
    tsys = SystemSpec.paper_three_tier(num_clients=N, num_edges=4, seed=0)
    th = synthetic_hyperspec(tp.n_units, N, beta=3.0, seed=0)
    tprob = HsflProblem(tp, tsys, th, eps=6.0 * theorem1_bound(th, 10**9, [1] * 3, (5, 11)))
    return (jprob.with_faults(jf.FaultSpec(**fault_kw)),
            tprob.with_faults(tf.FaultSpec(**fault_kw)))


@pytest.mark.parametrize("kw", [dict(link_fail_rate=0.25, link_retries=3), {}])
def test_retry_pricing_tables_equal_jax(kw):
    jp, tp = _problems(**kw)
    assert tp.retry_mult == jp.retry_mult
    je, te = jp.evaluator("numpy"), tp.evaluator("numpy")
    for f in ("split", "agg", "mem_ok"):
        assert np.array_equal(getattr(te, f), getattr(je, f)), f
    assert tp.split_T((3, 8)) == jp.split_T((3, 8))
    assert np.array_equal(tp.agg_T((3, 8)), jp.agg_T((3, 8)))


def test_accounting_equals_jax():
    js, ts = jf.FaultSpec(**storm_kw(seed=3)), tf.FaultSpec(**storm_kw(seed=3))
    assert np.array_equal(tf.fault_survival(ts, N, ENTITIES, 12),
                          jf.fault_survival(js, N, ENTITIES, 12))
    for r in range(6):
        assert np.array_equal(tf.round_healthy(ts, r, N, ENTITIES),
                              jf.round_healthy(js, r, N, ENTITIES))
    for base in (None, (0.5, 0.5, 0.5)):
        jb = None if base is None else JaxPart(q=base, deadline=7.0)
        tb = None if base is None else ParticipationSpec(q=base, deadline=7.0)
        a = jf.deflate_participation(jb, js, N, ENTITIES, 12)
        b = tf.deflate_participation(tb, ts, N, ENTITIES, 12)
        assert tuple(b.q) == tuple(a.q) and b.deadline == a.deadline
    assert tf.deflate_participation(None, tf.FaultSpec(), N, ENTITIES, 10) is None
    with pytest.raises(ValueError, match="all-faulty"):
        tf.deflate_participation(None, tf.FaultSpec(crash_rate=1.0), N, ENTITIES, 4)


def test_outage_assignment_and_members_equal_jax():
    for n, J, out in ((8, 4, (0,)), (8, 4, ()), (12, 3, (1,)), (8, 4, (0, 2))):
        a, b = jf.outage_assignment(n, J, out), tf.outage_assignment(n, J, out)
        assert np.array_equal(a, b)
        assert np.array_equal(jf.assignment_members(a, J), tf.assignment_members(b, J))
    for args, match in (((9, 4, (0,)), "divisible"), ((8, 4, (7,)), "outside"),
                        ((8, 4, (0, 1, 2, 3)), "no sibling")):
        with pytest.raises(ValueError, match=match):
            tf.outage_assignment(*args)


# --------------------------------------------------------------------------- #
# corruption and the guard: bit for bit
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ["nan", "inf", "scale", "bitflip"])
def test_apply_corruption_is_bit_equal_to_jax(mode):
    """Every corruption mode, f32 and bf16 leaves and a scalar leaf: the
    port's tree equals JAX's bit for bit (bitflip leaves bf16 alone)."""
    tree = _np_params(1)
    tree["units"]["bf"] = np.random.default_rng(2).normal(size=(N, 5)).astype(np.float32)
    corrupt = np.zeros(N, bool)
    corrupt[[1, 6]] = True
    spec_kw = dict(corrupt_rate=0.5, corrupt_mode=mode, corrupt_scale=1e6)
    jt = _jax(tree)
    jt["units"]["bf"] = jt["units"]["bf"].astype(jnp.bfloat16)
    jt["step"] = jnp.asarray(3, jnp.int32)
    tt = params_from_numpy(tree, CPU)
    tt["units"]["bf"] = tt["units"]["bf"].bfloat16()
    tt["step"] = torch.tensor(3, dtype=torch.int32)
    ref = jf.apply_corruption(jt, corrupt, jf.FaultSpec(**spec_kw))
    got = tf.apply_corruption(tt, corrupt, tf.FaultSpec(**spec_kw))
    for a, b in zip(_leaves_np(ref), _sorted_leaves(got)):
        assert a.tobytes() == b.tobytes()
    assert tf.apply_corruption(tt, np.zeros(N, bool), tf.FaultSpec(**spec_kw)) is tt


@pytest.mark.parametrize("n", [4, 5])
@pytest.mark.parametrize("mode", ["nan", "inf", "scale", "bitflip"])
def test_guard_health_and_sanitized_tree_equal_jax(n, mode):
    """N=4 and N=5: the health mask equals JAX's; the sanitized tree equals
    JAX's bit for bit and is finite; an all-healthy tree comes back as it
    went in, bit for bit."""
    tree = _np_params(3, n=n)
    corrupt = np.zeros(n, bool)
    corrupt[n - 2] = True
    jt = jf.apply_corruption(_jax(tree), corrupt, jf.FaultSpec(corrupt_rate=0.5,
                                                               corrupt_mode=mode))
    tt = tf.apply_corruption(params_from_numpy(tree, CPU), corrupt,
                             tf.FaultSpec(corrupt_rate=0.5, corrupt_mode=mode))
    jh, jc = jax_guard_health(jt, n, JaxGuard())
    th, tc = guard_health(tt, n, GuardSpec())
    assert np.array_equal(th.numpy(), np.asarray(jh)) and th[n - 2] == 0.0
    for a, b in zip(_leaves_np(jc), _sorted_leaves(tc)):
        assert a.tobytes() == b.tobytes() and np.isfinite(b).all()
    th2, none = guard_health(tt, n, GuardSpec(), sanitize=False)
    assert none is None and torch.equal(th2, th)
    clean = params_from_numpy(tree, CPU)
    h, out = guard_health(clean, n, GuardSpec())
    assert torch.equal(h, torch.ones(n))
    assert all(a.tobytes() == b.tobytes()
               for a, b in zip(_port_leaves(out), _port_leaves(clean)))


def test_guard_median_of_an_even_fleet_is_jax_median():
    """Squared norms [1, 1, 3, 4] at norm_factor 1.8: jnp.median gives 2,
    so only client 3 (4 > 3.6) blows up; ``torch.median`` would give 1 and
    quarantine client 2 too (3 > 1.8).  The guard decides as JAX does."""
    x = np.array([[1, 0, 0, 0], [1, 0, 0, 0], [1, 1, 1, 0], [1, 1, 1, 1]], np.float32)
    norm2 = torch.from_numpy(x.sum(axis=1))
    assert torch.median(norm2).item() == 1.0 and _median(norm2).item() == 2.0
    assert _median(norm2).item() == float(jnp.median(jnp.asarray(norm2.numpy())))
    jh, _ = jax_guard_health({"w": jnp.asarray(x)}, 4, JaxGuard(norm_factor=1.8))
    th, _ = guard_health({"w": torch.from_numpy(x)}, 4, GuardSpec(norm_factor=1.8))
    assert np.array_equal(np.asarray(jh), [1, 1, 1, 0])
    assert np.array_equal(th.numpy(), np.asarray(jh))
    torch_decision = (norm2 > 1.8 * torch.median(norm2)).numpy()
    assert not np.array_equal(~torch_decision, th.numpy() > 0)
    with pytest.raises(ValueError, match="norm_factor"):
        GuardSpec(norm_factor=1.0)


# --------------------------------------------------------------------------- #
# the guarded and masked syncs
# --------------------------------------------------------------------------- #


def _corrupt_np(tree, rows, mode="nan", seed=0):
    spec = jf.FaultSpec(corrupt_rate=0.5, corrupt_mode=mode, corrupt_scale=1e6)
    corrupt = np.zeros(N, bool)
    corrupt[list(rows)] = True
    return jax.tree.map(np.asarray, jf.apply_corruption(_jax(tree), corrupt, spec))


@pytest.mark.parametrize("mode", ["nan", "scale", "bitflip", "none"])
@pytest.mark.parametrize("codec", [None, 128], ids=["dense", "int8"])
@pytest.mark.parametrize("fed", [None, True, (False, True, True)],
                         ids=["by-step", "all-fed", "tier1-fed"])
def test_guarded_synchronize_matches_jax(mode, codec, fed):
    """``synchronize(guard=)`` on N=8, J2=4 with one or two corrupt clients
    (or none), plain and over the int8 fed wire, under a mask: rtol 1e-5 /
    atol 1e-6 against JAX; every output finite."""
    tree = _vgg_tree(4)
    if mode != "none":
        tree = _corrupt_np(tree, (2, 5), mode)
    w = np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32)
    jp = jax_default_plan(5, N, cuts=(1, 3), intervals=(2, 2, 1), entities=ENTITIES)
    cf = None
    if codec:
        jc = JaxInt8(tile=codec)
        cf = lambda x: jax.vmap(jc.transform)(x)  # noqa: E731
    ref = jax_synchronize(_jax(tree), jp, jnp.asarray(1), fed_round=fed, compress_fn=cf,
                          mask=jnp.asarray(w), guard=JaxGuard())
    tp = default_plan(5, N, cuts=(1, 3), intervals=(2, 2, 1), entities=ENTITIES)
    got = synchronize(params_from_numpy(tree, CPU), tp, 1, fed_round=fed,
                      compressor=Int8Stochastic(codec) if codec else None,
                      mask=torch.from_numpy(w), guard=GuardSpec())
    for a, b in zip(_leaves_np(ref), _sorted_leaves(got)):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def _ragged_inputs(n=N, seed=5):
    tree = _vgg_tree(seed, n)
    class_cuts, class_of = [(1, 3), (2, 4)], [0, 1] * (n // 2)
    return tree, class_cuts, class_of


@pytest.mark.parametrize("mask", ["random", "silent group", "all zero", "all ones"])
@pytest.mark.parametrize("guarded", [False, True], ids=["masked", "guarded"])
@pytest.mark.parametrize("codec", [None, 128], ids=["dense", "int8"])
def test_masked_and_guarded_ragged_synchronize_matches_jax(mask, guarded, codec):
    """``ragged_synchronize(mask=, guard=)`` — units on B3m's plain version,
    frontend and head on B1m's — against JAX's at rtol 1e-5 / atol 1e-6,
    with per-class cuts ((1, 3), (2, 4)), a corrupt client under the guard,
    and the int8 fed wire; an all-zero mask (unguarded) returns every leaf."""
    tree, class_cuts, class_of = _ragged_inputs()
    if guarded:
        tree = _corrupt_np(tree, (3,), "inf")
    w = {"random": [1, 0, 1, 1, 0, 1, 1, 0], "silent group": [0, 0, 1, 1, 1, 1, 0, 1],
         "all zero": [0] * N, "all ones": [1] * N}[mask]
    w = np.asarray(w, np.float32)
    jp = jax_default_plan(5, N, cuts=(1, 3), intervals=(2, 2, 1), entities=ENTITIES)
    cf = None
    if codec:
        jc = JaxInt8(tile=codec)
        cf = lambda x: jax.vmap(jc.transform)(x)  # noqa: E731
    ref = jax_ragged_sync(_jax(tree), jp, jax_members(5, class_cuts, class_of), jnp.asarray(1),
                          compress_fn=cf, mask=jnp.asarray(w),
                          guard=JaxGuard() if guarded else None)
    tp = default_plan(5, N, cuts=(1, 3), intervals=(2, 2, 1), entities=ENTITIES)
    got = ragged_synchronize(params_from_numpy(tree, CPU), tp,
                             class_tier_members(5, class_cuts, class_of, CPU), 1,
                             compressor=Int8Stochastic(codec) if codec else None,
                             mask=torch.from_numpy(w), guard=GuardSpec() if guarded else None)
    for a, b in zip(_leaves_np(ref), _sorted_leaves(got)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
        if guarded:
            assert np.isfinite(b).all()
    if not w.any() and not guarded:
        for a, b in zip(_port_leaves(got), _port_leaves(params_from_numpy(tree, CPU))):
            assert np.array_equal(a, b)


def test_ragged_all_ones_mask_equals_the_unmasked_ragged_sync():
    """B3m with an all-ones mask against B3's twin: equal at the ragged
    collapse tolerance (the twin sums m·y, B3m cw·y and divides once)."""
    tree, class_cuts, class_of = _ragged_inputs()
    tp = default_plan(5, N, cuts=(1, 3), intervals=(2, 2, 1), entities=ENTITIES)
    members = class_tier_members(5, class_cuts, class_of, CPU)
    for step in (0, 1):
        plain = ragged_synchronize(params_from_numpy(tree, CPU), tp, members, step)
        ones = ragged_synchronize(params_from_numpy(tree, CPU), tp, members, step,
                                  mask=torch.ones(N))
        for a, b in zip(_port_leaves(plain), _port_leaves(ones)):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


MEMBER_KINDS = ("class", "all", "none")
MASK_KINDS = ("ones", "zero", "7-of-8", "silent group")


def _b3m_case(member_kind, mask_kind, n=N, U=3, E=40, seed=0):
    rng = np.random.default_rng(seed)
    member = {"class": np.array([[i % 2, 1, (i + 1) % 2] for i in range(n)], np.float32),
              "all": np.ones((n, U), np.float32), "none": np.zeros((n, U), np.float32)}[member_kind]
    mask = {"ones": np.ones(n), "zero": np.zeros(n),
            "7-of-8": np.r_[np.ones(n - 1), 0.0],
            "silent group": np.r_[0.0, 0.0, np.ones(n - 2)]}[mask_kind].astype(np.float32)
    x = rng.normal(size=(n, U * E)).astype(np.float32)
    keep = rng.normal(size=(n, U * E)).astype(np.float32)
    return x, mask, member, keep


@pytest.mark.parametrize("member_kind", MEMBER_KINDS)
@pytest.mark.parametrize("mask_kind", MASK_KINDS)
@pytest.mark.parametrize("de,dg", [(1, 1), (1, 0), (0, 1)])
@pytest.mark.parametrize("J", [4, 1])
def test_b3m_plain_version_matches_jax_ragged_units_mean(member_kind, mask_kind, de, dg, J):
    """B3m's plain version (what a CPU tensor runs) against JAX's
    ``_ragged_units_mean`` with a mask, level by level, on a stacked
    [N, U, E] leaf with an independent ``keep``; bf16 within two bf16 ulps
    of the column's largest |x| (the port rounds once, JAX per level)."""
    x, mask, member, keep = _b3m_case(member_kind, mask_kind)
    U = member.shape[1]

    def jax_levels(xx, kk):
        units = {"w": jnp.asarray(xx).reshape(N, U, -1)}
        keep_u = {"w": jnp.asarray(kk).reshape(N, U, -1)}
        mem, wm = jnp.asarray(member), jnp.asarray(mask)
        y = units
        if de:
            y = jax_ragged_units_mean(y, keep_u, mem, J, wm)
        if dg:
            y = jax_ragged_units_mean(y, y if de else keep_u, mem, 1, wm)
        return np.asarray(y["w"]).reshape(N, -1)

    t = torch.from_numpy
    got = masked_ragged_tiered_aggregate(t(x), t(mask), t(member), t(keep), de, dg, J).numpy()
    np.testing.assert_allclose(got, jax_levels(x, keep), rtol=RTOL, atol=ATOL)
    if not mask.any() or member_kind == "none":
        assert np.array_equal(got, keep)
    xb, kb = t(x).bfloat16(), t(keep).bfloat16()
    gb = masked_ragged_tiered_aggregate(xb, t(mask), t(member), kb, de, dg, J)
    assert gb.dtype == torch.bfloat16
    rb = jax_levels(jnp.asarray(x, jnp.bfloat16), jnp.asarray(keep, jnp.bfloat16))
    colmax = np.abs(xb.float().numpy()).max(axis=0)
    ulp = 2.0 ** (np.floor(np.log2(colmax)) - 7)
    assert np.all(np.abs(gb.float().numpy() - rb.astype(np.float32)) <= 2 * ulp)


@pytest.mark.parametrize("mask_kind", MASK_KINDS)
def test_b3m_int8_load_keeps_the_pre_compression_tree(mask_kind):
    """B3m over the int8 wire: the fed mean of the decoded uploads to the
    members; every other row keeps ``keep`` (the pre-compression tree)."""
    from repro_torch.compress.quantize import q8_quantize

    x, mask, member, keep = _b3m_case("class", mask_kind, seed=1)
    q, s = q8_quantize(torch.from_numpy(x), 64)
    t = torch.from_numpy
    got = masked_ragged_quantized_tiered_aggregate(q, s, t(mask), t(member), t(keep), 0, 1, 1, 64)
    decoded = (q.reshape(N, -1, 64).float() * s[..., None]).reshape(N, -1)[:, :x.shape[1]]
    ref = masked_ragged_tiered_aggregate_ref(decoded, t(mask), t(member), t(keep), 0, 1, 1)
    assert got.shape == x.shape and torch.equal(got, ref)
    receive = (member.reshape(N, 3, 1) > 0) & (mask.sum() > 0)
    rows = np.broadcast_to(~receive, (N, 3, 40)).reshape(N, -1)
    assert np.array_equal(got.numpy()[rows], keep[rows])


def test_b3m_wrappers_count_no_plain_launch_and_check_arguments():
    reset_launches()
    x = torch.zeros(4, 6)
    masked_ragged_tiered_aggregate(x, torch.ones(4), torch.ones(4, 2), x, 1, 1, 2)
    masked_ragged_aggregate_tree({"a": torch.zeros(4, 2, 3)}, torch.ones(4), torch.ones(4, 2),
                                 1, 1, 2, quantized=True)
    assert launches["masked_ragged_tiered_aggregate"] == 0
    assert launches["masked_ragged_tiered_aggregate_q8"] == 0
    with pytest.raises(ValueError, match="mask must be f32"):
        masked_ragged_tiered_aggregate(x, torch.ones(4, dtype=torch.bool), torch.ones(4), x,
                                       1, 1, 2)
    with pytest.raises(ValueError, match="member units do not divide"):
        masked_ragged_tiered_aggregate(x, torch.ones(4), torch.ones(4, 4), x, 1, 1, 2)
    with pytest.raises(ValueError, match="keep must be"):
        masked_ragged_tiered_aggregate(x, torch.ones(4), torch.ones(4), x.bfloat16(), 1, 1, 2)


# --------------------------------------------------------------------------- #
# rerouting
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("out_cells", [(), (0,), (1, 3)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_membership_mean_and_reroute_match_jax(out_cells, with_mask):
    assign = jf.outage_assignment(N, 4, out_cells)
    members = jf.assignment_members(assign, 4)
    tree = _np_params(6)
    dead = np.isin(np.repeat(np.arange(4), 2), out_cells)
    w = np.where(dead, 0.0, 1.0).astype(np.float32) if with_mask else None
    ref = jf.membership_mean(_jax(tree), members, w=None if w is None else jnp.asarray(w))
    got = tf.membership_mean(params_from_numpy(tree, CPU), members,
                             w=None if w is None else torch.from_numpy(w))
    for a, b in zip(_leaves_np(ref), _sorted_leaves(got)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    jp = jax_default_plan(8, N, cuts=(2, 5), intervals=(2, 2, 1), entities=ENTITIES)
    tp = default_plan(8, N, cuts=(2, 5), intervals=(2, 2, 1), entities=ENTITIES)
    ref = jf.reroute_entity_sync(_jax(tree), jp, 1, members,
                                 mask=None if w is None else jnp.asarray(w))
    reset_launches()
    got = tf.reroute_entity_sync(params_from_numpy(tree, CPU), tp, 1,
                                 torch.from_numpy(members),
                                 mask=None if w is None else torch.from_numpy(w))
    assert sum(launches.values()) == 0
    for a, b in zip(_leaves_np(ref), _sorted_leaves(got)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- #
# Engine A under the guard
# --------------------------------------------------------------------------- #

EN, EB, ROUNDS = 4, 2, 4
LR = 0.01
ECUTS, EINTERVALS, EENT = (1, 3), (2, 2, 1), (4, 2, 1)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    hw = REDUCED.image_size
    return [{"images": rng.normal(size=(EN, EB, hw, hw, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (EN, EB)).astype(np.int32)}
            for _ in range(ROUNDS)]


# one corrupt client at a time: a quarantined client keeps its corrupt tier-0
# replica until tier 0's fed level (every 2nd round) heals it, and the
# guard's median reference needs fewer than half the fleet blown up at once
CORRUPT = [np.array(c, bool) for c in ([0, 1, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0])]


def _jax_guarded_run(mode, class_cuts=None):
    jmodel = JaxVgg(JAX_REDUCED)
    jplan = jax_default_plan(REDUCED.n_units, EN, cuts=ECUTS, intervals=EINTERVALS,
                             entities=EENT)
    jopt = jsgd(LR)
    state = jax_init(jmodel, jplan, jopt, jax.random.PRNGKey(0))
    init = params_to_numpy(state.params)
    spec = jf.FaultSpec(corrupt_rate=0.5, corrupt_mode=mode, corrupt_scale=1e6)
    members = None if class_cuts is None else jax_members(
        REDUCED.n_units, class_cuts, [0, 1] * (EN // 2))
    step = jax.jit(jax_build_step(jmodel, jplan, jopt, guard=JaxGuard(), with_mask=True,
                                  class_members=members))
    losses = []
    for r, batch in enumerate(_batches()):
        state = type(state)(jf.apply_corruption(state.params, CORRUPT[r], spec),
                            state.opt_state, state.step)
        state, loss = step(state, _jax(batch), jnp.ones(EN, jnp.float32))
        losses.append(float(loss))
    return init, losses, params_to_numpy(state.params)


def _port_guarded_run(init, mode, class_cuts=None):
    plan = default_plan(REDUCED.n_units, EN, cuts=ECUTS, intervals=EINTERVALS, entities=EENT)
    params = params_from_numpy(init, CPU)
    opt = sgd(LR)
    state = TrainState(params, opt.init(params), 0)
    spec = tf.FaultSpec(corrupt_rate=0.5, corrupt_mode=mode, corrupt_scale=1e6)
    members = None if class_cuts is None else class_tier_members(
        REDUCED.n_units, class_cuts, [0, 1] * (EN // 2), CPU)
    step = build_train_step_a(VggModel(REDUCED), plan, opt, guard=GuardSpec(), with_mask=True,
                              class_members=members)
    losses = []
    for r, batch in enumerate(_batches()):
        state = TrainState(tf.apply_corruption(state.params, CORRUPT[r], spec),
                           state.opt_state, state.step)
        state, loss = step(state, train.to_device(batch, CPU), torch.ones(EN))
        losses.append(float(loss))
    return losses, params_to_numpy(state.params)


@pytest.mark.parametrize("mode", ["nan", "scale"])
@pytest.mark.parametrize("per_class", [False, True], ids=["dense", "per-class"])
def test_engine_a_guarded_step_matches_jax(mode, per_class):
    """REDUCED VGG, N=4, 4 rounds, corruption injected before each step
    (one client in rounds 1 and 3): losses at rtol 1e-4 and
    params at atol 1e-5 against JAX; every loss and param finite."""
    class_cuts = [(1, 3), (2, 4)] if per_class else None
    init, jl, jp = _jax_guarded_run(mode, class_cuts)
    tl, tp = _port_guarded_run(init, mode, class_cuts)
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(jp), _sorted_leaves(tp)):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5)


def test_all_healthy_guard_is_the_all_ones_mask_step_bit_for_bit():
    """No fault: the guarded step's state equals the all-ones masked step's
    bit for bit (both sync on B1m), and its loss equals the unguarded
    step's exactly; ``with_sync_weights`` reports all-ones weights."""
    init = params_to_numpy(VggModel(REDUCED).init_params(torch.Generator().manual_seed(1), CPU))
    from repro_torch.core import replicate_for_clients

    plan = default_plan(REDUCED.n_units, EN, cuts=ECUTS, intervals=EINTERVALS, entities=EENT)
    model, opt = VggModel(REDUCED), sgd(0.05)
    steps = {
        "guard": build_train_step_a(model, plan, opt, guard=GuardSpec(), with_sync_weights=True),
        "ones": build_train_step_a(model, plan, opt, with_mask=True),
        "plain": build_train_step_a(model, plan, opt),
    }
    states = {k: TrainState(replicate_for_clients(params_from_numpy(init, CPU), EN), (), 0)
              for k in steps}
    for batch in _batches():
        b = train.to_device(batch, CPU)
        states["guard"], lg, w = steps["guard"](states["guard"], b)
        states["ones"], _ = steps["ones"](states["ones"], b, torch.ones(EN))
        states["plain"], lp = steps["plain"](states["plain"], b)
        assert torch.equal(lg, lp) and torch.equal(w, torch.ones(EN))
        for a, c in zip(_port_leaves(states["guard"].params), _port_leaves(states["ones"].params)):
            assert np.array_equal(a, c)


def test_faults_cfg_builds_the_fault_and_guard_specs_as_jax():
    from repro import api as J
    from repro_torch import api as T

    js = J.fault_storm_spec(rounds=8, checkpoint_every=4, engine_crash_round=5)
    jc = js.faults
    tc = T.ExperimentSpec.from_dict(json.loads(json.dumps(js.to_dict()))).faults
    assert tc.to_fault_spec().to_dict() == jc.to_fault_spec().to_dict()
    assert tc.to_guard_spec().norm_factor == jc.to_guard_spec().norm_factor
    for kw, match in ((dict(corrupt_mode="solar-flare"), "corrupt_mode"),
                      (dict(engine_crash_round=3), "engine_crash_round"),
                      (dict(guard_norm_factor=0.5), "norm_factor")):
        with pytest.raises(ValueError, match=match):
            T.FaultsCfg(**kw)


def test_null_faults_solve_collapses_bit_exact():
    from repro_torch import api as T

    clean = T.run(T.paper_spec(seed=0))
    nulled = T.run(T.paper_spec(seed=0).replace(faults=T.FaultsCfg()))
    assert (nulled.cuts, nulled.intervals, nulled.theta, nulled.latency) == (
        clean.cuts, clean.intervals, clean.theta, clean.latency)
