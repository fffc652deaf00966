"""The CUDA kernels against their plain versions on the card.

These need an NVIDIA GPU (Hopper, sm_90a) with nvcc: they carry the ``cuda``
marker and skip elsewhere.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX, so it runs where only PyTorch is installed.
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import math

import pytest
import torch
from torch.func import grad_and_value, vmap

from repro_torch._tree import tree_map

from repro_torch.compress.quantize import q8_quantize
from repro_torch.configs.vgg16_cifar10 import REDUCED
from repro_torch.core import (
    class_tier_members, default_plan, init_state_a, ragged_synchronize, synchronize,
)
from repro_torch.kernels.tiered_aggregate import (
    launches, masked_quantized_tiered_aggregate, masked_quantized_tiered_aggregate_ref,
    masked_tiered_aggregate, masked_tiered_aggregate_ref,
    quantized_tiered_aggregate, quantized_tiered_aggregate_ref,
    ragged_quantized_tiered_aggregate, ragged_quantized_tiered_aggregate_ref,
    ragged_tiered_aggregate, ragged_tiered_aggregate_ref, reset_launches,
    tiered_aggregate, tiered_aggregate_ref,
)
from repro_torch.compress import Int8Stochastic
from repro_torch.configs import get_reduced
from repro_torch.kernels import swa_attention as swa
from repro_torch.launch.train import make_dispatch, to_device
from repro_torch.models import SplittableModel, VggModel
from repro_torch.optim import sgd

pytestmark = pytest.mark.cuda
FLAGS = [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("N,J,P", [(8, 4, 700), (20, 5, 2049), (4, 1, 100), (6, 6, 257)])
def test_b1_kernel_matches_plain_f32(cuda, N, J, P):
    g = torch.Generator(device=cuda).manual_seed(P)
    x = torch.randn(N, P, generator=g, device=cuda)
    w = torch.softmax(torch.randn(N, generator=g, device=cuda), 0)
    for de, dg in FLAGS:
        out = tiered_aggregate(x, w, de, dg, J)
        torch.cuda.synchronize()
        # f32 sums in another order: a few ulp
        torch.testing.assert_close(out, tiered_aggregate_ref(x, w, de, dg, J),
                                   rtol=1e-5, atol=1e-6)


def test_b1_kernel_bf16_within_one_ulp(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(20, 4099, generator=g, device=cuda).bfloat16()
    w = torch.full((20,), 1 / 20, device=cuda)
    for de, dg in FLAGS:
        out = tiered_aggregate(x, w, de, dg, 5).float()
        torch.cuda.synchronize()
        ref = tiered_aggregate_ref(x, w, de, dg, 5).float()
        _, exp = torch.frexp(ref)
        ulp = torch.ldexp(torch.ones_like(ref), exp - 8)
        assert bool(((out - ref).abs() <= ulp + 1e-6 + 1e-5 * ref.abs()).all())


@pytest.mark.parametrize("N,J,P,tile", [(20, 5, 1728, 256), (20, 1, 512, 256),
                                        (6, 2, 1000, 128)])
def test_b2_kernel_matches_plain(cuda, N, J, P, tile):
    g = torch.Generator(device=cuda).manual_seed(P)
    x = torch.randn(N, P, generator=g, device=cuda)
    q, s = q8_quantize(x, tile)
    w = torch.full((N,), 1 / N, device=cuda)
    for de, dg in FLAGS:
        out = quantized_tiered_aggregate(q, s, w, de, dg, J, tile)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out, quantized_tiered_aggregate_ref(q, s, w, de, dg, J, tile),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("codec", [None, 128])
def test_sync_on_card_matches_cpu_and_counts_launches(cuda, codec):
    plan = default_plan(REDUCED.n_units, 4, cuts=(1, 3), intervals=(2, 2, 1),
                        entities=(4, 2, 1))
    state = init_state_a(VggModel(REDUCED), plan, sgd(0.1),
                         torch.Generator().manual_seed(0), cuda)
    params = {k: v for k, v in state.params.items()}
    g = torch.Generator(device=cuda).manual_seed(1)
    for unit in params["units"]:
        for k in unit:
            unit[k] = unit[k] + torch.randn(unit[k].shape, generator=g, device=cuda)
    compressor = Int8Stochastic(codec) if codec else None
    reset_launches()
    got = synchronize(params, plan, 1, compressor=compressor)
    torch.cuda.synchronize()
    # round 2 of intervals (2, 2, 1): every tier's fed level runs; tier 0
    # holds 1 unit (2 leaves), tier 1 two units, tier 2 two units
    if codec:
        assert launches == {"tiered_aggregate": 8, "tiered_aggregate_q8": 6,
                            "ragged_tiered_aggregate": 0, "ragged_tiered_aggregate_q8": 0,
                            "masked_tiered_aggregate": 0, "masked_tiered_aggregate_q8": 0,
                            "masked_ragged_tiered_aggregate": 0, "masked_ragged_tiered_aggregate_q8": 0}
    else:
        assert launches == {"tiered_aggregate": 10, "tiered_aggregate_q8": 0,
                            "ragged_tiered_aggregate": 0, "ragged_tiered_aggregate_q8": 0,
                            "masked_tiered_aggregate": 0, "masked_tiered_aggregate_q8": 0,
                            "masked_ragged_tiered_aggregate": 0, "masked_ragged_tiered_aggregate_q8": 0}
    cpu = synchronize({"frontend": {}, "units": [{k: v.cpu() for k, v in u.items()}
                                                 for u in params["units"]], "head": {}},
                      plan, 1, compressor=compressor)
    for a, b in zip(got["units"], cpu["units"]):
        for k in a:
            lsb = float(b[k].abs().max()) / 127 if codec else 1e-6
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=1e-5, atol=lsb)


def _mask(kind, N, J, g, device):
    if kind == "all zero":
        return torch.zeros(N, device=device)
    if kind == "all ones":
        return torch.ones(N, device=device)
    m = (torch.rand(N, generator=g, device=device) < 0.6).float()
    if kind == "zero groups":
        m[: N // J] = 0.0
    return m


def _silent(mask, J, de, dg):
    N = mask.shape[0]
    if dg:
        return torch.full((N,), bool(mask.sum() == 0), device=mask.device)
    if de:
        return (mask.reshape(J, -1).sum(1) == 0).repeat_interleave(N // J)
    return torch.zeros(N, dtype=torch.bool, device=mask.device)


MASK_KINDS = ["random", "zero groups", "all zero", "all ones"]


@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("N,J,P", [(8, 4, 700), (20, 5, 2049), (4, 1, 100), (6, 6, 257)])
def test_b1m_kernel_matches_plain(cuda, kind, N, J, P):
    """f32 at the dense sync's tolerance, bf16 one ulp beyond it; the rows
    of a group without a participant are ``keep`` bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(P)
    mask = _mask(kind, N, J, g, cuda)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(N, P, generator=g, device=cuda).to(dtype)
        keep = torch.randn(N, P, generator=g, device=cuda).to(dtype)
        for de, dg in FLAGS:
            for k in (x, keep):
                reset_launches()
                out = masked_tiered_aggregate(x, mask, k, de, dg, J)
                torch.cuda.synchronize()
                assert launches["masked_tiered_aggregate"] == 1
                ref = masked_tiered_aggregate_ref(x, mask, k, de, dg, J)
                assert out.dtype == dtype
                o, r = out.float(), ref.float()
                tol = 1e-6 + 1e-5 * r.abs()
                if dtype == torch.bfloat16:
                    _, exp = torch.frexp(r)
                    tol = tol + torch.ldexp(torch.ones_like(r), exp - 8)
                assert bool(((o - r).abs() <= tol).all()), (kind, dtype, de, dg)
                rows = _silent(mask, J, de, dg)
                assert torch.equal(out[rows], k[rows])


@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("N,J,P,tile", [(20, 5, 1728, 256), (20, 1, 512, 256),
                                        (6, 2, 1000, 128)])
def test_b1m_int8_load_matches_plain(cuda, kind, N, J, P, tile):
    g = torch.Generator(device=cuda).manual_seed(P + 1)
    mask = _mask(kind, N, J, g, cuda)
    x = torch.randn(N, P, generator=g, device=cuda)
    keep = torch.randn(N, P, generator=g, device=cuda)
    q, s = q8_quantize(x, tile)
    for de, dg in FLAGS:
        out = masked_quantized_tiered_aggregate(q, s, mask, keep, de, dg, J, tile)
        torch.cuda.synchronize()
        assert out.shape == (N, P)
        torch.testing.assert_close(
            out, masked_quantized_tiered_aggregate_ref(q, s, mask, keep, de, dg, J, tile),
            rtol=1e-5, atol=1e-6)
        rows = _silent(mask, J, de, dg)
        assert torch.equal(out[rows], keep[rows])


@pytest.mark.parametrize("codec", [None, 128])
@pytest.mark.parametrize("kind", ["random", "zero groups", "all zero"])
def test_masked_sync_on_card_matches_cpu_and_counts_launches(cuda, codec, kind):
    plan = default_plan(REDUCED.n_units, 4, cuts=(1, 3), intervals=(2, 2, 1),
                        entities=(4, 2, 1))
    state = init_state_a(VggModel(REDUCED), plan, sgd(0.1),
                         torch.Generator().manual_seed(0), cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    params = {"frontend": {}, "head": {}, "units": [
        {k: v + torch.randn(v.shape, generator=g, device=cuda) for k, v in u.items()}
        for u in state.params["units"]]}
    mask = _mask(kind, 4, 2, g, cuda)
    compressor = Int8Stochastic(codec) if codec else None
    reset_launches()
    got = synchronize(params, plan, 1, compressor=compressor, mask=mask)
    torch.cuda.synchronize()
    # as the unmasked sync's launches, each on B1m
    want = {"masked_tiered_aggregate": 8, "masked_tiered_aggregate_q8": 6} if codec else {
        "masked_tiered_aggregate": 10, "masked_tiered_aggregate_q8": 0}
    assert launches == {"tiered_aggregate": 0, "tiered_aggregate_q8": 0,
                        "ragged_tiered_aggregate": 0, "ragged_tiered_aggregate_q8": 0,
                        "masked_ragged_tiered_aggregate": 0, "masked_ragged_tiered_aggregate_q8": 0, **want}
    cpu = synchronize({"frontend": {}, "head": {}, "units": [
        {k: v.cpu() for k, v in u.items()} for u in params["units"]]}, plan, 1,
        compressor=compressor, mask=mask.cpu())
    for a, b, c in zip(got["units"], cpu["units"], params["units"]):
        for k in a:
            if kind == "all zero":
                assert torch.equal(a[k], c[k])
            lsb = float(b[k].abs().max()) / 127 if codec else 1e-6
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=1e-5, atol=lsb)


def test_masked_step_all_zero_is_an_exact_no_op_on_card(cuda):
    plan = default_plan(REDUCED.n_units, 4, cuts=(1, 3), intervals=(2, 2, 1),
                        entities=(4, 2, 1))
    model, opt = VggModel(REDUCED), sgd(0.1)
    state = init_state_a(model, plan, opt, torch.Generator().manual_seed(0), cuda)
    dispatch = make_dispatch(model, plan, opt, compressor=Int8Stochastic(128))
    g = torch.Generator(device=cuda).manual_seed(4)
    hw = REDUCED.image_size
    for r in range(2):
        batch = {"images": torch.randn(4, 2, hw, hw, 3, generator=g, device=cuda),
                 "labels": torch.randint(0, 10, (4, 2), generator=g, device=cuda,
                                         dtype=torch.int32)}
        new, loss = dispatch(state, batch, r, torch.zeros(4, device=cuda))
        assert float(loss) == 0.0
        for a, b in zip(new.params["units"], state.params["units"]):
            assert all(torch.equal(a[k], b[k]) for k in a)
        state = new


def _members(N, J, U, g, device):
    """All ones, alternating, an entity group with no member, none, and for
    U > 1 a random [N, U] matrix."""
    per = N // J
    empty = torch.ones(N, U, device=device)
    empty[:per] = 0.0
    out = [torch.ones(N, U, device=device),
           (torch.arange(N, device=device) % 2).float()[:, None].expand(N, U).contiguous(),
           empty, torch.zeros(N, U, device=device)]
    if U > 1:
        out.append((torch.rand(N, U, generator=g, device=device) > 0.5).float())
    return out


# (N, J, P, U, tile): the JAX package's ragged shapes, then stacked [N, U·E] rows
@pytest.mark.parametrize("N,J,P,U,tile", [(20, 5, 999, 1, 128), (6, 2, 257, 1, 128),
                                          (16, 4, 2048, 1, 256), (8, 4, 64 * 30, 30, 128),
                                          (20, 5, 7 * 3, 7, 128)])
def test_b3_and_twin_match_plain(cuda, N, J, P, U, tile):
    g = torch.Generator(device=cuda).manual_seed(P + U)
    x = torch.randn(N, P, generator=g, device=cuda)
    w = torch.softmax(torch.randn(N, generator=g, device=cuda), 0)
    q, s = q8_quantize(x, tile)
    for m in _members(N, J, U, g, cuda):
        for de, dg in FLAGS:
            out = ragged_tiered_aggregate(x, w, m, de, dg, J)
            b3 = ragged_quantized_tiered_aggregate(q, s, w, m, de, dg, J, tile, width=P)
            torch.cuda.synchronize()
            # f32 sums in another order: a few ulp, as B1/B2
            torch.testing.assert_close(out, ragged_tiered_aggregate_ref(x, w, m, de, dg, J),
                                       rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(
                b3, ragged_quantized_tiered_aggregate_ref(q, s, w, m, de, dg, J, tile, P),
                rtol=1e-5, atol=1e-6)
            keep = m.repeat_interleave(P // U, dim=1) == 0
            assert torch.equal(out[keep], x[keep])  # the twin keeps non-members exactly


@pytest.mark.parametrize("codec", [None, 128])
def test_ragged_sync_on_card_matches_cpu_and_counts_launches(cuda, codec):
    N = 8
    plan = default_plan(REDUCED.n_units, N, cuts=(3, 4), intervals=(2, 3, 1),
                        entities=(N, 4, 1))
    state = init_state_a(VggModel(REDUCED), plan, sgd(0.1),
                         torch.Generator().manual_seed(0), cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    params = {"frontend": {}, "head": {}, "units": [
        {k: v + torch.randn(v.shape, generator=g, device=cuda) for k, v in u.items()}
        for u in state.params["units"]]}
    cc, co = [(3, 4), (1, 2)], [0, 1] * 4
    compressor = Int8Stochastic(codec) if codec else None
    reset_launches()
    got = ragged_synchronize(params, plan, class_tier_members(5, cc, co, cuda), 5,
                             compressor=compressor)
    torch.cuda.synchronize()
    # round 6: every fed level.  (unit, tier) pairs some client holds:
    # tier 0 units 0-2 (fed only: J0 = N), tier 1 units 1 and 3 (entity and
    # fed), tier 2 units 2-4; 2 leaves each.  The int8 wire moves tier 0's
    # launches and tier 1's fed mean to B3.
    if codec:
        want = {"ragged_tiered_aggregate": 10, "ragged_tiered_aggregate_q8": 10}
    else:
        want = {"ragged_tiered_aggregate": 16, "ragged_tiered_aggregate_q8": 0}
    assert launches == {"tiered_aggregate": 0, "tiered_aggregate_q8": 0,
                        "masked_tiered_aggregate": 0, "masked_tiered_aggregate_q8": 0,
                        "masked_ragged_tiered_aggregate": 0, "masked_ragged_tiered_aggregate_q8": 0, **want}
    cpu_params = {"frontend": {}, "head": {}, "units": [
        {k: v.cpu() for k, v in u.items()} for u in params["units"]]}
    cpu = ragged_synchronize(cpu_params, plan, class_tier_members(5, cc, co, "cpu"), 5,
                             compressor=compressor)
    for a, b in zip(got["units"], cpu["units"]):
        for k in a:
            lsb = float(b[k].abs().max()) / 127 if codec else 1e-6
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=1e-5, atol=lsb)


def test_torch_backend_tables_on_card_bit_equal_numpy(cuda):
    import dataclasses

    import numpy as np

    from repro_torch.configs.vgg16_cifar10 import SPEC
    from repro_torch.core import (
        ClassBatchedEvaluator, CutClassSpec, HsflProblem, SystemSpec, build_profile,
        synthetic_hyperspec, theorem1_bound,
    )

    system = SystemSpec.paper_three_tier(seed=0)
    slow = np.ones(20)
    slow[1::2] = 1 / 8.0
    system = dataclasses.replace(system, act_up=(system.act_up[0] * slow, system.act_up[1]))
    hp = synthetic_hyperspec(16, 20, beta=3.0, seed=0)
    p = HsflProblem(build_profile(SPEC, batch=16), system, hp,
                    eps=10 * theorem1_bound(hp, 10**9, [1, 1, 1], (3, 8)))
    ev_t, ev_n = p.evaluator("torch"), p.evaluator("numpy")
    for name in ("split", "agg", "d", "mem_ok"):
        np.testing.assert_array_equal(getattr(ev_t, name), getattr(ev_n, name))
    spec = CutClassSpec.uniform(20, 2, (3, 8))
    np.testing.assert_array_equal(ClassBatchedEvaluator(p, spec, "torch").split_class,
                                  ClassBatchedEvaluator(p, spec, "numpy").split_class)


# B, S, H, K, hd, window: the JAX package's cases, the CLI's ragged S=64
# tile and REDUCED qwen2.5's hd 32 with GQA 4:1
SWA_CASES = [(1, 256, 4, 2, 64, 128), (2, 384, 4, 4, 128, 256), (1, 512, 8, 2, 80, 0),
             (1, 300, 4, 1, 64, 128), (1, 256, 6, 3, 96, 128), (1, 640, 4, 2, 64, 512),
             (32, 64, 3, 3, 64, 0), (8, 256, 8, 2, 32, 0)]


def _normalised_err(a, b):
    return float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-9))


@pytest.mark.parametrize("case", SWA_CASES, ids=[str(c) for c in SWA_CASES])
def test_b4_b5_kernels_match_plain(cuda, case):
    """Forward at rtol = atol 2e-5; each backward pass within 2e-5 of
    max|ref|, on the same inputs as its plain version."""
    B, S, H, K, hd, W = case
    g = torch.Generator(device=cuda).manual_seed(sum(case))
    q, do = (torch.randn(B, S, H, hd, generator=g, device=cuda) for _ in range(2))
    k, v = (torch.randn(B, S, K, hd, generator=g, device=cuda) for _ in range(2))
    swa.reset_launches()
    o, lse = swa.swa_attention_fwd(q, k, v, W)
    dq, delta = swa.swa_attention_bwd_dq(q, k, v, o, lse, do, W)
    dk, dv = swa.swa_attention_bwd_dkv(q, k, v, lse, delta, do, W)
    torch.cuda.synchronize()
    assert swa.launches == dict.fromkeys(swa.launches, 1)
    ro, rlse = swa.swa_attention_ref(q, k, v, W)
    torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, rlse, rtol=2e-5, atol=2e-5)
    rdq, rdelta = swa.swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W)
    rdk, rdv = swa.swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W)
    for a, b in ((dq, rdq), (delta, rdelta), (dk, rdk), (dv, rdv)):
        assert _normalised_err(a, b) <= 2e-5


def test_b4_bf16_forward_within_3e_2(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(1, 256, 4, 64, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(1, 256, 2, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
    o, lse = swa.swa_attention_fwd(q, k, v, 128)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = swa.swa_attention_ref(q.float(), k.float(), v.float(), 128)
    torch.testing.assert_close(o.float(), ref, rtol=0, atol=3e-2)


def test_b4_b5_raise_on_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 64, 4, 48, device=cuda)
    k = torch.randn(1, 64, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        swa.swa_attention_fwd(q, k, k, 0)
    q = torch.randn(1, 64, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        swa.swa_attention_fwd(q, q[:, :, :2], q[:, :, :2], 0)


def test_vmap_grad_makes_one_launch_of_each_kernel_for_all_clients(cuda):
    N = 4
    g = torch.Generator(device=cuda).manual_seed(3)
    q, dd = (torch.randn(N, 2, 128, 6, 32, generator=g, device=cuda) for _ in range(2))
    k, v = (torch.randn(N, 2, 128, 2, 32, generator=g, device=cuda) for _ in range(2))

    def loss(q, k, v, dd):
        return (swa.swa_attention(q, k, v, 64) * dd).sum()

    def loss_plain(q, k, v, dd):
        return (swa.swa_attention_ref(q, k, v, 64)[0] * dd).sum()

    swa.reset_launches()
    grads, val = vmap(grad_and_value(loss, argnums=(0, 1, 2)))(q, k, v, dd)
    torch.cuda.synchronize()
    assert swa.launches == dict.fromkeys(swa.launches, 1)
    ref, val_ref = vmap(grad_and_value(loss_plain, argnums=(0, 1, 2)))(q, k, v, dd)
    torch.testing.assert_close(val, val_ref, rtol=1e-5, atol=1e-3)
    for a, b in zip(grads, ref):
        assert _normalised_err(a, b) <= 2e-5


@pytest.mark.parametrize("window", [0, 128])
def test_reduced_smollm_on_card_matches_cpu(cuda, window):
    spec = get_reduced("smollm-135m").with_window(window)
    model = SplittableModel(spec)
    N, b, S = 4, 2, 256
    plan = default_plan(spec.n_units, N, cuts=(1, 2), intervals=(2, 2, 1), entities=(N, 2, 1))
    rng = torch.Generator().manual_seed(0)
    toks = [torch.randint(0, spec.vocab_size, (N, b, S + 1), generator=rng, dtype=torch.int32)
            for _ in range(2)]
    losses = {}
    for device in (cuda, torch.device("cpu")):
        state = init_state_a(model, plan, sgd(0.05), torch.Generator().manual_seed(0), device)
        dispatch = make_dispatch(model, plan, sgd(0.05))
        losses[device.type] = []
        for r, t in enumerate(toks):
            batch = {"tokens": t[..., :-1].numpy(), "labels": t[..., 1:].numpy()}
            state, loss = dispatch(state, to_device(batch, device), r)
            losses[device.type].append(float(loss))
    torch.testing.assert_close(torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
                               rtol=1e-4, atol=0)


def _qkv(cuda, B, S, H, K, hd, dtype=torch.float32, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, S, K, hd, generator=g, device=cuda).to(dtype) for _ in range(2))
    return q, k, v


def _offset_view(cuda, *shape, seed):
    """A contiguous f32 tensor one float into its storage: off 16-byte alignment."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(math.prod(shape) + 1, generator=g, device=cuda)[1:].view(*shape)


@pytest.mark.parametrize("hd", swa.HEAD_DIMS)
@pytest.mark.parametrize("S", [65, 1000])
def test_b4_matches_plain_across_head_dims_groups_and_windows(cuda, hd, S):
    """o and lse at the forward's rtol = atol 2e-5 (the JAX forward test's)
    at a ragged S, G = 1, 3, 4 and windows 0, 64, 128, >= S."""
    for G in (1, 3, 4):
        for W in (0, 64, 128, S + 7):
            q, k, v = _qkv(cuda, 2, S, 2 * G, 2, hd, seed=hd + G + W)
            o, lse = swa.swa_attention_fwd(q, k, v, W)
            torch.cuda.synchronize()
            ro, rlse = swa.swa_attention_ref(q, k, v, W)
            torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5, msg=f"o G={G} window={W}")
            torch.testing.assert_close(lse, rlse, rtol=2e-5, atol=2e-5,
                                       msg=f"lse G={G} window={W}")


@pytest.mark.parametrize("hd", swa.HEAD_DIMS)
def test_b4_bf16_within_one_ulp_of_the_f32_tolerance(cuda, hd):
    """bf16 inputs: o within one bf16 ulp of the f32 plain version on the
    same (bf16) inputs, beyond the f32 tolerance; lse within it."""
    for W in (0, 128):
        q, k, v = _qkv(cuda, 2, 1000, 6, 2, hd, torch.bfloat16, seed=hd)
        o, lse = swa.swa_attention_fwd(q, k, v, W)
        torch.cuda.synchronize()
        assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
        ro, rlse = swa.swa_attention_ref(q.float(), k.float(), v.float(), W)
        torch.testing.assert_close(lse, rlse, rtol=2e-5, atol=2e-5)
        _, exp = torch.frexp(ro)
        ulp = torch.ldexp(torch.ones_like(ro), exp - 8)
        bad = (o.float() - ro).abs() > 2e-5 + 2e-5 * ro.abs() + ulp
        assert not bool(bad.any()), f"window={W}: {int(bad.sum())} elements"


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_b4_two_launches_bit_identical(cuda, hd):
    """No atomics: o and lse repeat bit for bit."""
    q, k, v = _qkv(cuda, 2, 1024, 9, 3, hd)
    first = swa.swa_attention_fwd(q, k, v, 0)
    second = swa.swa_attention_fwd(q, k, v, 0)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_b4_f32_views_off_16_byte_alignment_match_plain(cuda):
    """f32 tensors that cp.async cannot copy 16 bytes at a time take the
    forward's plain loads, same results."""
    B, S, H, K, hd, W = 1, 300, 4, 2, 64, 128
    q = _offset_view(cuda, B, S, H, hd, seed=1)
    k, v = _offset_view(cuda, B, S, K, hd, seed=3), _offset_view(cuda, B, S, K, hd, seed=4)
    assert q.data_ptr() % 16 and q.is_contiguous()
    o, lse = swa.swa_attention_fwd(q, k, v, W)
    torch.cuda.synchronize()
    ro, rlse = swa.swa_attention_ref(q, k, v, W)
    torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, rlse, rtol=2e-5, atol=2e-5)


# B, Sq, Sk, H, K, hd, window, prefix: B4 on wgmma (hd 32, 64) at ragged Sq
# and Sk (G 3 and 1), under a window of whole and of partial kv tiles, with
# a prefix under a window, the encoder's prefix of S, a prefix of Sk with Sq
# < Sk (cross-attention) and Sq > Sk, causal with Sq > Sk under a window
# (every row still sees a key: the plain version has no value for one that
# sees none); then hd 256 (swa_fwd_wg_wide_kernel): paligemma-3b's Engine-B
# shape (prefix 256), causal at a ragged S with G 3, windowed, a prefix of
# Sk with Sq < Sk, Sq > Sk causal under a window, a prefix under a window
WG_FWD_CASES = [(2, 1000, 1000, 6, 2, 64, 0, 0), (1, 300, 300, 4, 4, 32, 0, 0),
                (2, 333, 333, 6, 3, 64, 100, 0), (1, 300, 300, 4, 1, 64, 64, 100),
                (2, 1500, 1500, 4, 4, 64, 0, 1500), (2, 130, 301, 4, 2, 32, 0, 301),
                (2, 301, 130, 4, 2, 64, 0, 130), (1, 130, 97, 6, 2, 32, 48, 0),
                (4, 512, 512, 8, 1, 256, 0, 256), (2, 333, 333, 6, 2, 256, 0, 0),
                (1, 300, 300, 4, 1, 256, 100, 0), (2, 130, 301, 4, 2, 256, 0, 301),
                (1, 130, 97, 6, 2, 256, 48, 0), (1, 300, 300, 4, 1, 256, 64, 100)]


def _wg_fwd_inputs(cuda, case, dtype):
    B, Sq, Sk, H, K, hd = case[:6]
    g = torch.Generator(device=cuda).manual_seed(sum(case))
    q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, Sk, K, hd, generator=g, device=cuda).to(dtype) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WG_FWD_CASES, ids=[str(c) for c in WG_FWD_CASES])
def test_b4_wgmma_matches_plain_and_repeats_bit_for_bit(cuda, case, dtype):
    """swa_fwd_wg_kernel (swa_fwd_wg_wide_kernel at hd 256) against the
    plain version on the same inputs: o and lse at rtol = atol 2e-5 (bf16: o
    within one bf16 ulp beyond it), every output in its own shape; a second
    call equal bit for bit."""
    B, Sq, Sk, H, K, hd, W, P = case
    q, k, v = _wg_fwd_inputs(cuda, case, dtype)
    swa.reset_launches()
    o, lse = swa.swa_attention_fwd(q, k, v, W, P)
    again = swa.swa_attention_fwd(q, k, v, W, P)
    torch.cuda.synchronize()
    assert swa.launches["swa_attention_fwd"] == 2
    assert (o.shape, o.dtype, lse.shape) == (q.shape, dtype, (B, H, Sq))
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    ro, rlse = swa.swa_attention_ref(q.float(), k.float(), v.float(), W, P)
    torch.testing.assert_close(lse, rlse, rtol=2e-5, atol=2e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    else:
        _, exp = torch.frexp(ro)
        ulp = torch.ldexp(torch.ones_like(ro), exp - 8)
        bad = (o.float() - ro).abs() > 2e-5 + 2e-5 * ro.abs() + ulp
        assert not bool(bad.any()), f"{int(bad.sum())} elements"


@pytest.mark.parametrize("hd", [32, 64, 256])
def test_b4_wgmma_f32_views_off_16_byte_alignment_match_plain(cuda, hd):
    """f32 views that TMA cannot read (one float into their storage) take the
    producer's plain loads: the same results within the tolerance, with a
    prefix of Sk and Sq != Sk."""
    B, Sq, Sk, H, K, W, P = 2, 130, 301, 4, 2, 0, 301
    q = _offset_view(cuda, B, Sq, H, hd, seed=1)
    k, v = _offset_view(cuda, B, Sk, K, hd, seed=3), _offset_view(cuda, B, Sk, K, hd, seed=4)
    assert q.data_ptr() % 16 and q.is_contiguous()
    o, lse = swa.swa_attention_fwd(q, k, v, W, P)
    torch.cuda.synchronize()
    ro, rlse = swa.swa_attention_ref(q, k, v, W, P)
    torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, rlse, rtol=2e-5, atol=2e-5)


def _b5_inputs(cuda, B, S, H, K, hd, W, dtype=torch.float32, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, K, hd, generator=g, device=cuda).to(dtype) for _ in range(2))
    o, lse = swa.swa_attention_fwd(q, k, v, W)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("hd", swa.HEAD_DIMS)
@pytest.mark.parametrize("S", [65, 1000])
def test_b5_matches_plain_across_head_dims_groups_and_windows(cuda, hd, S):
    """Both B5 passes within 2e-5 of max|ref| (the f32 tolerance of the JAX
    backward test) at a ragged S, G = 1, 3, 4 and windows 0, 64, 128, >= S."""
    for G in (1, 3, 4):
        for W in (0, 64, 128, S + 7):
            q, k, v, o, lse, do = _b5_inputs(cuda, 2, S, 2 * G, 2, hd, W, seed=hd + G + W)
            dq, delta = swa.swa_attention_bwd_dq(q, k, v, o, lse, do, W)
            dk, dv = swa.swa_attention_bwd_dkv(q, k, v, lse, delta, do, W)
            torch.cuda.synchronize()
            rdq, rdelta = swa.swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W)
            rdk, rdv = swa.swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W)
            for name, a, b in (("dq", dq, rdq), ("delta", delta, rdelta), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
                err = _normalised_err(a, b)
                assert err <= 2e-5, f"{name} G={G} window={W}: {err:.3e}"


@pytest.mark.parametrize("hd", swa.HEAD_DIMS)
def test_b5_bf16_within_one_ulp_of_the_f32_tolerance(cuda, hd):
    """bf16 inputs: each pass's bf16 output within one bf16 ulp of the f32
    plain version on the same (bf16) inputs, beyond the f32 tolerance."""
    for W in (0, 128):
        q, k, v, o, lse, do = _b5_inputs(cuda, 2, 1000, 6, 2, hd, W, torch.bfloat16, seed=hd)
        dq, delta = swa.swa_attention_bwd_dq(q, k, v, o, lse, do, W)
        dk, dv = swa.swa_attention_bwd_dkv(q, k, v, lse, delta, do, W)
        torch.cuda.synchronize()
        assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
        f = [x.float() for x in (q, k, v, o, do)]
        rdq, rdelta = swa.swa_attention_bwd_dq_ref(f[0], f[1], f[2], f[3], lse, f[4], W)
        rdk, rdv = swa.swa_attention_bwd_dkv_ref(f[0], f[1], f[2], lse, delta, f[4], W)
        assert _normalised_err(delta, rdelta) <= 2e-5
        for name, a, b in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
            _, exp = torch.frexp(b)
            ulp = torch.ldexp(torch.ones_like(b), exp - 8)
            bad = (a.float() - b).abs() > 2e-5 * float(b.abs().max()) + ulp
            assert not bool(bad.any()), f"{name} window={W}: {int(bad.sum())} elements"


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_b5_two_launches_bit_identical(cuda, hd):
    """No atomics: dq, delta, dk and dv repeat bit for bit."""
    q, k, v, o, lse, do = _b5_inputs(cuda, 2, 1024, 9, 3, hd, 0)
    first = swa.swa_attention_bwd(q, k, v, o, lse, do, 0)
    _, delta = swa.swa_attention_bwd_dq(q, k, v, o, lse, do, 0)
    second = swa.swa_attention_bwd(q, k, v, o, lse, do, 0)
    _, delta2 = swa.swa_attention_bwd_dq(q, k, v, o, lse, do, 0)
    torch.cuda.synchronize()
    assert torch.equal(delta, delta2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_b5_f32_views_off_16_byte_alignment_match_plain(cuda):
    """f32 tensors that cp.async cannot copy 16 bytes at a time (a view one
    float into its storage) take the kernels' plain loads, same results."""
    B, S, H, K, hd, W = 1, 300, 4, 2, 64, 128
    q, do = _offset_view(cuda, B, S, H, hd, seed=1), _offset_view(cuda, B, S, H, hd, seed=2)
    k, v = _offset_view(cuda, B, S, K, hd, seed=3), _offset_view(cuda, B, S, K, hd, seed=4)
    assert q.data_ptr() % 16 and q.is_contiguous()
    o, lse = swa.swa_attention_fwd(q, k, v, W)
    dq, delta = swa.swa_attention_bwd_dq(q, k, v, o, lse, do, W)
    dk, dv = swa.swa_attention_bwd_dkv(q, k, v, lse, delta, do, W)
    torch.cuda.synchronize()
    rdq, rdelta = swa.swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W)
    rdk, rdv = swa.swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W)
    for a, b in ((dq, rdq), (delta, rdelta), (dk, rdk), (dv, rdv)):
        assert _normalised_err(a, b) <= 2e-5


# B, S, H, K, hd, window, prefix: the VLM's prefix-LM mask, alone and under
# a window, at ragged S, at a tile edge and one past it, at S and past S, and
# paligemma-3b's Engine-B tiers (hd 256, one kv head, prefix 256)
PREFIX_CASES = [(2, 300, 4, 2, 64, 0, 100), (1, 300, 4, 1, 64, 64, 100),
                (1, 130, 4, 2, 256, 48, 70), (2, 256, 8, 1, 256, 0, 33),
                (1, 256, 4, 1, 128, 0, 32), (1, 200, 6, 3, 96, 0, 200),
                (1, 96, 4, 4, 32, 0, 1000), (4, 512, 8, 1, 256, 0, 256)]


def _prefix_passes(q, k, v, do, W, P):
    o, lse = swa.swa_attention_fwd(q, k, v, W, P)
    dq, delta = swa.swa_attention_bwd_dq(q, k, v, o, lse, do, W, P)
    dk, dv = swa.swa_attention_bwd_dkv(q, k, v, lse, delta, do, W, P)
    return o, lse, dq, delta, dk, dv


@pytest.mark.parametrize("case", PREFIX_CASES, ids=[str(c) for c in PREFIX_CASES])
def test_b4_b5_with_a_prefix_match_plain(cuda, case):
    """The forward at rtol = atol 2e-5, each backward pass within 2e-5 of
    max|ref|, against the plain versions under the JAX package's mask."""
    B, S, H, K, hd, W, P = case
    q, k, v = _qkv(cuda, B, S, H, K, hd, seed=sum(case))
    do = torch.randn_like(q)
    o, lse, dq, delta, dk, dv = _prefix_passes(q, k, v, do, W, P)
    torch.cuda.synchronize()
    ro, rlse = swa.swa_attention_ref(q, k, v, W, P)
    torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, rlse, rtol=2e-5, atol=2e-5)
    rdq, rdelta = swa.swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W, P)
    rdk, rdv = swa.swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W, P)
    for name, a, b in (("dq", dq, rdq), ("delta", delta, rdelta), ("dk", dk, rdk),
                       ("dv", dv, rdv)):
        err = _normalised_err(a, b)
        assert err <= 2e-5, f"{name}: {err:.3e}"


# B, Sq, Sk, H, K, hd, window, prefix: Sq != Sk.  Unmasked (prefix Sk):
# whisper-large-v3's Engine-B cross-attention [4, 448] x [4, 1500], Sq > Sk,
# one query, hd 256; causal and windowed with Sq != Sk (key tiles that no
# query row reaches); and the encoder's bidirectional self-attention (prefix
# S, G = 1, S = 1500: a ragged last tile at every tile size), under a window
CROSS_CASES = [(4, 448, 1500, 20, 20, 64, 0, 1500), (2, 100, 37, 4, 2, 64, 0, 37),
               (2, 1, 300, 4, 4, 128, 0, 300), (1, 65, 200, 8, 1, 256, 0, 200),
               (1, 130, 60, 4, 2, 32, 0, 0), (1, 60, 130, 4, 2, 80, 0, 0),
               (1, 60, 130, 6, 3, 96, 16, 0), (4, 1500, 1500, 20, 20, 64, 0, 1500),
               (2, 1500, 1500, 2, 1, 32, 300, 1500)]


@pytest.mark.parametrize("case", CROSS_CASES, ids=[str(c) for c in CROSS_CASES])
def test_b4_b5_with_sq_other_than_sk_match_plain(cuda, case):
    """q [B, Sq, H, hd] against k, v [B, Sk, K, hd]: the forward at rtol =
    atol 2e-5, each backward pass within 2e-5 of max|ref|, every output in
    its own shape."""
    B, Sq, Sk, H, K, hd, W, P = case
    g = torch.Generator(device=cuda).manual_seed(sum(case))
    q, do = (torch.randn(B, Sq, H, hd, generator=g, device=cuda) for _ in range(2))
    k, v = (torch.randn(B, Sk, K, hd, generator=g, device=cuda) for _ in range(2))
    o, lse, dq, delta, dk, dv = _prefix_passes(q, k, v, do, W, P)
    torch.cuda.synchronize()
    assert (o.shape, lse.shape, dk.shape) == (q.shape, (B, H, Sq), k.shape)
    ro, rlse = swa.swa_attention_ref(q, k, v, W, P)
    torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, rlse, rtol=2e-5, atol=2e-5)
    rdq, rdelta = swa.swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W, P)
    rdk, rdv = swa.swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W, P)
    for name, a, b in (("dq", dq, rdq), ("delta", delta, rdelta), ("dk", dk, rdk),
                       ("dv", dv, rdv)):
        err = _normalised_err(a, b)
        assert err <= 2e-5, f"{name}: {err:.3e}"


def test_b4_b5_bf16_at_the_cross_shape_within_one_ulp(cuda):
    """bf16 inputs at whisper's cross-attention shape against the f32 plain
    version on the same inputs: o and each backward pass's outputs within
    one bf16 ulp of each value beyond the f32 tolerance of max|ref|."""
    B, Sq, Sk, H, K, hd = 4, 448, 1500, 20, 20, 64
    g = torch.Generator(device=cuda).manual_seed(5)
    q, do = (torch.randn(B, Sq, H, hd, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, Sk, K, hd, generator=g, device=cuda).bfloat16() for _ in range(2))
    o, lse, dq, delta, dk, dv = _prefix_passes(q, k, v, do, 0, Sk)
    torch.cuda.synchronize()
    f = [x.float() for x in (q, k, v, o, do)]
    ro, _ = swa.swa_attention_ref(f[0], f[1], f[2], 0, Sk)
    rdq, _ = swa.swa_attention_bwd_dq_ref(f[0], f[1], f[2], f[3], lse, f[4], 0, Sk)
    rdk, rdv = swa.swa_attention_bwd_dkv_ref(f[0], f[1], f[2], lse, delta, f[4], 0, Sk)
    for got, ref in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
        _, exp = torch.frexp(ref)
        ulp = torch.ldexp(torch.ones_like(ref), exp - 8)  # one bf16 ulp of each value
        assert bool(((got.float() - ref).abs() <= 2e-5 * ref.abs().max() + ulp).all())


def test_b4d_cross_route_matches_plain(cuda):
    """A decode step's cross-attention: one query against every slot of
    non-zero caches [8, 1500, 20, 64], every slot at position 0 (B4d admits
    0 <= p <= q_pos), against the plain version at rtol = atol 2e-5."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(8, 1, 20, 64, generator=g, device=cuda)
    k, v = (torch.randn(8, 1500, 20, 64, generator=g, device=cuda) for _ in range(2))
    slots = torch.zeros(1500, dtype=torch.int32, device=cuda)
    for p in (0, 37):
        qp = torch.tensor([p], dtype=torch.int32, device=cuda)
        got = swa.swa_decode(q, k, v, slots, qp)
        torch.testing.assert_close(got, swa.swa_decode_ref(q, k, v, slots, qp),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", swa.HEAD_DIMS)
def test_prefix_zero_and_one_give_the_causal_kernels_bit_for_bit(cuda, hd):
    """Causal attention (window 0): a call without a prefix, prefix 0 and
    prefix 1 (key 0, which every query sees anyway) give the same bits."""
    q, k, v = _qkv(cuda, 2, 300, 4, 2, hd, seed=hd)
    do = torch.randn_like(q)
    o, lse = swa.swa_attention_fwd(q, k, v, 0)
    dq, delta = swa.swa_attention_bwd_dq(q, k, v, o, lse, do, 0)
    dk, dv = swa.swa_attention_bwd_dkv(q, k, v, lse, delta, do, 0)
    plain = (o, lse, dq, delta, dk, dv)
    for P in (0, 1):
        for a, b in zip(plain, _prefix_passes(q, k, v, do, 0, P)):
            assert torch.equal(a, b), f"prefix {P}"


def test_paligemma_shape_repeats_bit_for_bit(cuda):
    """B4 and both B5 passes at paligemma-3b's Engine-B shape (hd 256,
    prefix 256): two calls give the same bits (no atomics)."""
    q, k, v = _qkv(cuda, 4, 512, 8, 1, 256, seed=3)
    do = torch.randn_like(q)
    first = _prefix_passes(q, k, v, do, 0, 256)
    second = _prefix_passes(q, k, v, do, 0, 256)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_b4_b5_bf16_at_paligemma_shape_within_one_ulp(cuda):
    """bf16 at hd 256 with the prefix: o and each backward output within one
    bf16 ulp beyond the f32 tolerance of the f32 plain version on the same
    bf16 inputs."""
    B, S, H, K, hd, W, P = 4, 512, 8, 1, 256, 0, 256
    q, k, v = _qkv(cuda, B, S, H, K, hd, torch.bfloat16, seed=5)
    do = torch.randn_like(q)
    o, lse, dq, delta, dk, dv = _prefix_passes(q, k, v, do, W, P)
    torch.cuda.synchronize()
    f = [x.float() for x in (q, k, v, o, do)]
    ro, rlse = swa.swa_attention_ref(f[0], f[1], f[2], W, P)
    torch.testing.assert_close(lse, rlse, rtol=2e-5, atol=2e-5)
    rdq, _ = swa.swa_attention_bwd_dq_ref(f[0], f[1], f[2], f[3], lse, f[4], W, P)
    rdk, rdv = swa.swa_attention_bwd_dkv_ref(f[0], f[1], f[2], lse, delta, f[4], W, P)
    for name, a, b, scale in (("o", o, ro, None), ("dq", dq, rdq, 1), ("dk", dk, rdk, 1),
                              ("dv", dv, rdv, 1)):
        _, exp = torch.frexp(b)
        ulp = torch.ldexp(torch.ones_like(b), exp - 8)
        tol = (2e-5 + 2e-5 * b.abs() if scale is None else 2e-5 * float(b.abs().max())) + ulp
        bad = (a.float() - b).abs() > tol
        assert not bool(bad.any()), f"{name}: {int(bad.sum())} elements"


# hd 256 where the 8-warp dk/dv pass's splits (``dkv_splits``) meet an edge,
# (B, Sq, Sk, H, K, hd, window, prefix): G not a multiple of the split count
# (G 6 in 4 splits on an H100's 132 SMs, G 4 in 3), kv tiles that no q row
# sees (Sq < Sk, causal) and a window of 48, ragged Sq and Sk (130, 300),
# and batch 1, where the split count is largest (8)
WIDE_EDGE_CASES = [(4, 512, 512, 6, 1, 256, 0, 0), (2, 512, 512, 8, 2, 256, 0, 256),
                   (1, 100, 300, 4, 1, 256, 0, 0), (1, 300, 300, 4, 1, 256, 48, 0),
                   (1, 130, 300, 8, 2, 256, 0, 300), (1, 300, 130, 6, 1, 256, 0, 0),
                   (1, 512, 512, 8, 1, 256, 0, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WIDE_EDGE_CASES, ids=[str(c) for c in WIDE_EDGE_CASES])
def test_wide_b5_at_the_split_edges_matches_plain_and_repeats(cuda, case, dtype):
    """Both hd-256 passes against the plain versions on the same inputs
    (f32: within 2e-5 of max|ref|; bf16: against the f32 plain version, one
    bf16 ulp of each value beyond that), the dk/dv pass in the split count
    the wrapper launches (the merge counted with it, one launch a call),
    and a second call equal bit for bit."""
    B, Sq, Sk, H, K, hd, W, P = case
    g = torch.Generator(device=cuda).manual_seed(sum(case))
    q, do = (torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, Sk, K, hd, generator=g, device=cuda).to(dtype) for _ in range(2))
    swa.reset_launches()
    first = _prefix_passes(q, k, v, do, W, P)
    second = _prefix_passes(q, k, v, do, W, P)
    torch.cuda.synchronize()
    assert swa.launches["swa_attention_bwd_dkv"] == 2
    assert swa.dkv_launch_splits(q, k, W, P) == swa.dkv_splits(
        B, Sq, Sk, K, H // K, hd, swa.ops.effective_window(W, Sq),
        swa.ops.effective_prefix(P, Sk), torch.cuda.get_device_properties(cuda).multi_processor_count)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    o, lse, dq, delta, dk, dv = first
    f = [x.float() for x in (q, k, v, o, do)]
    rdq, rdelta = swa.swa_attention_bwd_dq_ref(f[0], f[1], f[2], f[3], lse, f[4], W, P)
    rdk, rdv = swa.swa_attention_bwd_dkv_ref(f[0], f[1], f[2], lse, delta, f[4], W, P)
    assert _normalised_err(delta, rdelta) <= 2e-5
    for name, a, b in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert a.dtype == dtype
        tol = 2e-5 * float(b.abs().max())
        if dtype == torch.bfloat16:
            _, exp = torch.frexp(b)
            tol = tol + torch.ldexp(torch.ones_like(b), exp - 8)  # one bf16 ulp of each value
        bad = (a.float() - b).abs() > tol
        assert not bool(bad.any()), f"{name}: {int(bad.sum())} elements"


# B5 at hd 128 on wgmma (swa_bwd_dq_wg_half_kernel, swa_bwd_dkv_wg_half_kernel
# in the split count the wrapper launches), (B, Sq, Sk, H, K, hd, window,
# prefix): qwen2-1.5b's Engine-B shape (G 6), causal at a ragged S with G 1
# and 4, a window, a prefix at a kv tile's edge and one past it, a prefix
# under a window, the encoder's prefix of S, Sq != Sk under a prefix of Sk
# (one query among them) and causal with Sq > Sk, and a window with Sq > Sk
HALF_CASES = [(4, 1024, 1024, 12, 2, 128, 0, 0), (2, 333, 333, 4, 4, 128, 0, 0),
              (1, 300, 300, 8, 2, 128, 100, 0), (1, 256, 256, 6, 1, 128, 0, 64),
              (1, 256, 256, 6, 1, 128, 0, 65), (1, 300, 300, 4, 1, 128, 64, 100),
              (2, 500, 500, 4, 4, 128, 0, 500), (2, 130, 301, 12, 2, 128, 0, 301),
              (2, 1, 300, 4, 4, 128, 0, 300), (2, 301, 130, 6, 1, 128, 0, 0),
              (1, 130, 97, 6, 2, 128, 48, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", HALF_CASES, ids=[str(c) for c in HALF_CASES])
def test_half_b5_at_hd_128_matches_plain_and_repeats(cuda, case, dtype):
    """Both hd-128 passes against the plain versions on the same inputs
    (f32: within 2e-5 of max|ref|; bf16: against the f32 plain version, one
    bf16 ulp of each value beyond that), delta within 2e-5, one launch a
    call each, and a second call equal bit for bit."""
    B, Sq, Sk, H, K, hd, W, P = case
    g = torch.Generator(device=cuda).manual_seed(sum(case))
    q, do = (torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, Sk, K, hd, generator=g, device=cuda).to(dtype) for _ in range(2))
    swa.reset_launches()
    first = _prefix_passes(q, k, v, do, W, P)
    second = _prefix_passes(q, k, v, do, W, P)
    torch.cuda.synchronize()
    assert swa.launches["swa_attention_bwd_dq"] == swa.launches["swa_attention_bwd_dkv"] == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    o, lse, dq, delta, dk, dv = first
    f = [x.float() for x in (q, k, v, o, do)]
    rdq, rdelta = swa.swa_attention_bwd_dq_ref(f[0], f[1], f[2], f[3], lse, f[4], W, P)
    rdk, rdv = swa.swa_attention_bwd_dkv_ref(f[0], f[1], f[2], lse, delta, f[4], W, P)
    assert _normalised_err(delta, rdelta) <= 2e-5
    for name, a, b in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert a.dtype == dtype and a.shape == b.shape
        tol = 2e-5 * float(b.abs().max())
        if dtype == torch.bfloat16:
            _, exp = torch.frexp(b)
            tol = tol + torch.ldexp(torch.ones_like(b), exp - 8)  # one bf16 ulp of each value
        bad = (a.float() - b).abs() > tol
        assert not bool(bad.any()), f"{name}: {int(bad.sum())} elements"


def test_half_b5_f32_views_off_16_byte_alignment_match_plain(cuda):
    """f32 views that TMA cannot read take the producer's plain loads at hd
    128 too: within the tolerance, with a prefix of Sk and Sq != Sk."""
    B, Sq, Sk, H, K, hd, W, P = 2, 130, 301, 4, 2, 128, 0, 301
    q, do = _offset_view(cuda, B, Sq, H, hd, seed=1), _offset_view(cuda, B, Sq, H, hd, seed=2)
    k, v = _offset_view(cuda, B, Sk, K, hd, seed=3), _offset_view(cuda, B, Sk, K, hd, seed=4)
    assert q.data_ptr() % 16 and q.is_contiguous()
    o, lse, dq, delta, dk, dv = _prefix_passes(q, k, v, do, W, P)
    torch.cuda.synchronize()
    rdq, rdelta = swa.swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W, P)
    rdk, rdv = swa.swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W, P)
    for a, b in ((dq, rdq), (delta, rdelta), (dk, rdk), (dv, rdv)):
        assert _normalised_err(a, b) <= 2e-5


# --------------------------------------------------------------------------- #
# costs and robustness: B3m, the guarded step, DP, async
# --------------------------------------------------------------------------- #


def _b3m_members(N, U, device):
    odd = (torch.arange(N, device=device) % 2).float()[:, None].expand(N, U).contiguous()
    return {"odd": odd, "even": 1.0 - odd, "all": torch.ones(N, U, device=device),
            "none": torch.zeros(N, U, device=device)}


def _b3m_mask(kind, N, J, g, device):
    if kind == "all-ones":
        return torch.ones(N, device=device)
    if kind == "all-zero":
        return torch.zeros(N, device=device)
    if kind == "7-of-N":
        m = torch.zeros(N, device=device)
        m[torch.randperm(N, generator=g, device=device)[:min(7, N - 1)]] = 1.0
        return m
    m = torch.ones(N, device=device)
    m[:N // J] = 0.0
    return m


@pytest.mark.parametrize("kind", ["all-ones", "all-zero", "7-of-N", "silent group"])
@pytest.mark.parametrize("N,J,P,U", [(20, 5, 2049, 1), (20, 1, 1728, 1), (8, 4, 30 * 64, 30),
                                     (6, 3, 257, 1)])
def test_b3m_kernel_matches_plain(cuda, kind, N, J, P, U):
    """B3m: f32 at the dense sync's tolerance, bf16 one ulp beyond it, the
    int8 load at f32's; each launch counted once; an all-zero mask returns
    ``keep`` bit for bit, and so does every non-member element."""
    from repro_torch.kernels.tiered_aggregate import (
        masked_ragged_quantized_tiered_aggregate, masked_ragged_quantized_tiered_aggregate_ref,
        masked_ragged_tiered_aggregate, masked_ragged_tiered_aggregate_ref,
    )

    g = torch.Generator(device=cuda).manual_seed(P + U)
    mask = _b3m_mask(kind, N, J, g, cuda)
    x = torch.randn(N, P, generator=g, device=cuda)
    keep = torch.randn(N, P, generator=g, device=cuda)
    q, s = q8_quantize(x, 128)
    for name, m in _b3m_members(N, U, cuda).items():
        nonmember = (m == 0).repeat_interleave(P // U, dim=1)
        for de, dg in FLAGS:
            for dtype in (torch.float32, torch.bfloat16):
                xx, kk = x.to(dtype), keep.to(dtype)
                reset_launches()
                out = masked_ragged_tiered_aggregate(xx, mask, m, kk, de, dg, J)
                torch.cuda.synchronize()
                assert launches["masked_ragged_tiered_aggregate"] == 1
                r = masked_ragged_tiered_aggregate_ref(xx, mask, m, kk, de, dg, J).float()
                tol = 1e-6 + 1e-5 * r.abs()
                if dtype == torch.bfloat16:
                    _, exp = torch.frexp(r)
                    tol = tol + torch.ldexp(torch.ones_like(r), exp - 8)
                assert bool(((out.float() - r).abs() <= tol).all()), (name, de, dg, dtype)
                if de or dg:
                    assert torch.equal(out[nonmember], kk[nonmember])
                    if kind == "all-zero":
                        assert torch.equal(out, kk)
            oq = masked_ragged_quantized_tiered_aggregate(q, s, mask, m, keep, de, dg, J, 128)
            torch.cuda.synchronize()
            torch.testing.assert_close(oq, masked_ragged_quantized_tiered_aggregate_ref(
                q, s, mask, m, keep, de, dg, J, 128), rtol=1e-5, atol=1e-6)


def _reduced_vgg_batches(N, rounds, seed=0):
    """numpy batches, as the loader hands them to ``to_device``."""
    g = torch.Generator().manual_seed(seed)
    hw = REDUCED.image_size
    return [{"images": torch.randn(N, 2, hw, hw, 3, generator=g).numpy(),
             "labels": torch.randint(0, 10, (N, 2), generator=g, dtype=torch.int32).numpy()}
            for _ in range(rounds)]


@pytest.mark.parametrize("per_class", [False, True], ids=["dense", "per-class"])
@pytest.mark.parametrize("codec", [None, 128], ids=["plain", "int8"])
def test_guarded_step_on_card_matches_cpu(cuda, per_class, codec):
    """Engine A with the guard, nan corruption injected before rounds 1 and
    3, a crashed client masked in round 2: the card's losses within rtol
    1e-4 of the CPU's (1e-3 over the int8 wire); every param finite; the
    syncs on B1m, per class on B3m."""
    from repro_torch.core import TrainState
    from repro_torch.core.tiers import GuardSpec
    from repro_torch.faults import FaultSpec, apply_corruption

    N = 4
    plan = default_plan(REDUCED.n_units, N, cuts=(1, 3), intervals=(2, 2, 1),
                        entities=(N, 2, 1))
    model, opt = VggModel(REDUCED), sgd(0.01)
    spec = FaultSpec(corrupt_rate=0.5, corrupt_mode="nan")
    corrupt = [[0, 1, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0]]
    masks = [[1, 1, 1, 1], [1, 1, 0, 1], [1, 1, 1, 1], [1, 1, 1, 1]]
    losses = {}
    for dev in (cuda, torch.device("cpu")):
        members = class_tier_members(REDUCED.n_units, [(1, 3), (2, 4)], [0, 1] * 2, dev) \
            if per_class else None
        state = init_state_a(model, plan, opt, torch.Generator().manual_seed(0), dev)
        dispatch = make_dispatch(model, plan, opt, class_members=members, guard=GuardSpec(),
                                 compressor=Int8Stochastic(codec) if codec else None)
        reset_launches()
        losses[dev.type] = []
        for r, batch in enumerate(_reduced_vgg_batches(N, 4)):
            import numpy as np

            state = TrainState(apply_corruption(state.params, np.array(corrupt[r], bool),
                                                spec), state.opt_state, state.step)
            state, loss = dispatch(state, to_device(batch, dev), r,
                                   torch.tensor(masks[r], dtype=torch.float32, device=dev))
            losses[dev.type].append(float(loss))
        if dev.type == "cuda":
            key = "masked_ragged_tiered_aggregate" if per_class else "masked_tiered_aggregate"
            assert launches[key] > 0
            assert launches["tiered_aggregate"] == launches["ragged_tiered_aggregate"] == 0
            for u in state.params["units"]:
                assert all(bool(torch.isfinite(v).all()) for v in u.values())
    assert all(math.isfinite(v) for v in losses["cuda"])
    torch.testing.assert_close(torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
                               rtol=1e-3 if codec else 1e-4, atol=0)


def test_dp_noise_reproducible_on_one_cuda_generator_seed(cuda):
    """One (seed, round, leaf): the same draw on the card bit for bit;
    another round, leaf or seed: another; the noise has std z·C; a full
    fed round leaves every client with one value."""
    from repro_torch.core import TrainState, build_train_step_a
    from repro_torch.privacy import DPMechanism

    x = torch.full((4, 250_000), 1e-9, device=cuda)
    mech = DPMechanism(clip=0.5, noise_multiplier=2.0, seed=3)
    a = mech.transform(x, 5, salt=2)
    assert torch.equal(a, mech.transform(x, 5, salt=2))
    for other in (mech.transform(x, 6, salt=2), mech.transform(x, 5, salt=3),
                  DPMechanism(clip=0.5, noise_multiplier=2.0, seed=4).transform(x, 5, salt=2)):
        assert not torch.equal(a, other)
    assert abs(float((a - x).double().std()) / 1.0 - 1.0) < 0.01
    plan = default_plan(REDUCED.n_units, 4, cuts=(1, 3), intervals=(1, 1, 1),
                        entities=(4, 2, 1))
    model, opt = VggModel(REDUCED), sgd(0.01)
    state = init_state_a(model, plan, opt, torch.Generator().manual_seed(0), cuda)
    step = build_train_step_a(model, plan, opt, privacy=DPMechanism(1.0, 1.0, seed=7))
    batch = to_device(_reduced_vgg_batches(4, 1)[0], cuda)
    one, _ = step(state, batch)
    two, _ = step(TrainState(state.params, state.opt_state, 0), batch)
    for u1, u2 in zip(one.params["units"], two.params["units"]):
        for k in u1:
            assert torch.equal(u1[k], u1[k][:1].expand_as(u1[k]))
            torch.testing.assert_close(u1[k], u2[k], rtol=1e-5, atol=1e-6)


def test_fault_storm_and_async_api_runs_on_card_match_cpu(cuda):
    """``api.run`` on the card against the CPU from one init: the fault
    storm (REDUCED smollm-135m, 6 rounds, an engine crash resumed from a
    checkpoint) and staleness 1 on REDUCED VGG — losses within rtol 1e-4,
    every other train field equal."""
    import tempfile

    from repro_torch import api

    with tempfile.TemporaryDirectory() as d:
        storm = api.fault_storm_spec(rounds=6, corrupt_rate=0.2, checkpoint_every=2,
                                     engine_crash_round=3)
        storm = storm.replace(
            model=api.ModelCfg(arch="smollm-135m", variant="reduced", num_layers=4, batch=2,
                               seq=32),
            run=api.RunCfg(mode="train", rounds=6, dataset_size=64, lr=0.1),
            faults=__import__("dataclasses").replace(storm.faults, checkpoint_dir=d))
        stale = api.paper_spec().replace(
            model=api.ModelCfg(arch="smollm-135m", variant="reduced", num_layers=4, batch=2,
                               seq=32),
            system=api.SystemCfg(num_clients=4, num_edges=2),
            solver=api.SolverCfg(kind="fixed", cuts=(1, 3), intervals=(2, 2, 1)),
            run=api.RunCfg(mode="train", rounds=4, dataset_size=64, lr=0.01, staleness=1))
        for spec in (storm, stale):
            on_card, on_cpu = api.run(spec), api.run(spec, device="cpu")
            a, b = on_card.train, on_cpu.train
            torch.testing.assert_close(torch.tensor(a["losses"]), torch.tensor(b["losses"]),
                                       rtol=1e-4, atol=0)
            for k in b:
                if k not in ("losses", "first_loss", "final_loss"):
                    assert a[k] == b[k], k


def test_control_mode_on_card_matches_cpu(cuda, monkeypatch):
    """``api.run(mode="control")`` on the card against the CPU from one
    init: REDUCED smollm-135m (4 layers, B4/B5, its syncs on B1) under
    flaky-wan, and REDUCED VGG at 32x32 images under flaky-wan with a
    participation deadline (B1m), each switching at least once — the
    decisions, segments and bounds equal, losses within rtol 1e-4."""
    import dataclasses

    import repro_torch.configs.vgg16_cifar10 as vgg_config
    from repro_torch import api

    monkeypatch.setattr(vgg_config, "REDUCED",
                        dataclasses.replace(vgg_config.REDUCED, image_size=32))
    ctl = api.ControlCfg(window=4, min_window=2, cooldown=1, rel_tol=0.1, backend="numpy")
    lm = api.paper_spec().replace(
        model=api.ModelCfg(arch="smollm-135m", variant="reduced", num_layers=4, batch=2,
                           seq=32),
        system=api.SystemCfg(num_clients=4, num_edges=2),
        scenario=api.ScenarioCfg(name="flaky-wan", rounds=16, quantile=0.5),
        solver=api.SolverCfg(kind="bcd", backend="numpy"),
        run=api.RunCfg(mode="control", rounds=4, dataset_size=64, lr=0.01, log_every=0),
        control=ctl)
    vgg = lm.replace(
        model=api.ModelCfg(arch="vgg16-cifar10", variant="reduced", batch=2),
        participation=api.ParticipationCfg(target_rate=0.75),
        solver=api.SolverCfg(kind="fixed", cuts=(1, 3), intervals=(2, 2, 1)))
    for spec in (lm, vgg):
        on_card, on_cpu = api.run(spec).control, api.run(spec, device="cpu").control
        assert on_cpu["n_switches"] >= 1
        torch.testing.assert_close(torch.tensor(on_card["losses"]),
                                   torch.tensor(on_cpu["losses"]), rtol=1e-4, atol=0)
        for k in on_cpu:
            if k == "switches":
                strip = [{f: v for f, v in s.items() if f != "solve_ms"} for s in on_cpu[k]]
                assert strip == [{f: v for f, v in s.items() if f != "solve_ms"}
                                 for s in on_card[k]]
            elif k not in ("losses", "first_loss", "final_loss", "switch_log",
                           "resolve_p50_s", "resolve_p95_s"):
                assert on_card[k] == on_cpu[k], k


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_engine_b_on_card_matches_cpu(cuda, masked):
    """Engine B on REDUCED smollm-135m (4 layers, N=8, J2=4, cuts (1, 3),
    intervals (2, 2, 1), 4 rounds; masked: a silent entity in round 1, a
    silent round 2) on the card against the CPU from one init: losses
    within rtol 1e-4; B4 and each B5 pass once per layer a round; the fed
    means one B1 (masked: B1m) launch per leaf of each tier due, weighted
    by the entities' participant counts under the mask; integer weights
    on B1m's kernel against its plain version."""
    import dataclasses

    from repro_torch._tree import tree_leaves
    from repro_torch.core import build_train_step_b, init_state_b

    N, b, S = 8, 2, 32
    spec = dataclasses.replace(get_reduced("smollm-135m"), num_layers=4)
    model = SplittableModel(spec)
    plan = default_plan(spec.n_units, N, cuts=(1, 3), intervals=(2, 2, 1),
                        entities=(N, 4, 1))
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, spec.vocab_size, (4, N, b, S + 1), generator=g)
    masks = torch.tensor([[1, 1, 0, 1, 1, 0, 1, 1], [0, 0, 1, 1, 1, 0, 1, 1],
                          [0] * 8, [1] * 8], dtype=torch.float32)
    losses = {}
    for dev in (cuda, torch.device("cpu")):
        state = init_state_b(model, plan, sgd(0.05), torch.Generator().manual_seed(0), dev)
        leaves = [len(tree_leaves(p)) for p in state.params]
        step = build_train_step_b(model, plan, sgd(0.05), with_mask=masked)
        reset_launches()
        swa.reset_launches()
        losses[dev.type] = []
        for r in range(4):
            batch = {"tokens": toks[r, ..., :-1].to(dev), "labels": toks[r, ..., 1:].to(dev)}
            args = (masks[r].to(dev),) if masked else ()
            state, loss = step(state, batch, *args)
            losses[dev.type].append(float(loss))
        if dev.type == "cuda":
            fed = 2 * (leaves[0] + leaves[1])  # rounds 2 and 4: tiers 0 and 1
            key = "masked_tiered_aggregate" if masked else "tiered_aggregate"
            assert {k: v for k, v in launches.items() if v} == {key: fed}
            assert dict(swa.launches) == dict.fromkeys(swa.launches, spec.n_units * 4)
            assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(state.params))
    assert all(math.isfinite(v) for v in losses["cuda"])
    torch.testing.assert_close(torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
                               rtol=1e-4, atol=0)
    x = torch.randn(4, 3000, device=cuda)
    keep = torch.randn(4, 3000, device=cuda)
    for counts in ((2, 0, 1, 2), (0, 0, 0, 0), (3, 5, 0, 8)):
        w = torch.tensor(counts, dtype=torch.float32, device=cuda)
        out = masked_tiered_aggregate(x, w, keep, False, True, 1)
        torch.testing.assert_close(out, masked_tiered_aggregate_ref(x, w, keep, False, True, 1),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["plain", "int8", "guard+mask"])
def test_one_nccl_rank_is_the_unsharded_engine_on_card(cuda, case):
    """The sharded engine on a one-rank NCCL world (``run_on_ranks``, a
    FileStore in a temporary directory): REDUCED VGG (N=4, J2=2, cuts (1, 3),
    intervals (2, 2, 1), 4 rounds) equals the unsharded engine on the card
    bit for bit — losses, params and B1 / B2 / B1m launches."""
    from repro_torch.core.tiers import GuardSpec
    from repro_torch.launch.mesh import run_on_ranks

    N, J, R = 4, 2, 4
    kw = {"plain": {}, "int8": {"compressor": Int8Stochastic(tile=256)},
          "guard+mask": {"with_mask": True, "guard": GuardSpec()}}[case]
    ref = _one_rank_run(None, case, N, J, R, kw)
    got = run_on_ranks(_one_rank_run, 1, device="cuda", args=("mesh", case, N, J, R, kw))
    assert got["backend"] == "nccl"
    assert got["losses"] == ref["losses"]
    assert got["launches"] == ref["launches"] and any(got["launches"].values())
    for a, b in zip(got["params"], ref["params"]):
        assert torch.equal(a, b)


def _one_rank_run(mesh_kind, case, N, J, R, kw):
    import torch.distributed as dist

    from repro_torch._tree import tree_leaves
    from repro_torch.core import build_train_step_a
    from repro_torch.core.sharded import build_sharded_train_step_a, init_sharded_state_a
    from repro_torch.launch.mesh import make_debug_mesh

    dev = torch.device("cuda", 0)
    model, opt = VggModel(REDUCED), sgd(0.05)
    plan = default_plan(REDUCED.n_units, N, cuts=(1, 3), intervals=(2, 2, 1),
                        entities=(N, J, 1))
    gen = torch.Generator().manual_seed(0)
    if mesh_kind is None:
        state = init_state_a(model, plan, opt, gen, dev)
        build = lambda f: build_train_step_a(model, plan, opt, fed_round=f, **kw)
    else:
        mesh = make_debug_mesh(data=1, model=1, device="cuda")
        state = init_sharded_state_a(model, plan, opt, gen, mesh)
        build = lambda f: build_sharded_train_step_a(model, plan, opt, mesh, fed_round=f,
                                                     **kw)
    g = torch.Generator().manual_seed(1)
    reset_launches()
    steps, losses = {}, []
    for r in range(R):
        batch = {"images": torch.randn(N, 2, REDUCED.image_size, REDUCED.image_size, 3,
                                       generator=g).to(dev),
                 "labels": torch.randint(0, 10, (N, 2), generator=g).to(dev)}
        f = tuple((r + 1) % I == 0 if I > 1 else True for I in plan.intervals)
        if f not in steps:
            steps[f] = build(f)
        mask = (torch.arange(N) % 3 != r % 3).float().to(dev)
        state, loss = steps[f](state, batch, *((mask,) if kw.get("with_mask") else ()))
        losses.append(float(loss))
    return {"losses": losses, "launches": dict(launches),
            "params": [x.cpu() for x in tree_leaves(state.params)],
            "backend": dist.get_backend() if dist.is_initialized() else None}


# --------------------------------------------------------------------------- #
# B4d: decode attention
# --------------------------------------------------------------------------- #


def _slots(kind, C, q_pos, device):
    """cache_pos of a cache of C slots read at position q_pos."""
    if kind == "partly filled":
        pos = torch.where(torch.arange(C) <= q_pos, torch.arange(C), -1)
    elif kind == "wrapped":  # a ring after q_pos + 1 tokens: slot p % C holds p
        pos = torch.roll(torch.arange(q_pos + 1 - C, q_pos + 1), (q_pos + 1) % C)
    elif kind == "all masked":  # every slot ahead of the query
        pos = torch.arange(C) + q_pos + 1
    else:
        raise ValueError(kind)
    return pos.to(device=device, dtype=torch.int32)


def _decode_inputs(cuda, B, C, H, K, hd, dtype=torch.float32, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, C, K, hd, generator=g, device=cuda).to(dtype) for _ in range(2))
    return q, k, v


DECODE_FILLS = [("partly filled", 70), ("wrapped", 300), ("all masked", 40)]


def _decode_fills(C):
    """DECODE_FILLS for a short cache; for a split one (C > 128) the first
    half filled (the later splits hold no visible slot), a full ring (a
    window of 16 lies in one split) and every slot ahead of the query."""
    if C <= 128:
        return DECODE_FILLS
    return [("partly filled", C // 2 + 7), ("wrapped", 2 * C + 300), ("all masked", C // 3)]


@pytest.mark.parametrize("hd", swa.HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 2, 3, 5, 6, 12, 16])
def test_b4d_matches_plain_across_head_dims_groups_windows_and_fills(cuda, hd, G):
    """f32 at ATTN_TOL rtol = atol 2e-5; an all-masked row NaN as the plain
    version's; one call counted a call.  C = 100 and 128 (one split: a few
    tiles and a ragged one at 100), 1300 (10 splits at batch 3: split 0
    holds 5 tiles, the others 4, and its last tile is ragged), 4096 and 8192
    (32 and 64 splits)."""
    for C in (100, 128, 1300, 4096, 8192):
        for kind, q_pos in _decode_fills(C):
            for W in (0, 16, C + 5):
                q, k, v = _decode_inputs(cuda, 3, C, 2 * G, 2, hd, seed=hd + G + W + C)
                pos = _slots(kind, C, q_pos, cuda)
                qp = torch.tensor([q_pos], dtype=torch.int32, device=cuda)
                swa.reset_launches()
                o = swa.swa_decode(q, k, v, pos, qp, W)
                torch.cuda.synchronize()
                assert swa.decode_launches == {"swa_decode": 1}
                ref = swa.swa_decode_ref(q, k, v, pos, qp, W)
                torch.testing.assert_close(o, ref, rtol=2e-5, atol=2e-5, equal_nan=True,
                                           msg=f"C={C} {kind} window={W}")
                assert bool(torch.isnan(o).all()) == (kind == "all masked")


@pytest.mark.parametrize("hd", swa.HEAD_DIMS)
def test_b4d_bf16_within_one_ulp_of_the_f32_tolerance(cuda, hd):
    """bf16 inputs: o within one bf16 ulp of the f32 plain version on the
    same (bf16) inputs, beyond the f32 tolerance: a wrapped ring of 200
    slots (one split) and of 1300 (10 splits at batch 4, its last tile
    ragged), at one and two query heads a warp."""
    for C, q_pos in ((200, 450), (1300, 3000)):
        for G in (2, 3, 16):
            q, k, v = _decode_inputs(cuda, 4, C, 2 * G, 2, hd, torch.bfloat16, seed=hd + G)
            pos = _slots("wrapped", C, q_pos, cuda)
            qp = torch.tensor([q_pos], dtype=torch.int32, device=cuda)
            for W in (0, 64):
                o = swa.swa_decode(q, k, v, pos, qp, W)
                torch.cuda.synchronize()
                assert o.dtype == torch.bfloat16
                ro = swa.swa_decode_ref(q.float(), k.float(), v.float(), pos, qp, W)
                _, exp = torch.frexp(ro)
                ulp = torch.ldexp(torch.ones_like(ro), exp - 8)
                bad = (o.float() - ro).abs() > 2e-5 + 2e-5 * ro.abs() + ulp
                assert not bool(bad.any()), f"C={C} G={G} window={W}: {int(bad.sum())} elements"


# (B, C, H, K, hd): the serve cells (smollm-135m, qwen2-1.5b, granite-moe-1b-a400m
# at batch 8, cache 128), REDUCED smollm and qwen2.5, two long caches (32
# splits each), and paligemma-3b's serve cell (hd 256) with a long cache
DECODE_SHAPES = [(8, 128, 9, 3, 64), (8, 128, 12, 2, 128), (8, 128, 16, 8, 64),
                 (2, 16, 3, 3, 64), (2, 16, 8, 2, 32), (2, 4096, 12, 2, 128),
                 (8, 8192, 12, 2, 128), (8, 128, 8, 1, 256), (2, 4096, 8, 1, 256)]


@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=[str(s) for s in DECODE_SHAPES])
def test_b4d_at_the_serve_shapes_repeats_bit_for_bit(cuda, shape):
    B, C, H, K, hd = shape
    q, k, v = _decode_inputs(cuda, B, C, H, K, hd, seed=C)
    pos = _slots("partly filled", C, C - 1, cuda)
    qp = torch.tensor([C - 1], dtype=torch.int32, device=cuda)
    o1, o2 = swa.swa_decode(q, k, v, pos, qp), swa.swa_decode(q, k, v, pos, qp)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    torch.testing.assert_close(o1, swa.swa_decode_ref(q, k, v, pos, qp), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4d_never_reads_a_tile_without_a_visible_slot(cuda, dtype):
    """C = 8192 filled to q_pos = 1023: slots 1024..8191 are unfilled whole
    tiles of any tile size that divides 128.  With NaN in their k and v the
    kernel still equals the plain version on the same cache with zeros
    there (f32 at 2e-5; bf16 one ulp beyond it), because a skipped tile is
    never read."""
    B, C, H, K, hd, q_pos = 8, 8192, 12, 2, 128, 1023
    q, k, v = _decode_inputs(cuda, B, C, H, K, hd, dtype, seed=17)
    pos = _slots("partly filled", C, q_pos, cuda)
    qp = torch.tensor([q_pos], dtype=torch.int32, device=cuda)
    k[:, q_pos + 1 :] = 0
    v[:, q_pos + 1 :] = 0
    ref = swa.swa_decode_ref(q.float(), k.float(), v.float(), pos, qp)
    k[:, q_pos + 1 :] = float("nan")
    v[:, q_pos + 1 :] = float("nan")
    o = swa.swa_decode(q, k, v, pos, qp)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(o).any())
    tol = 2e-5 + 2e-5 * ref.abs()
    if dtype == torch.bfloat16:
        _, exp = torch.frexp(ref)
        tol = tol + torch.ldexp(torch.ones_like(ref), exp - 8)
    assert bool(((o.float() - ref).abs() <= tol).all())


def test_b4d_raises_on_what_the_kernel_does_not_take(cuda):
    pos = torch.arange(8, dtype=torch.int32, device=cuda)
    qp = torch.tensor([7], dtype=torch.int32, device=cuda)
    q, k, v = _decode_inputs(cuda, 1, 8, 4, 2, 48)
    with pytest.raises(ValueError, match="head dim"):
        swa.swa_decode(q, k, v, pos, qp)
    q, k, v = _decode_inputs(cuda, 1, 8, 4, 2, 64, torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        swa.swa_decode(q, k, v, pos, qp)
    q, k, v = _decode_inputs(cuda, 1, 8, 34, 2, 64)
    with pytest.raises(ValueError, match="at most 16"):
        swa.swa_decode(q, k, v, pos, qp)
    q, k, v = _decode_inputs(cuda, 1, 8, 4, 2, 64)
    with pytest.raises(ValueError, match="no backward"):
        swa.swa_decode(q.requires_grad_(), k, v, pos, qp)


@pytest.mark.parametrize("arch,window", [("smollm-135m", 0), ("smollm-135m", 4),
                                         ("qwen2-1.5b", 0), ("granite-moe-1b-a400m", 0),
                                         ("mamba2-1.3b", 0), ("jamba-1.5-large-398b", 0),
                                         ("whisper-large-v3", 0)])
def test_decode_step_on_card_matches_cpu_and_counts_launches(cuda, arch, window):
    """REDUCED: 10 decode steps (a window of 4 wraps its ring twice) on the
    card against the CPU, logits at a max-normalised 2e-5; B4d launches once
    per attention layer a step (whisper: self and cross, its cross caches
    filled with the same values on both), and no B4/B5."""
    spec = get_reduced(arch).with_window(window)
    model = SplittableModel(spec)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, spec.vocab_size, (2, 10), generator=torch.Generator().manual_seed(1))
    logits = {}
    for device in (cuda, torch.device("cpu")):
        p = tree_map(lambda x: x.to(device), params)
        caches = model.init_caches(2, 10, device)
        if spec.family == "audio":
            for name in ("xk", "xv"):
                caches[name].copy_(torch.randn(caches[name].shape,
                                               generator=torch.Generator().manual_seed(2)))
        swa.reset_launches()
        out = []
        for i in range(10):
            step, caches = model.decode_step(p, toks[:, i : i + 1].to(device), caches, i)
            out.append(step.float().cpu())
        torch.cuda.synchronize()
        if device.type == "cuda":
            layers = {"ssm": 0, "audio": 2 * spec.num_layers}.get(spec.family, spec.n_units)
            assert swa.decode_launches == {"swa_decode": 10 * layers}
            assert swa.launches == dict.fromkeys(swa.launches, 0)
        logits[device.type] = torch.stack(out)
    ref = logits["cpu"][..., : spec.vocab_size]
    err = (logits["cuda"][..., : spec.vocab_size] - ref).abs().max()
    assert float(err) <= 2e-5 * float(ref.abs().max())


# --------------------------------------------------------------------------- #
# unit rematerialisation and the int8-wire checks (check.py) on the card
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("policy", ["full", "outs", "dots"])
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b"])
def test_remat_is_bit_equal_to_no_remat_on_card(cuda, arch, policy):
    """REDUCED, two clients through Engine A's ``vmap(grad_and_value)``:
    the losses and every gradient with remat equal those without, bit for
    bit; B4 runs twice (the replay) where the model has attention."""
    import dataclasses

    from repro_torch._tree import tree_leaves

    spec = get_reduced(arch)
    plain = SplittableModel(spec)
    rm = SplittableModel(dataclasses.replace(spec, remat=True, remat_policy=policy))
    p = plain.init_params(torch.Generator().manual_seed(0), cuda)
    pN = tree_map(lambda x: torch.stack([x, 1.01 * x]), p)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, spec.vocab_size, (2, 2, 33), generator=g, device=cuda)
    batch = {"tokens": toks[..., :-1].int(), "labels": toks[..., 1:].int()}
    swa.reset_launches()
    ref = vmap(grad_and_value(plain.loss_fn))(pN, batch)
    fwd = swa.launches["swa_attention_fwd"]
    swa.reset_launches()
    got = vmap(grad_and_value(rm.loss_fn))(pN, batch)
    torch.cuda.synchronize()
    assert swa.launches["swa_attention_fwd"] == 2 * fwd
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N,J", [(20, 5), (20, 1), (16, 4)])
def test_check_q8_and_ragged_q8_at_the_vgg_leaf_widths(cuda, N, J):
    """``kernels/tiered_aggregate/check.py`` on the card's B2 and B3 at every
    VGG-16 leaf width that ``chip_smoke.py`` checks, its seeded draws: each
    kernel against its plain version, the entries against the payload route
    and, at N = 16, J = 4 (groups of four, sixteen weights of 1/16 summing
    to exactly 1.0 in any order), B3's all-ones collapse onto B2, bit for
    bit; at N = 20 the weights sum to 1.0000001 left to right and the
    collapse is not asked for, as JAX's condition says."""
    from repro_torch.configs.vgg16_cifar10 import SPEC
    from repro_torch.kernels.tiered_aggregate.check import (
        assert_q8_matches_oracle, assert_ragged_q8_matches_oracle,
    )

    widths = set()
    for u in range(SPEC.n_units):
        _, cout, _ = SPEC.unit_io(u)
        widths |= {SPEC.unit_param_count(u) - cout, cout}
    for P in sorted(widths):
        assert assert_q8_matches_oracle(N, J, P, 256, device=cuda) < 1e-3
        assert assert_ragged_q8_matches_oracle(N, J, P, 256, device=cuda) < 1e-3
