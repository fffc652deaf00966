"""The CUDA kernels against their plain versions on the card.

These need an NVIDIA GPU (Hopper, sm_90a) with nvcc: they carry the ``cuda``
marker and skip elsewhere.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX, so it runs where only PyTorch is installed.
"""
import math

import pytest
import torch
from torch.func import grad_and_value, vmap

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
                            "masked_tiered_aggregate": 0, "masked_tiered_aggregate_q8": 0}
    else:
        assert launches == {"tiered_aggregate": 10, "tiered_aggregate_q8": 0,
                            "ragged_tiered_aggregate": 0, "ragged_tiered_aggregate_q8": 0,
                            "masked_tiered_aggregate": 0, "masked_tiered_aggregate_q8": 0}
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
                        "ragged_tiered_aggregate": 0, "ragged_tiered_aggregate_q8": 0, **want}
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
                        "masked_tiered_aggregate": 0, "masked_tiered_aggregate_q8": 0, **want}
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


@pytest.mark.parametrize("hd", [64, 128])
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


@pytest.mark.parametrize("hd", [64, 128])
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
