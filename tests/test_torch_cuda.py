"""The CUDA kernels against their plain versions on the card.

These need an NVIDIA GPU (Hopper, sm_90a) with nvcc: they carry the ``cuda``
marker and skip elsewhere.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX, so it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.compress.quantize import q8_quantize
from repro_torch.configs.vgg16_cifar10 import REDUCED
from repro_torch.core import default_plan, init_state_a, synchronize
from repro_torch.kernels.tiered_aggregate import (
    launches, quantized_tiered_aggregate, quantized_tiered_aggregate_ref,
    reset_launches, tiered_aggregate, tiered_aggregate_ref,
)
from repro_torch.compress import Int8Stochastic
from repro_torch.models import VggModel
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
        assert launches == {"tiered_aggregate": 8, "tiered_aggregate_q8": 6}
    else:
        assert launches == {"tiered_aggregate": 10, "tiered_aggregate_q8": 0}
    cpu = synchronize({"frontend": {}, "units": [{k: v.cpu() for k, v in u.items()}
                                                 for u in params["units"]], "head": {}},
                      plan, 1, compressor=compressor)
    for a, b in zip(got["units"], cpu["units"]):
        for k in a:
            lsb = float(b[k].abs().max()) / 127 if codec else 1e-6
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=1e-5, atol=lsb)
