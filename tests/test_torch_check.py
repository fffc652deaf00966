"""``kernels/tiered_aggregate/check.py`` on the CPU: the int8-wire checks
pass at the JAX package's shapes (``tests/test_kernels_tiered.py``), the
all-ones collapse leg runs bit for bit where JAX's condition holds, and
each leg catches a kernel that is off.  On the CPU both sides of leg (a)
are the plain version; ``tests/test_torch_cuda.py`` runs the same checks
on the card's kernels."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)

import pytest
import torch

from repro_torch.kernels.tiered_aggregate import check

CPU = torch.device("cpu")


@pytest.mark.parametrize("N,J,P,tile", [(16, 4, 2048, 256), (6, 2, 257, 128),
                                        (20, 20, 1000, 128), (4, 1, 100, 128),
                                        (12, 3, 333, 128)])
def test_q8_check_passes_at_jax_shapes(N, J, P, tile):
    assert check.assert_q8_matches_oracle(N, J, P, tile, device=CPU) == 0.0


@pytest.mark.parametrize("N,J,P,tile", [(16, 4, 300, 128), (6, 2, 257, 128),
                                        (20, 5, 999, 128)])
def test_ragged_q8_check_passes_at_jax_shapes(N, J, P, tile):
    assert check.assert_ragged_q8_matches_oracle(N, J, P, tile, device=CPU) == 0.0


def test_collapse_leg_runs_bit_for_bit_where_jax_s_condition_holds(monkeypatch):
    """N = 16, J = 4: groups of 4 and sixteen weights of 1/16 summing to
    exactly 1.0, so the leg runs (four B2 calls beside four B3 calls); at
    N = 6, J = 2 (groups of 3) it is skipped, as in JAX."""
    calls = []
    dense = check.quantized_tiered_aggregate

    def counted(*a, **k):
        calls.append(1)
        return dense(*a, **k)

    monkeypatch.setattr(check, "quantized_tiered_aggregate", counted)
    check.assert_ragged_q8_matches_oracle(16, 4, 300, 128, device=CPU)
    assert len(calls) == 4
    check.assert_ragged_q8_matches_oracle(6, 2, 257, 128, device=CPU)
    assert len(calls) == 4


def test_collapse_condition_takes_the_kernels_summation_order(monkeypatch):
    """Twenty weights of 1/20 sum to 1.0000001 left to right (the kernels'
    order), so at N = 20, J = 5 the leg is skipped even where ``torch.sum``
    gives exactly 1.0; twelve sum to 0.9999999."""
    assert not check._sums_to_one(torch.full((20,), 1 / 20))
    assert not check._sums_to_one(torch.full((12,), 1 / 12))
    assert check._sums_to_one(torch.full((16,), 1 / 16))
    assert check._sums_to_one(torch.full((8,), 1 / 8))
    calls = []
    dense = check.quantized_tiered_aggregate
    monkeypatch.setattr(check, "quantized_tiered_aggregate",
                        lambda *a, **k: calls.append(1) or dense(*a, **k))
    check.assert_ragged_q8_matches_oracle(20, 5, 300, 128, device=CPU)
    assert not calls


def test_explicit_inputs_replace_the_draws():
    """A caller's rows, weights and [N, U] members (chip_smoke.py's shapes)."""
    g = torch.Generator().manual_seed(3)
    x = 0.05 * torch.randn(20, 1200, generator=g)
    w = torch.full((20,), 1 / 20)
    assert check.assert_q8_matches_oracle(20, 5, 1200, 256, device=CPU, x=x, weights=w) == 0.0
    m = (torch.rand(20, 4, generator=g) > 0.5).float()
    assert check.assert_ragged_q8_matches_oracle(20, 5, 1200, 256, device=CPU, x=x,
                                                 weights=w, member=m) == 0.0


@pytest.mark.parametrize("leg", ["kernel", "entry"])
def test_each_leg_catches_a_kernel_that_is_off(monkeypatch, leg):
    """Leg (a) catches B2 off by 1e-3 against its plain version, leg (b) an
    entry that is off from the payload route by one ulp."""
    if leg == "kernel":
        b2 = check.quantized_tiered_aggregate
        monkeypatch.setattr(check, "quantized_tiered_aggregate",
                            lambda *a, **k: b2(*a, **k) + 1e-3)
    else:
        entry = check.tiered_aggregate_q8
        monkeypatch.setattr(check, "tiered_aggregate_q8",
                            lambda *a, **k: torch.nextafter(entry(*a, **k),
                                                            torch.tensor(float("inf"))))
    with pytest.raises(AssertionError):
        check.assert_q8_matches_oracle(8, 2, 700, 128, device=CPU)


def test_ragged_collapse_leg_catches_a_dense_kernel_that_is_off(monkeypatch):
    b2 = check.quantized_tiered_aggregate
    monkeypatch.setattr(check, "quantized_tiered_aggregate",
                        lambda *a, **k: torch.nextafter(b2(*a, **k), torch.tensor(0.0)))
    with pytest.raises(AssertionError, match="collapse"):
        check.assert_ragged_q8_matches_oracle(16, 4, 300, 128, device=CPU)
