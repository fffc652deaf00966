"""The port's tiered-aggregation wrappers and plain versions against the JAX
package's Pallas kernels (interpret mode) and ``ref.py`` oracles.

Inputs are made once with numpy from a seed and fed to both packages.  On
the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress.quantize import q8_quantize as jax_q8_quantize
from repro.kernels.tiered_aggregate.ops import aggregate_tree as jax_aggregate_tree
from repro.kernels.tiered_aggregate.ref import (
    quantized_tiered_aggregate_ref as jax_q8_ref,
    tiered_aggregate_ref as jax_ref,
)
from repro.kernels.tiered_aggregate.tiered_aggregate import tiered_aggregate_pallas
from repro_torch.compress.quantize import Int8Stochastic, q8_dequantize, q8_quantize
from repro_torch.kernels.tiered_aggregate import ops
from repro_torch.kernels.tiered_aggregate import (
    aggregate_tree, quantized_tiered_aggregate, tiered_aggregate,
    tiered_aggregate_q8,
)

FLAGS = [(0, 0), (0, 1), (1, 0), (1, 1)]
SHAPES = [(8, 4, 700), (20, 5, 2049), (4, 1, 100), (6, 6, 257)]
# f32: the port and XLA sum in different orders -> a few ulp
F32 = dict(rtol=1e-5, atol=1e-6)


def _inputs(N, P, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, P)).astype(np.float32)
    e = np.exp(rng.normal(size=N))
    w = (e / e.sum()).astype(np.float32)
    return x, w


def _bf16_ulp(ref):
    """One bf16 unit in the last place of each f32 value of ``ref``."""
    _, exp = np.frexp(ref)
    return np.ldexp(np.ones_like(ref), exp - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,J,P", SHAPES)
def test_b1_plain_matches_pallas_and_oracle(N, J, P, dtype):
    x, w = _inputs(N, P, seed=N * P)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for de, dg in FLAGS:
        out = tiered_aggregate(xt, torch.from_numpy(w), de, dg, J)
        assert out.dtype == xt.dtype and out.shape == (N, P)
        got = out.float().numpy()
        pallas = tiered_aggregate_pallas(
            xj, jnp.asarray(w), jnp.array(de), jnp.array(dg), J, interpret=True
        )
        oracle = jax_ref(xj, jnp.asarray(w), jnp.array(bool(de)), jnp.array(bool(dg)), J)
        for ref in (pallas, oracle):
            ref = np.asarray(ref.astype(jnp.float32))
            if dtype == "float32":
                np.testing.assert_allclose(got, ref, **F32)
            else:
                # both round an f32 sum to bf16; the sums differ within the
                # f32 tolerance, so the results may round one ulp apart
                # (plus that f32 difference where a sum cancels near zero)
                tol = F32["atol"] + F32["rtol"] * np.abs(ref) + _bf16_ulp(ref)
                assert np.all(np.abs(got - ref) <= tol)


@pytest.mark.parametrize("N,J,P", SHAPES)
@pytest.mark.parametrize("tile", [128, 256])
def test_b2_plain_matches_oracle(N, J, P, tile):
    """Against ``quantized_tiered_aggregate_ref``, not the Pallas interpret
    output, which is 1-3 ulp off its own oracle on this jax."""
    x, w = _inputs(N, P, seed=7 * N + P)
    qj, sj = jax_q8_quantize(jnp.asarray(x), tile)
    q, s = torch.from_numpy(np.array(qj)), torch.from_numpy(np.array(sj))
    for de, dg in FLAGS:
        got = quantized_tiered_aggregate(q, s, torch.from_numpy(w), de, dg, J, tile)
        ref = jax_q8_ref(qj, sj, jnp.asarray(w), jnp.array(bool(de)),
                         jnp.array(bool(dg)), J, tile)
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("N,P,tile", [(8, 700, 128), (20, 2049, 256), (3, 64, 128)])
def test_q8_quantize_bit_identical_to_jax(N, P, tile):
    """Key-less rounding is round-half-even in both packages."""
    x, _ = _inputs(N, P, seed=P)
    x[0, :5] = [0.5, 1.5, -2.5, 0.0, 127.0]  # exact halves and a zero
    x[1 % N] = 0.0                           # an all-zero row: scale 1
    qj, sj = jax_q8_quantize(jnp.asarray(x), tile)
    q, s = q8_quantize(torch.from_numpy(x), tile)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        q8_dequantize(q, s, tile).numpy(),
        np.asarray(jax.numpy.asarray(qj, jnp.float32).reshape(N, -1, tile)
                   * sj[..., None]).reshape(N, -1),
    )


def test_int8_codec_properties_match_jax():
    from repro.compress import Int8Stochastic as JaxInt8

    for tile in (128, 256):
        assert Int8Stochastic(tile).ratio == JaxInt8(tile).ratio
        assert Int8Stochastic(tile).omega == JaxInt8(tile).omega
    x, _ = _inputs(3, 333, seed=5)
    got = Int8Stochastic(128).transform(torch.from_numpy(x).reshape(3, 9, 37))
    ref = JaxInt8(128).transform(jnp.asarray(x).reshape(3, 9, 37))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_int8_stochastic_rounding_is_unbiased():
    """The keyed path cannot match ``jax.random``: test its statistics."""
    x = torch.full((1, 128), 0.3) * torch.linspace(-1, 1, 128)
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([
        q8_dequantize(*q8_quantize(x, 128, generator=g), 128) for _ in range(2000)
    ])
    lsb = float(x.abs().max()) / 127.0
    # mean of 2000 draws, each within one lsb: standard error <= lsb/sqrt(2000)
    assert float((draws.mean(0) - x).abs().max()) < 5 * lsb / np.sqrt(2000)
    assert float((draws - x).abs().max()) <= lsb * (1 + 1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_aggregate_tree_matches_jax(quantized):
    rng = np.random.default_rng(11)
    tree = {"a": rng.normal(size=(8, 3, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(8, 7)).astype(np.float32)}, "e": {}}
    w = np.full((8,), 1 / 8, np.float32)
    got = aggregate_tree(
        {"a": torch.from_numpy(tree["a"]), "b": {"c": torch.from_numpy(tree["b"]["c"])},
         "e": {}},
        torch.from_numpy(w), 1, 1, 4, tile_p=128, quantized=quantized,
    )
    ref = jax_aggregate_tree(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(w), jnp.array(1), jnp.array(1),
        4, tile_p=128, use_pallas=False, quantized=quantized,
    )
    assert got["e"] == {}
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(ref["a"]), **F32)
    np.testing.assert_allclose(got["b"]["c"].numpy(), np.asarray(ref["b"]["c"]), **F32)


def test_q8_entry_slices_back_to_width():
    x, w = _inputs(4, 300, seed=3)
    out = tiered_aggregate_q8(torch.from_numpy(x), torch.from_numpy(w), 1, 1, 2,
                              tile_p=128)
    assert out.shape == (4, 300) and out.dtype == torch.float32


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(6, 10)
    w = torch.full((6,), 1 / 6)
    with pytest.raises(ValueError):
        tiered_aggregate(x, w, 1, 1, 4)  # 6 clients in 4 groups
    with pytest.raises(ValueError):
        tiered_aggregate(x, w.double(), 1, 1, 3)
    with pytest.raises(ValueError):
        quantized_tiered_aggregate(torch.zeros(6, 100, dtype=torch.int8),
                                   torch.ones(6, 1), w, 1, 1, 3, 128)
    # meta tensors propagate shapes for the dry-run; a mix of devices raises
    with pytest.raises(ValueError):
        tiered_aggregate(x.to("meta"), w, 1, 1, 3)


def test_cuda_request_without_library_raises(monkeypatch, tmp_path):
    """A kernel request never falls back to the plain version: with no
    library built and no nvcc it raises, and counts no launch."""
    import torch.utils.cpp_extension as cpp_ext

    from repro_torch.kernels import build

    def plain(*_):
        raise AssertionError("the plain version ran for a kernel request")

    monkeypatch.setattr(ops, "_on_cuda", lambda *_: True)
    monkeypatch.setattr(ops, "tiered_aggregate_ref", plain)
    monkeypatch.setattr(ops, "_lib", None)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    before = dict(ops.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tiered_aggregate(torch.zeros(4, 8), torch.full((4,), 0.25), 1, 1, 2)
    assert ops.launches == before


def test_kernel_sources_found_and_keyed_by_content():
    from repro_torch.kernels import build

    srcs = build.sources()
    assert ops.SOURCE in srcs
    lib = build.library_path(ops.SOURCE)
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("tiered_aggregate-")
