"""The port's compression modules (``compress/base.py``, ``identity.py``,
``topk.py``) against the JAX package's, on the same numpy inputs, and the
sync over any codec."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compress as jcompress
import repro_torch.compress as tcompress
from repro.core.tiers import (
    default_plan as jax_default_plan, synchronize as jax_synchronize,
)
from repro_torch.compress import (
    CompressionSpec, ErrorFeedback, Identity, Int8Stochastic, TopK, act_ratio,
    measure_omega, model_ratio,
)
from repro_torch.core import default_plan, synchronize
from repro_torch.models import params_from_numpy

CPU = torch.device("cpu")


def _tie_free(shape, seed):
    """Normal draws with distinct magnitudes: ``torch.topk`` and
    ``jax.lax.top_k`` may choose differently among tied |x|, so the
    comparisons run on inputs without ties."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    assert len(np.unique(np.abs(x))) == x.size
    return x


@pytest.mark.parametrize("frac", [0.05, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("shape", [(512,), (7, 33), (3, 3, 16, 4)])
def test_topk_matches_jax_on_tie_free_inputs(shape, frac):
    x = _tie_free(shape, seed=len(shape) * 7 + int(frac * 100))
    got = TopK(frac).transform(torch.from_numpy(x))
    ref = jcompress.TopK(frac).transform(jnp.asarray(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int((got != 0).sum()) == TopK(frac).k_for(x.size)


def test_codec_scalars_match_jax():
    for t, j in ((Identity(), jcompress.Identity()),
                 (TopK(0.25), jcompress.TopK(0.25)), (TopK(0.9), jcompress.TopK(0.9)),
                 (Int8Stochastic(256), jcompress.Int8Stochastic(256))):
        assert (t.name, t.ratio, t.omega) == (j.name, j.ratio, j.omega)
    assert TopK(0.3).k_for(1000) == jcompress.TopK(0.3).k_for(1000)
    with pytest.raises(ValueError, match="frac"):
        TopK(0.0)
    x = torch.randn(5, 3)
    assert Identity().transform(x) is x
    assert set(tcompress.SCHEMES) == set(jcompress.SCHEMES)
    for name, cls in tcompress.SCHEMES.items():
        assert cls().name == jcompress.SCHEMES[name]().name == name
        assert isinstance(cls(), tcompress.Compressor)


def test_declared_omega_bounds_measured():
    """``measure_omega`` draws with a ``torch.Generator``; the measured
    error never exceeds the declared ω (the JAX test's contract)."""
    for codec in (Int8Stochastic(tile=256), TopK(0.25), TopK(0.05)):
        measured = measure_omega(codec, shape=(4096,), samples=4)
        assert 0.0 < measured <= codec.omega, (codec.name, measured, codec.omega)
    assert measure_omega(Identity(), shape=(256,), samples=2) == 0.0
    # stochastic int8 draws its rounding from the same generator, reproducibly
    assert measure_omega(Int8Stochastic(128), samples=2, seed=3) == \
        measure_omega(Int8Stochastic(128), samples=2, seed=3)


def test_error_feedback_matches_jax():
    """Residual and emitted tensors equal JAX's round by round on tie-free
    inputs (TopK picks the same entries of x + residual)."""
    d, rounds = 256, 12
    tef, jef = ErrorFeedback(TopK(0.1)), jcompress.ErrorFeedback(jcompress.TopK(0.1))
    tr, jr = tef.init(torch.zeros(d)), jef.init(jnp.zeros(d))
    assert tef.name == jef.name and tef.ratio == jef.ratio
    for i in range(rounds):
        x = _tie_free((d,), seed=100 + i)
        txh, tr = tef.step(tr, torch.from_numpy(x))
        jxh, jr = jef.step(jr, jnp.asarray(x))
        np.testing.assert_allclose(txh.numpy(), np.asarray(jxh), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)


def test_compression_spec_matches_jax():
    spec = CompressionSpec.uniform(3, model_ratio=0.25, act_ratio=0.5, omega=0.1)
    jspec = jcompress.CompressionSpec.uniform(3, model_ratio=0.25, act_ratio=0.5, omega=0.1)
    assert spec.to_dict() == jspec.to_dict()
    assert CompressionSpec.from_dict(jspec.to_dict()) == spec
    assert CompressionSpec.identity(4).to_dict() == jcompress.CompressionSpec.identity(4).to_dict()
    for m in range(2):
        assert act_ratio(spec, m) == jcompress.act_ratio(jspec, m) == 0.5
        assert model_ratio(spec, m) == jcompress.model_ratio(jspec, m) == 0.25
        assert act_ratio(None, m) == model_ratio(None, m) == 1.0
    assert spec.validate_for(3) is spec
    for bad in (dict(model_ratio=0.0), dict(model_ratio=1.5)):
        with pytest.raises(ValueError):
            CompressionSpec.uniform(3, **bad)
    with pytest.raises(ValueError):
        CompressionSpec((1.0, 1.0), (1.0, 1.0), omega=-0.1)
    with pytest.raises(ValueError, match="arity"):
        spec.validate_for(2)


def _tree(N, seed):
    rng = np.random.default_rng(seed)
    shapes = [((3, 3, 3, 16), 16), ((3, 3, 16, 16), 16), ((3, 3, 16, 32), 32),
              ((512, 64), 64), ((64, 10), 10)]
    units = [{"w": rng.normal(size=(N, *ws)).astype(np.float32),
              "b": rng.normal(size=(N, bs)).astype(np.float32)} for ws, bs in shapes]
    return {"frontend": {}, "units": units, "head": {}}


@pytest.mark.parametrize("codec", ["identity", "topk"])
@pytest.mark.parametrize("step", [0, 1])
def test_synchronize_takes_any_codec(codec, step):
    """A codec without the fused path runs its ``transform`` per client
    replica (the JAX ``vmap``), then B1 takes the fed mean."""
    N = 8
    np_tree = _tree(N, seed=30 + step)
    plan = default_plan(5, N, cuts=(1, 3), intervals=(2, 2, 1), entities=(N, 2, 1))
    jc = {"identity": jcompress.Identity(), "topk": jcompress.TopK(0.3)}[codec]
    tc = {"identity": Identity(), "topk": TopK(0.3)}[codec]
    jplan = jax_default_plan(5, N, cuts=(1, 3), intervals=(2, 2, 1), entities=(N, 2, 1))
    ref = jax_synchronize(jax.tree.map(jnp.asarray, np_tree), jplan, jnp.int32(step),
                          compress_fn=lambda x: jax.vmap(lambda v: jc.transform(v))(x))
    got = synchronize(params_from_numpy(np_tree, CPU), plan, step, compressor=tc)
    for u in range(5):
        for k in ("w", "b"):
            np.testing.assert_allclose(got["units"][u][k].numpy(),
                                       np.asarray(ref["units"][u][k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"units/{u}/{k}")
