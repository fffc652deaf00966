"""The port's bound-constant estimator and the training CLI's
``--auto-optimize`` against the JAX package's, on the same arrays."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_state_a as jax_init
from repro.core.estimator import (
    HyperEstimator as JaxEstimator, _unit_sq_norms as jax_unit_sq_norms,
    estimate_from_probe as jax_estimate,
)
from repro.core.tiers import default_plan as jax_default_plan
from repro.launch import train as jax_train
from repro.models.vgg import VggModel as JaxVgg
from repro.optim import sgd as jsgd
from repro_torch.configs.vgg16_cifar10 import REDUCED
from repro_torch.core import TrainState, default_plan, replicate_for_clients
from repro_torch.core.estimator import (
    HyperEstimator, _global_sq_norm, _unit_sq_norms, _unit_sq_norms_mean_tree,
    estimate_from_probe,
)
from repro_torch.launch import train
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.optim import sgd

CPU = torch.device("cpu")
FIELDS = ("beta", "theta0", "sigma2", "G2")
N, B = 4, 2
CUTS, INTERVALS, ENTITIES = (1, 3), (2, 2, 1), (4, 2, 1)


def _list_tree(seed, n=N):
    """VGG-shaped: a list of units, no frontend or head leaves."""
    rng = np.random.default_rng(seed)
    return {"frontend": {}, "head": {}, "units": [
        {"w": rng.normal(size=(n, 3, 3, 4)).astype(np.float32),
         "b": rng.normal(size=(n, 4)).astype(np.float32)} for _ in range(5)]}


def _stacked_tree(seed, n=N, U=6):
    """Transformer-shaped: units stacked on axis 1, with frontend and head."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=(n, *s)).astype(np.float32)  # noqa: E731
    return {"frontend": {"embed": f(7, 5)},
            "units": {"attn": {"wq": f(U, 5, 3)}, "mlp": {"w": f(U, 3, 2), "b": f(U, 2)}},
            "head": {"norm": f(5)}}


@pytest.mark.parametrize("make,U", [(_list_tree, 5), (_stacked_tree, 6)],
                         ids=["list", "stacked"])
def test_unit_sq_norms_match_jax(make, U):
    tree = make(0)
    got = _unit_sq_norms(params_from_numpy(tree, CPU), U).numpy()
    ref = np.asarray(jax_unit_sq_norms(jax.tree.map(jnp.asarray, tree), U))
    assert got.shape == (N, U)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # the partition: per-unit norms sum to the global one
    total = float(_global_sq_norm(params_from_numpy(tree, CPU)))
    np.testing.assert_allclose(got.sum(), total, rtol=1e-5)
    single = jax.tree.map(lambda x: x[0], tree)
    np.testing.assert_allclose(
        _unit_sq_norms_mean_tree(params_from_numpy(single, CPU), U).numpy(), ref[0],
        rtol=1e-6)


def test_audio_unit_stacks_raise_naming_a14():
    """The audio model's two unit stacks (ROADMAP A14.5, once a raise) are
    one layout enc ++ dec: their per-unit squared norms equal JAX's, the
    frontend folded into unit 0 and the head into the last."""
    rng = np.random.default_rng(3)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    tree = {"frontend": {"embed": r(2, 6, 4)}, "head": {"norm": r(2, 4)},
            "units": {"enc": {"w": r(2, 2, 4, 3)}, "dec": {"w": r(2, 3, 4, 3), "b": r(2, 3, 4)}}}
    got = _unit_sq_norms(params_from_numpy(tree, "cpu"), 5).numpy()
    ref = np.asarray(jax_unit_sq_norms(jax.tree.map(jnp.asarray, tree), 5))
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _observations(seed, rounds, make=_stacked_tree):
    """Client-stacked (params, grads, loss) triples, drifting per round."""
    rng = np.random.default_rng(seed + 50)
    p, out = make(seed), []
    for r in range(rounds):
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * (1 + r)).astype(np.float32), p)
        out.append((p, g, float(3.0 - 0.3 * r + 0.1 * rng.random())))
        p = jax.tree.map(lambda x, d: (x - 0.05 * d).astype(np.float32), p, g)
    return out


def _assert_hyper_close(got, ref, rtol=1e-5):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=rtol, err_msg=f)
    assert (got.gamma, got.num_clients) == (ref.gamma, ref.num_clients)


@pytest.mark.parametrize("window", [None, 3], ids=["offline", "window3"])
@pytest.mark.parametrize("make,U", [(_list_tree, 5), (_stacked_tree, 6)],
                         ids=["list", "stacked"])
def test_hyper_estimator_matches_jax(window, make, U):
    """Offline and ring-buffer modes over 6 rounds (the window wraps):
    each HyperSpec field at rtol 1e-5 (β is a max of ratios of f32 norms)."""
    jest = JaxEstimator(U, N, 0.05, window=window)
    test = HyperEstimator(U, N, 0.05, window=window)
    for p, g, loss in _observations(1, 6, make):
        jest.observe(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g), loss)
        test.observe(params_from_numpy(p, CPU), params_from_numpy(g, CPU), loss)
    _assert_hyper_close(test.hyperspec(), jest.hyperspec())
    _assert_hyper_close(test.hyperspec(0.9), jest.hyperspec(0.9))


def test_hyper_estimator_refusals_match_jax():
    with pytest.raises(ValueError, match="window must be >= 2"):
        HyperEstimator(3, N, 0.1, window=1)
    with pytest.raises(ValueError, match="no probe rounds"):
        HyperEstimator(3, N, 0.1).hyperspec()


def _vgg_batches(rounds, seed=0):
    rng = np.random.default_rng(seed)
    hw = REDUCED.image_size
    return [{"images": rng.normal(size=(N, B, hw, hw, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (N, B)).astype(np.int32)}
            for _ in range(rounds)]


def test_estimate_from_probe_matches_jax(monkeypatch):
    """REDUCED VGG, N=4, 3 probe rounds, from the JAX init carried over."""
    from repro.configs.vgg16_cifar10 import REDUCED as JAX_REDUCED
    from repro_torch.models import VggModel

    jmodel = JaxVgg(JAX_REDUCED)
    jplan = jax_default_plan(JAX_REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS,
                             entities=ENTITIES)
    batches = _vgg_batches(3)
    ref = jax_estimate(jmodel, jplan, jsgd(0.05),
                       [jax.tree.map(jnp.asarray, b) for b in batches],
                       jax.random.PRNGKey(0), 0.05)
    init = params_to_numpy(jax_init(jmodel, jplan, jsgd(0.05), jax.random.PRNGKey(0)).params)

    def carried(model, plan, opt, generator, device=None):
        params = params_from_numpy(init, device)
        return TrainState(params, opt.init(params), 0)

    monkeypatch.setattr(sys.modules["repro_torch.core.engine"], "init_state_a", carried)
    plan = default_plan(REDUCED.n_units, N, cuts=CUTS, intervals=INTERVALS, entities=ENTITIES)
    got = estimate_from_probe(VggModel(REDUCED), plan, sgd(0.05), batches,
                              torch.Generator().manual_seed(0), 0.05, CPU)
    _assert_hyper_close(got, ref)


def test_auto_optimize_cli_picks_what_the_jax_cli_picks(monkeypatch, capsys):
    """REDUCED VGG widths at the CLI's 32x32 images (both packages' VGG
    ``SPEC`` patched to it), N=4, J2=2, batch 1, 2 probe rounds from the
    JAX CLI's init: the ``[bcd]`` line names the same cuts and intervals,
    and the same Θ′, R and T to the printed digits."""
    from repro.configs import vgg16_cifar10 as jax_vgg_config
    from repro_torch.configs import vgg16_cifar10 as vgg_config

    jax_spec = dataclasses.replace(jax_vgg_config.REDUCED, image_size=32)
    monkeypatch.setattr(jax_vgg_config, "SPEC", jax_spec)
    monkeypatch.setattr(vgg_config, "SPEC", dataclasses.replace(REDUCED, image_size=32))
    argv = ["--arch", "vgg16-cifar10", "--clients", "4", "--edges", "2", "--batch", "1",
            "--rounds", "0", "--auto-optimize", "--probe-rounds", "2"]
    assert jax_train.main(argv) == 0
    ref = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[bcd]")]
    init = params_to_numpy(JaxVgg(jax_spec).init_params(jax.random.PRNGKey(0)))

    def carried(model, plan, opt, generator, device=None):
        params = replicate_for_clients(params_from_numpy(init, device), plan.num_clients)
        return TrainState(params, opt.init(params), 0)

    monkeypatch.setattr(sys.modules["repro_torch.core"], "init_state_a", carried)
    assert train.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = [line for line in out.splitlines() if line.startswith("[bcd]")]
    assert len(ref) == 1 and got == ref, (got, ref)
    assert "[probe] estimating bound constants over 2 rounds" in out
    cuts = ref[0].split("cuts=")[1].split(" intervals")[0]
    assert f"plan cuts={cuts}" in out
