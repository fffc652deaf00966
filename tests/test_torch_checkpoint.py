"""Checkpoints pass between the two packages, leaf for leaf."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import (
    load_checkpoint as jax_load, save_checkpoint as jax_save,
)
from repro.checkpoint.npz import _flatten as jax_flatten
from repro.configs.vgg16_cifar10 import REDUCED as JAX_REDUCED
from repro.core.engine import replicate_for_clients as jax_replicate
from repro.models.vgg import VggModel as JaxVgg
from repro_torch.checkpoint import check_schedule_meta, load_checkpoint, save_checkpoint
from repro_torch.checkpoint.npz import _flatten
from repro_torch.configs.vgg16_cifar10 import REDUCED
from repro_torch.core import replicate_for_clients
from repro_torch.models import VggModel, params_from_numpy, params_to_numpy

META = {"cuts": [1, 3], "intervals": [2, 2, 1]}
CPU = torch.device("cpu")


def _jax_tree(seed):
    return jax_replicate(JaxVgg(JAX_REDUCED).init_params(jax.random.PRNGKey(seed)), 3)


def _port_tree(seed):
    p = VggModel(REDUCED).init_params(torch.Generator().manual_seed(seed), CPU)
    return replicate_for_clients(p, 3)


def test_same_key_paths_as_jax():
    tree = params_to_numpy(_jax_tree(0))
    assert sorted(_flatten(params_from_numpy(tree, CPU))) == sorted(jax_flatten(tree))
    assert "units/0/w" in _flatten(params_from_numpy(tree, CPU))
    # optimizer states: adam's tuple-free dict and sgd's empty tuple
    state = {"m": tree, "t": np.int32(3)}
    assert sorted(_flatten(params_from_numpy(state, CPU))) == sorted(jax_flatten(state))
    assert _flatten(()) == {} == jax_flatten(())


def test_port_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    tree = _port_tree(1)
    save_checkpoint(path, tree, step=7, meta=META)
    got, step, meta = jax_load(path, _jax_tree(2), expect_cuts=(1, 3),
                               expect_intervals=(2, 2, 1))
    assert step == 7 and meta == META
    want = params_to_numpy(tree)
    for u, unit in enumerate(want["units"]):
        for k, v in unit.items():
            assert got["units"][u][k].dtype == v.dtype
            np.testing.assert_array_equal(np.asarray(got["units"][u][k]), v)
    assert got["frontend"] == {} and got["head"] == {}


def test_jax_checkpoint_loads_in_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    tree = _jax_tree(3)
    jax_save(path, tree, step=5, meta=META)
    got, step, meta = load_checkpoint(path, _port_tree(4), expect_cuts=(1, 3))
    assert step == 5 and meta == META
    want = params_to_numpy(tree)
    for u, unit in enumerate(want["units"]):
        for k, v in unit.items():
            assert isinstance(got["units"][u][k], torch.Tensor)
            np.testing.assert_array_equal(got["units"][u][k].numpy(), v)
    assert got["frontend"] == {} and got["head"] == {}


def test_load_casts_to_template_dtype_and_checks_shape(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"a": torch.arange(6.0).reshape(2, 3)})
    tree, step, _ = load_checkpoint(path, {"a": torch.zeros(2, 3, dtype=torch.float64)})
    assert step == 0 and tree["a"].dtype == torch.float64
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"a": torch.zeros(3, 2)})
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(path, {"b": torch.zeros(2, 3)})


def test_schedule_meta_mismatch_fails_loudly(tmp_path):
    path = str(tmp_path / "m.npz")
    save_checkpoint(path, _port_tree(0), meta=META)
    with pytest.raises(ValueError, match="cuts"):
        load_checkpoint(path, _port_tree(0), expect_cuts=(2, 3))
    with pytest.raises(ValueError, match="no 'intervals'"):
        check_schedule_meta({"cuts": [1, 3]}, expect_intervals=(2, 2, 1))


def test_save_is_atomic_and_leaves_no_temp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    save_checkpoint("bare.npz", {"a": torch.ones(2)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bare.npz"]


def _jax_lm_tree(seed):
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models.model import SplittableModel as JaxModel
    return jax_replicate(JaxModel(jax_get_reduced("qwen2-1.5b")).init_params(
        jax.random.PRNGKey(seed)), 3)


def _port_lm_tree(seed):
    from repro_torch.configs import get_reduced
    from repro_torch.models import SplittableModel
    p = SplittableModel(get_reduced("qwen2-1.5b")).init_params(
        torch.Generator().manual_seed(seed), CPU)
    return replicate_for_clients(p, 3)


def _leaves(tree):
    return _flatten(params_from_numpy(params_to_numpy(tree), CPU))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_stacked_transformer_checkpoint_cross_loads(tmp_path, direction):
    """A client-stacked dense transformer tree (units stacked on axis 1,
    keys such as units/attn/wq) passes between the packages leaf for leaf."""
    path = str(tmp_path / f"{direction}.npz")
    if direction == "port_to_jax":
        tree = _port_lm_tree(1)
        save_checkpoint(path, tree, step=3, meta=META)
        got, step, meta = jax_load(path, _jax_lm_tree(2), expect_cuts=(1, 3))
    else:
        tree = _jax_lm_tree(3)
        jax_save(path, tree, step=3, meta=META)
        got, step, meta = load_checkpoint(path, _port_lm_tree(4), expect_cuts=(1, 3))
        assert isinstance(got["units"]["attn"]["bq"], torch.Tensor)
    assert step == 3 and meta == META
    want, have = _leaves(tree), _leaves(got)
    assert want.keys() == have.keys() and "units/attn/wq" in have
    assert have["units/attn/wq"].shape[:2] == (3, 2)
    for k, v in want.items():
        assert have[k].dtype == v.dtype
        np.testing.assert_array_equal(have[k], v, err_msg=k)
