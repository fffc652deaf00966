"""The port's serving driver (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``): ``generate`` against the JAX CLI's
decode loop on one NumPy prompt and converted params, the seeded
temperature path, ``main`` on the CPU, and ``load_serving_params`` on
checkpoints that JAX wrote, in both layouts, with JAX's errors.  REDUCED
sizes.

Greedy tokens are compared with ``==``.  That is sound only where argmax
cannot flip between the packages: at every step whose argmax is a token,
JAX's top-2 logit margin is asserted to exceed 10 times the largest
|port − JAX| logit difference of the run (the logits, ~1 in size, differ
by 0.8–3.4e-6; the smallest margin, smollm-135m's, is 9.43e-5)."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import save_checkpoint as jax_save
from repro.core.engine import replicate_for_clients as jax_replicate
from repro.launch.serve import load_serving_params as jax_load_serving
from repro.models.model import SplittableModel as JaxModel
import repro_torch.configs as tconfigs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import replicate_for_clients
from repro_torch.launch import serve
from repro_torch.models import SplittableModel, params_from_numpy, params_to_numpy

CPU = torch.device("cpu")
MARGIN_OVER_ERR = 10


def _jax_loop(jm, params, prompt, gen):
    """``repro.launch.serve.main``'s greedy loop on a given prompt: the
    sampled tokens and every step's logits."""
    spec = jm.spec
    B, P = prompt.shape
    caches = jm.init_caches(B, P + gen)
    decode = jax.jit(jm.decode_step)
    steps = []
    for i in range(P):
        logits, caches = decode(params, jnp.asarray(prompt[:, i : i + 1]), caches, jnp.int32(i))
        steps.append(np.asarray(logits))
    tok = jnp.argmax(logits[:, : spec.vocab_size], axis=-1)[:, None]
    out = []
    for i in range(gen):
        logits, caches = decode(params, tok, caches, jnp.int32(P + i))
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, : spec.vocab_size], axis=-1)[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1)), np.stack(steps, 1)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-1.5b", "mamba2-1.3b",
                                  "granite-moe-1b-a400m"])
def test_generate_greedy_equals_the_jax_loop(arch):
    js, ts = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jm, tm = JaxModel(js), SplittableModel(ts)
    p = params_to_numpy(jm.init_params(jax.random.PRNGKey(0)))
    B, P, G = 2, 6, 10
    prompt = np.random.default_rng(0).integers(0, js.vocab_size, (B, P)).astype(np.int32)
    jtok, jlogits = _jax_loop(jm, p, prompt, G)
    run = serve.generate(tm, params_from_numpy(p, CPU), torch.from_numpy(prompt), G, P + G,
                         keep_logits=True)
    np.testing.assert_array_equal(run.tokens.numpy(), jtok)
    assert run.fed.shape == (B, P + G) and run.logits.shape == (B, P + G, js.padded_vocab)
    np.testing.assert_array_equal(run.fed[:, :P].numpy(), prompt)
    err = np.abs(run.logits.numpy() - jlogits).max()
    assert err <= 2e-5 * np.abs(jlogits).max(), err
    # the steps whose argmax is a token: the last of the prompt and every later one
    top2 = np.sort(jlogits[:, P - 1 :, : js.vocab_size], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MARGIN_OVER_ERR * err


def test_temperature_sampling_repeats_from_a_seed():
    ts = tconfigs.get_reduced("smollm-135m")
    tm = SplittableModel(ts)
    params = tm.init_params(torch.Generator().manual_seed(0), CPU)
    prompt = torch.randint(0, ts.vocab_size, (3, 4), generator=torch.Generator().manual_seed(1))

    def draw(seed):
        return serve.generate(tm, params, prompt, 12, 16, temperature=1.0,
                              generator=torch.Generator().manual_seed(seed)).tokens

    a, b, c = draw(7), draw(7), draw(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    greedy = serve.generate(tm, params, prompt, 12, 16).tokens
    assert not torch.equal(a, greedy)


def test_main_on_the_cpu(capsys):
    rc = serve.main(["--arch", "smollm-135m", "--batch", "2", "--prompt-len", "4",
                     "--gen", "4", "--cache-len", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert re.search(r"\[serve\] arch=smollm-135m batch=2 prompt=4 gen=4: [\d.]+ tok/s", out)
    assert "sample tokens:" in out


def test_main_serves_a_port_checkpoint_with_temperature(tmp_path, capsys):
    ts = tconfigs.get_reduced("smollm-135m")
    params = SplittableModel(ts).init_params(torch.Generator().manual_seed(3), CPU)
    path = str(tmp_path / "stacked.npz")
    save_checkpoint(path, replicate_for_clients(params, 4), step=8)
    argv = ["--arch", "smollm-135m", "--batch", "2", "--prompt-len", "3", "--gen", "5",
            "--cache-len", "8", "--device", "cpu", "--checkpoint", path,
            "--temperature", "0.7", "--seed", "2"]
    assert serve.main(argv) == 0
    first = capsys.readouterr().out
    assert f"restored {path}" in first
    assert serve.main(argv) == 0
    again = capsys.readouterr().out
    tokens = [re.search(r"sample tokens: (.*)", o).group(1) for o in (first, again)]
    assert tokens[0] == tokens[1]


def test_main_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-135m"])


@pytest.mark.parametrize("layout", ["plain", "client-stacked"])
def test_load_serving_params_restores_jax_checkpoints(tmp_path, layout):
    js, ts = jconfigs.get_reduced("qwen2-1.5b"), tconfigs.get_reduced("qwen2-1.5b")
    p = JaxModel(js).init_params(jax.random.PRNGKey(2))
    template_j = JaxModel(js).init_params(jax.random.PRNGKey(9))
    path = str(tmp_path / f"{layout}.npz")
    jax_save(path, p if layout == "plain" else jax_replicate(p, 3), step=4)
    want = params_to_numpy(jax_load_serving(path, template_j))
    template = SplittableModel(ts).init_params(torch.Generator().manual_seed(9), CPU)
    got = params_to_numpy(serve.load_serving_params(path, template))
    flat_w, flat_g = jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for (path_, w), g in zip(flat_w, flat_g):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=str(path_))
    np.testing.assert_array_equal(got["units"]["attn"]["wq"], np.asarray(p["units"]["attn"]["wq"]))


def _error(fn):
    try:
        fn()
    except (ValueError, KeyError) as e:
        return type(e), str(e)
    raise AssertionError("no error")


def test_load_serving_params_raises_the_jax_errors(tmp_path):
    """A leaf of neither layout's shape, and a missing leaf: the same
    exception and message as JAX's ``load_serving_params``."""
    js, ts = jconfigs.get_reduced("smollm-135m"), tconfigs.get_reduced("smollm-135m")
    template_j = JaxModel(js).init_params(jax.random.PRNGKey(0))
    template = SplittableModel(ts).init_params(torch.Generator().manual_seed(0), CPU)
    bad = jax.tree.map(lambda x: jnp.zeros((2, 2) + x.shape, x.dtype), template_j)
    path = str(tmp_path / "bad.npz")
    jax_save(path, bad)
    want = _error(lambda: jax_load_serving(path, template_j))
    assert want[0] is ValueError and "neither the serving shape" in want[1]
    assert _error(lambda: serve.load_serving_params(path, template)) == want
    missing = str(tmp_path / "missing.npz")
    jax_save(missing, {"other": jnp.zeros(3)})
    want = _error(lambda: jax_load_serving(missing, template_j))
    assert want[0] is KeyError
    assert _error(lambda: serve.load_serving_params(missing, template)) == want
