"""Batched decode driver (serve_step) — port of ``repro.launch.serve``.

After HSFL training converges, the fed server owns the aggregated model;
this driver runs batched autoregressive decoding against the KV and Mamba
caches (``SplittableModel.init_caches`` / ``decode_step``), every decode
attention on the B4d kernel.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --batch 4 --prompt-len 16 --gen 32

As the JAX CLI, it serves the arch's REDUCED variant from a seeded init,
or the parameters of ``--checkpoint`` (either layout, see
``load_serving_params``; the npz layout is the JAX package's, so a
checkpoint written by JAX loads here).  The prompt is prefilled by
repeated decode, then ``--gen`` tokens are sampled greedily or, with
``--temperature`` > 0, from the softmax through a ``torch.Generator``
seeded from ``--seed``.  ``generate`` is that loop, for callers that hold a
model and its parameters.  The VLM and audio ids exit as the JAX CLI does:
the CLI decodes text-only archs.  Runs on the first CUDA device; ``--device cpu``
asks for the CPU (decode attention then takes its plain version).
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from .._tree import tree_map


def _first_leaf(tree, prefix=()):
    """(key path, leaf) of the first leaf in JAX's flattening order (dict
    keys sorted), so the errors name the leaf the JAX package names."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            found = _first_leaf(tree[k], prefix + (str(k),))
            if found is not None:
                return found
        return None
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            found = _first_leaf(v, prefix + (str(i),))
            if found is not None:
                return found
        return None
    return "/".join(prefix), tree


def load_serving_params(path: str, template):
    """Restore serving params from either checkpoint layout.

    ``launch.train`` saves the Engine-A *client-stacked* state (every leaf
    carries a leading client axis N).  After the top-tier cloud sync every
    client row holds the aggregated model, so the serving copy is row 0.  A
    plain single-model checkpoint restores as it is.  Leaves take the
    template's dtypes and devices.
    """
    from ..checkpoint import load_checkpoint
    from ..core.engine import replicate_for_clients, unreplicate

    try:
        params, _, _ = load_checkpoint(path, template)
        return params
    except ValueError:
        pass  # shapes mismatched — try the client-stacked layout
    key0, leaf0 = _first_leaf(template)
    with np.load(path) as z:
        if key0 not in z:
            raise KeyError(f"checkpoint missing leaf {key0!r}")
        saved = z[key0].shape
    want = tuple(leaf0.shape)
    if len(saved) != len(want) + 1:
        raise ValueError(
            f"checkpoint leaf {key0!r} has shape {saved}, which is neither "
            f"the serving shape {want} nor client-stacked (N,)+{want}"
        )
    n = int(saved[0])
    stacked, _, _ = load_checkpoint(path, replicate_for_clients(template, n))
    # row 0 copied, so the other N - 1 rows are freed
    return tree_map(torch.clone, unreplicate(stacked))


class Generation(NamedTuple):
    tokens: torch.Tensor  # [B, gen]: the sampled tokens, as the JAX loop collects them
    fed: torch.Tensor  # [B, prompt + gen]: every token fed to decode_step, in order
    logits: Optional[torch.Tensor]  # [B, prompt + gen, padded_vocab] f32, when kept


def generate(model, params, prompt: torch.Tensor, gen: int, cache_len: int, *,
             temperature: float = 0.0, generator: Optional[torch.Generator] = None,
             keep_logits: bool = False) -> Generation:
    """The JAX CLI's loop: prefill ``prompt`` [B, P] by P decode steps, take
    the argmax of the last, then ``gen`` steps, each feeding the previous
    token and sampling the next (argmax, or for ``temperature`` > 0 a draw
    from softmax(logits / temperature) through ``generator``, which must sit
    on the prompt's device).  Caches of ``cache_len`` on the prompt's
    device.  With ``keep_logits`` every step's logits come back, so a caller
    can hold the run against the forward on ``fed`` (teacher forcing)."""
    spec = model.spec
    B, P = prompt.shape
    V = spec.vocab_size
    caches = model.init_caches(B, cache_len, prompt.device)
    fed: List[torch.Tensor] = []
    kept: List[torch.Tensor] = []
    out: List[torch.Tensor] = []

    def step(tok, i):
        logits, _ = model.decode_step(params, tok, caches, i)
        fed.append(tok)
        if keep_logits:
            kept.append(logits.float())
        return logits

    with torch.no_grad():
        for i in range(P):
            logits = step(prompt[:, i : i + 1], i)
        tok = torch.argmax(logits[:, :V], dim=-1)[:, None]
        for i in range(gen):
            logits = step(tok, P + i)
            if temperature > 0:
                probs = torch.softmax(logits[:, :V].float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = torch.argmax(logits[:, :V], dim=-1)[:, None]
            out.append(tok)
    empty = prompt.new_zeros((B, 0))
    return Generation(
        tokens=torch.cat(out, dim=1) if out else empty,
        fed=torch.cat(fed, dim=1) if fed else empty,
        logits=torch.stack(kept, dim=1) if kept else None,
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from ..configs import get_reduced
    from ..models.model import SplittableModel

    device = resolve_device(args.device)
    spec = get_reduced(args.arch)
    if spec.family in ("vlm", "audio"):
        raise SystemExit(f"{args.arch}: decode driver supports text-only archs")
    model = SplittableModel(spec)
    params = model.init_params(torch.Generator().manual_seed(args.seed), device)
    if args.checkpoint:
        params = load_serving_params(args.checkpoint, params)
        print(f"restored {args.checkpoint}")

    B = args.batch
    prompt = torch.randint(0, spec.vocab_size, (B, args.prompt_len),
                           generator=torch.Generator().manual_seed(args.seed + 1),
                           dtype=torch.int32).to(device)
    sampler = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.perf_counter()
    run = generate(model, params, prompt, args.gen, args.cache_len,
                   temperature=args.temperature, generator=sampler)
    sample = run.tokens[0, :16].tolist()  # waits for the device
    dt = time.perf_counter() - t0
    total = B * (args.prompt_len + args.gen)
    print(f"[serve] arch={spec.name} batch={B} prompt={args.prompt_len} "
          f"gen={args.gen}: {total/dt:.1f} tok/s ({dt:.2f}s)")
    print("sample tokens:", sample)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
