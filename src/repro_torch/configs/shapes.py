"""Assigned input shapes and batch factories — port of
``repro.configs.shapes``.

Shapes (assignment):
  train_4k       seq_len=  4,096  global_batch= 256  (training)
  prefill_32k    seq_len= 32,768  global_batch=  32  (inference-prefill)
  decode_32k     seq_len= 32,768  global_batch= 128  (inference-decode)
  long_500k      seq_len=524,288  global_batch=   1  (long-context-decode)

``input_specs`` gives every model input of a train or prefill step as a
tensor on the ``meta`` device (shape and dtype, no storage), where the JAX
package gives ``jax.ShapeDtypeStruct``s.  ``concrete_inputs`` draws a
small batch with an explicit ``torch.Generator``, with the JAX package's
keys, shapes, dtypes and ranges; ``jax.random`` and torch draw different
numbers from one seed, so a test that compares the two packages feeds both
the same numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .._device import DeviceLike, resolve_device
from ..models.spec import ModelSpec


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# sliding window applied to quadratic-attention archs for long_500k
LONG_CONTEXT_WINDOW = 8192


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: an empty tensor on the ``meta`` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(spec: ModelSpec, shape: InputShape) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of a train/prefill step (no
    allocation): the VLM's image-prefix embeddings [B, P, d] beside its
    S - P text tokens and labels, the audio model's frames, or tokens and
    labels [B, S] int32."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if spec.family == "vlm":
        P = spec.prefix_len
        return {
            "patch_embeds": sds((B, P, spec.d_model), spec.cdtype),
            "tokens": sds((B, S - P), i32),
            "labels": sds((B, S - P), i32),
        }
    if spec.family == "audio":
        return {
            "frames": sds((B, spec.encoder_len, spec.d_model), spec.cdtype),
            "tokens": sds((B, S), i32),
            "labels": sds((B, S), i32),
        }
    return {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}


def concrete_inputs(spec: ModelSpec, batch: int, seq: int,
                    generator: Optional[torch.Generator] = None,
                    device: Optional[DeviceLike] = None) -> Dict[str, torch.Tensor]:
    """A small concrete batch, drawn from ``generator`` (default: seed 0) on
    ``device`` (default: the first CUDA device; a generator on another
    device raises): embeddings standard normal in the compute dtype, tokens
    and labels uniform in [0, vocab_size) as int32 (``jax.random.randint``'s
    default dtype under the JAX package's x64-off setting).  ``seq`` counts
    the VLM's image prefix, which takes ``spec.prefix_len`` of it."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    V = spec.vocab_size

    def ints(n):
        return torch.randint(0, V, (batch, n), generator=generator, device=device,
                             dtype=torch.int32)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device).to(spec.cdtype)

    if spec.family == "vlm":
        P = spec.prefix_len
        return {"patch_embeds": normal(batch, P, spec.d_model), "tokens": ints(seq - P),
                "labels": ints(seq - P)}
    if spec.family == "audio":
        return {"frames": normal(batch, spec.encoder_len, spec.d_model), "tokens": ints(seq),
                "labels": ints(seq)}
    return {"tokens": ints(seq), "labels": ints(seq)}
