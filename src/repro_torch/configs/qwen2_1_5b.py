"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671]."""
import dataclasses
from ..models.spec import ModelSpec

SPEC = ModelSpec(
    name="qwen2-1.5b", family="dense", num_layers=28, d_model=1536,
    num_heads=12, num_kv_heads=2, d_ff=8960, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
    source="arXiv:2407.10671",
)

REDUCED = dataclasses.replace(
    SPEC, num_layers=2, d_model=192, num_heads=6, num_kv_heads=2,
    d_ff=384, vocab_size=512, head_dim=32,
)
