"""qwen2.5-14b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B]."""
import dataclasses
from ..models.spec import ModelSpec

SPEC = ModelSpec(
    name="qwen2.5-14b", family="dense", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, d_ff=13824, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B",
)

REDUCED = dataclasses.replace(
    SPEC, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=512, head_dim=32,
)
