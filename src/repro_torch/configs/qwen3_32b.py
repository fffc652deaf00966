"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B]."""
import dataclasses
from ..models.spec import ModelSpec

SPEC = ModelSpec(
    name="qwen3-32b", family="dense", num_layers=64, d_model=5120,
    num_heads=64, num_kv_heads=8, d_ff=25600, vocab_size=151936,
    qk_norm=True, head_dim=128, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)

REDUCED = dataclasses.replace(
    SPEC, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=512, head_dim=32,
)
