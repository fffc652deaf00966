"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
import dataclasses
from ..models.spec import ModelSpec, MoeSpec

SPEC = ModelSpec(
    name="phi3.5-moe-42b-a6.6b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=6400, vocab_size=32064,
    moe=MoeSpec(num_experts=16, top_k=2),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

REDUCED = dataclasses.replace(
    SPEC, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, moe=MoeSpec(num_experts=4, top_k=2),
)
