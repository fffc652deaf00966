"""granite-moe-1b-a400m [moe] — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
import dataclasses
from ..models.spec import ModelSpec, MoeSpec

SPEC = ModelSpec(
    name="granite-moe-1b-a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=512, vocab_size=49155,
    moe=MoeSpec(num_experts=32, top_k=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

REDUCED = dataclasses.replace(
    SPEC, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, moe=MoeSpec(num_experts=4, top_k=2),
)
