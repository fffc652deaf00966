"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887]."""
import dataclasses
from ..models.spec import ModelSpec, MoeSpec, SsmSpec

SPEC = ModelSpec(
    name="jamba-1.5-large-398b", family="hybrid", num_layers=72, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=24576, vocab_size=65536,
    moe=MoeSpec(num_experts=16, top_k=2),
    ssm=SsmSpec(state_dim=128, head_dim=128, expand=2, conv_width=4, chunk=256),
    attn_period=8, moe_period=2,
    source="arXiv:2403.19887",
)

REDUCED = dataclasses.replace(
    SPEC, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32, attn_period=2, moe_period=2,
    moe=MoeSpec(num_experts=4, top_k=2),
    ssm=SsmSpec(state_dim=16, head_dim=32, expand=2, conv_width=4, chunk=16),
)
