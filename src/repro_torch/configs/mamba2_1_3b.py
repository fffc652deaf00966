"""mamba2-1.3b [ssm] — SSD state-space duality, attention-free [arXiv:2405.21060]."""
import dataclasses
from ..models.spec import ModelSpec, SsmSpec

SPEC = ModelSpec(
    name="mamba2-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm=SsmSpec(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

REDUCED = dataclasses.replace(
    SPEC, num_layers=2, d_model=128, vocab_size=512,
    ssm=SsmSpec(state_dim=16, head_dim=32, expand=2, conv_width=4, chunk=32),
)
