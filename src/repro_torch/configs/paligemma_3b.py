"""paligemma-3b [vlm] — SigLIP(stub) + gemma backbone [arXiv:2407.07726]."""
import dataclasses
from ..models.spec import ModelSpec

SPEC = ModelSpec(
    name="paligemma-3b", family="vlm", num_layers=18, d_model=2048,
    num_heads=8, num_kv_heads=1, d_ff=16384, vocab_size=257216,
    head_dim=256, tie_embeddings=True, prefix_len=256,
    source="arXiv:2407.07726",
)

REDUCED = dataclasses.replace(
    SPEC, num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
    d_ff=256, vocab_size=512, head_dim=32, prefix_len=4,
)
