"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
import dataclasses
from ..models.spec import ModelSpec

SPEC = ModelSpec(
    name="smollm-135m", family="dense", num_layers=30, d_model=576,
    num_heads=9, num_kv_heads=3, d_ff=1536, vocab_size=49152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

REDUCED = dataclasses.replace(
    SPEC, num_layers=2, d_model=192, num_heads=3, num_kv_heads=3,
    d_ff=384, vocab_size=512,
)
