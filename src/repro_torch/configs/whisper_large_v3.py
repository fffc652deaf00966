"""whisper-large-v3 [audio] — enc-dec, conv/mel frontend stubbed [arXiv:2212.04356]."""
import dataclasses
from ..models.spec import ModelSpec

SPEC = ModelSpec(
    name="whisper-large-v3", family="audio", num_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, d_ff=5120, vocab_size=51866,
    encoder_layers=32, encoder_len=1500,
    source="arXiv:2212.04356",
)

REDUCED = dataclasses.replace(
    SPEC, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, encoder_layers=2, encoder_len=16,
)
