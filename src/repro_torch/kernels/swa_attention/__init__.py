from .ops import (
    HEAD_DIMS,
    decode_launch_splits,
    decode_launches,
    decode_splits,
    dkv_launch_splits,
    dkv_splits,
    launches,
    reset_launches,
    swa_attention,
    swa_attention_bwd,
    swa_attention_bwd_dkv,
    swa_attention_bwd_dq,
    swa_attention_fwd,
    swa_decode,
)
from .ref import (
    swa_attention_bwd_dkv_ref,
    swa_attention_bwd_dq_ref,
    swa_attention_bwd_ref,
    swa_attention_ref,
    swa_decode_ref,
)
