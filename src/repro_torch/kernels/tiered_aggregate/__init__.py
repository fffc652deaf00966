from .ops import (
    TILE_P,
    aggregate_tree,
    launches,
    quantized_tiered_aggregate,
    ragged_aggregate_tree,
    ragged_quantized_tiered_aggregate,
    ragged_tiered_aggregate,
    ragged_tiered_aggregate_q8,
    reset_launches,
    tiered_aggregate,
    tiered_aggregate_q8,
)
from .ref import (
    quantized_tiered_aggregate_ref,
    ragged_quantized_tiered_aggregate_ref,
    ragged_tiered_aggregate_ref,
    tiered_aggregate_ref,
)
