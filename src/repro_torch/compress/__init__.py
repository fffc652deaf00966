# Communication compression, priced end-to-end (DESIGN.md §9) — port of
# ``repro.compress``:
#   base       -- Compressor protocol + the analytic CompressionSpec
#   identity   -- full-precision no-op codec (differential anchor)
#   quantize   -- stochastic int8 with per-tile scales (+ the shared wire
#                 format the fused aggregation kernels B2/B3 consume)
#   topk       -- top-k sparsification + error-feedback accumulator
from .base import Compressor, CompressionSpec, act_ratio, measure_omega, model_ratio
from .identity import Identity
from .quantize import Int8Stochastic, q8_dequantize, q8_quantize
from .topk import ErrorFeedback, TopK

SCHEMES = {
    "identity": Identity,
    "int8": Int8Stochastic,
    "top-k": TopK,
}
