# Fed-wire codecs.  Only the int8 codec is ported so far; ``Identity``,
# ``TopK``/``ErrorFeedback`` and the ``base`` pricing helpers come later
# (ROADMAP A5b).
from .quantize import Int8Stochastic, q8_dequantize, q8_quantize
