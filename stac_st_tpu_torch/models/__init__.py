"""The serving model: conv front end, pre-LN Transformer, linear heads."""

from .frontend import ConvolutionFrontEnd
from .multitask import LinearHead, TransformerMultiTask, glorot_init_

__all__ = ["ConvolutionFrontEnd", "LinearHead", "TransformerMultiTask",
           "glorot_init_"]
