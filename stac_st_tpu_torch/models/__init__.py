"""The serving model: conv front end, pre-LN Transformer, linear heads."""

from .frontend import ConvolutionFrontEnd
from .multitask import (
    EncoderWrapper,
    LinearHead,
    ModuleGroup,
    TransformerMultiTask,
    glorot_init_,
)

__all__ = ["ConvolutionFrontEnd", "EncoderWrapper", "LinearHead",
           "ModuleGroup", "TransformerMultiTask", "glorot_init_"]
