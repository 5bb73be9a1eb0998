"""The serving model: conv front end, Transformer or Conformer encoder,
Transformer decoder, linear heads."""

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
