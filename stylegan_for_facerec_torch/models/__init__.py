from .heads import HEAD_REGISTRY, build_head
from .irse import (IR_50, IR_101, IR_152, IR_SE_50, IR_SE_101, IR_SE_152,
                   Backbone, l2_norm)
from .psp import (BackboneEncoderDiffHead, PSp, PSpFaceRec, build_psp,
                  n_styles_for, style_spatial_for)

__all__ = ["Backbone", "BackboneEncoderDiffHead", "HEAD_REGISTRY", "IR_50",
           "IR_101", "IR_152", "IR_SE_50", "IR_SE_101", "IR_SE_152", "PSp",
           "PSpFaceRec", "build_head", "build_psp", "l2_norm",
           "n_styles_for", "style_spatial_for"]
