from .heads import HEAD_REGISTRY, build_head
from .irse import (IR_50, IR_101, IR_152, IR_SE_50, IR_SE_101, IR_SE_152,
                   Backbone, l2_norm)
from .e4e import (E4e, LatentCodesDiscriminator, LatentCodesPool,
                  ProgressiveBackboneEncoder)
from .psp import (ENCODER_TYPES, BackboneEncoder, BackboneEncoderDiffHead,
                  GradualStyleEncoder, PSPOutputLayer, PSp, PSpFaceRec,
                  ResNetBackboneEncoder, build_encoder, build_psp,
                  n_styles_for, style_spatial_for)

__all__ = ["Backbone", "BackboneEncoder", "BackboneEncoderDiffHead", "E4e",
           "ENCODER_TYPES", "GradualStyleEncoder", "HEAD_REGISTRY", "IR_50",
           "IR_101", "IR_152", "IR_SE_50", "IR_SE_101", "IR_SE_152",
           "LatentCodesDiscriminator", "LatentCodesPool",
           "ProgressiveBackboneEncoder", "PSPOutputLayer", "PSp",
           "PSpFaceRec", "ResNetBackboneEncoder", "build_encoder",
           "build_head", "build_psp", "l2_norm", "n_styles_for",
           "style_spatial_for"]
