from . import (attention, efficientnet, gac, ghostnet, heads_extra,
               mobilefacenet, mtcnn, resnet)
from .attention import AttentionNet_56, AttentionNet_92, ResidualAttentionNet
from .efficientnet import EfficientNet, EfficientNetB0
from .ghostnet import GhostNet
from .heads import HEAD_REGISTRY, build_head
from .inception import InceptionV3
from .irse import (IR_50, IR_101, IR_152, IR_SE_50, IR_SE_101, IR_SE_152,
                   Backbone, l2_norm)
from .mobilefacenet import MobileFaceNet
from .mtcnn import MTCNN
from .resnet import ResNet, ResNet_50, ResNet_101, ResNet_152
from .e4e import (E4e, LatentCodesDiscriminator, LatentCodesPool,
                  ProgressiveBackboneEncoder)
from .psp import (ENCODER_TYPES, BackboneEncoder, BackboneEncoderDiffHead,
                  GradualStyleEncoder, PSPOutputLayer, PSp, PSpFaceRec,
                  ResNetBackboneEncoder, build_encoder, build_psp,
                  n_styles_for, style_spatial_for)
from .stylegan2 import Discriminator
from .stylegan2 import Generator as GeneratorRosinality
from .stylegan2_ada import (FullyConnectedLayer, Generator, MappingNetwork,
                            SynthesisNetwork)

__all__ = ["attention", "efficientnet", "gac", "ghostnet", "heads_extra",
           "mobilefacenet", "mtcnn", "resnet", "MTCNN", "AttentionNet_56", "AttentionNet_92",
           "EfficientNet", "EfficientNetB0", "GhostNet", "MobileFaceNet",
           "ResNet", "ResNet_50", "ResNet_101", "ResNet_152",
           "ResidualAttentionNet", "Backbone", "BackboneEncoder", "BackboneEncoderDiffHead",
           "Discriminator", "E4e", "ENCODER_TYPES", "FullyConnectedLayer",
           "Generator", "GeneratorRosinality", "GradualStyleEncoder",
           "HEAD_REGISTRY", "IR_50", "IR_101", "IR_152", "IR_SE_50",
           "IR_SE_101", "IR_SE_152", "InceptionV3",
           "LatentCodesDiscriminator", "LatentCodesPool", "MappingNetwork",
           "ProgressiveBackboneEncoder", "PSPOutputLayer", "PSp",
           "PSpFaceRec", "ResNetBackboneEncoder", "SynthesisNetwork",
           "build_encoder", "build_head", "build_psp", "l2_norm",
           "n_styles_for", "style_spatial_for"]
