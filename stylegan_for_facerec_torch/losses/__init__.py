from .identity import make_moco_extractor, similarity_loss, w_norm_loss
from .perceptual import (LPIPS, AlexNetFeatures, VGG16Features,
                         normalize_activation)

__all__ = ["LPIPS", "AlexNetFeatures", "VGG16Features", "make_moco_extractor",
           "normalize_activation", "similarity_loss", "w_norm_loss"]
