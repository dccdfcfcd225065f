from .focal import (cross_entropy_per_sample, focal_loss,
                    focal_loss_per_sample, softmax_cross_entropy,
                    topk_accuracy)
from .identity import (id_loss, make_irse_id_extractor, make_moco_extractor,
                       similarity_loss, w_norm_loss)
from .perceptual import (LPIPS, AlexNetFeatures, VGG16Features,
                         normalize_activation)

__all__ = ["LPIPS", "AlexNetFeatures", "VGG16Features",
           "cross_entropy_per_sample", "focal_loss", "focal_loss_per_sample",
           "id_loss", "make_irse_id_extractor", "make_moco_extractor",
           "normalize_activation", "similarity_loss",
           "softmax_cross_entropy", "topk_accuracy", "w_norm_loss"]
