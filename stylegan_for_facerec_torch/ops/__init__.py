"""Ops of the PyTorch port: kernels B1 and B2 with their plain versions,
the modulated convolution and the bilinear resize."""

from .fused_act import bias_act, bias_act_plain
from .image import resize_bilinear
from .modconv import modulated_conv2d
from .resample import smooth_upsample, smooth_upsample_plain

__all__ = ["bias_act", "bias_act_plain", "modulated_conv2d",
           "resize_bilinear", "smooth_upsample", "smooth_upsample_plain"]
