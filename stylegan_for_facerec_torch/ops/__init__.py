"""Ops of the PyTorch port: kernels B1/B1b (bias-act and its gradient) and
B2/B2b (smooth 2x upsample and its adjoint) with their plain versions, the
smooth 2x downsample, the modulated convolution (and its per-sample-weight
oracle), the bilinear resize and upfirdn2d."""

from .fused_act import (bias_act, bias_act_grad, bias_act_grad_plain,
                        bias_act_plain, clamp_gain, fused_leaky_relu)
from .image import resize_bilinear, resize_bilinear_align_corners
from .modconv import modulated_conv2d, modulated_conv2d_grouped
from .resample import (smooth_downsample, smooth_upsample,
                       smooth_upsample_grad, smooth_upsample_grad_plain,
                       smooth_upsample_plain)
from .upfirdn2d import make_resample_kernel, upfirdn2d

__all__ = ["bias_act", "bias_act_grad", "bias_act_grad_plain",
           "bias_act_plain", "clamp_gain", "fused_leaky_relu",
           "make_resample_kernel", "modulated_conv2d",
           "modulated_conv2d_grouped", "resize_bilinear",
           "resize_bilinear_align_corners", "smooth_downsample",
           "smooth_upsample", "smooth_upsample_grad",
           "smooth_upsample_grad_plain", "smooth_upsample_plain",
           "upfirdn2d"]
