"""PyTorch/CUDA port of stylegan_for_facerec_tpu for NVIDIA Hopper.

This slice covers iterative ReStyle pSp inversion: the IR-SE encoder, the
StyleGAN2-ADA synthesis network with hand-written CUDA kernels for its
fused bias-activation (B1) and smooth 2x upsample (B2), weight transfer
from the JAX package, checkpoints and the inversion CLI.
"""
