"""PyTorch/CUDA port of stylegan_for_facerec_tpu for NVIDIA Hopper.

Slice 1: iterative ReStyle pSp inversion: the IR-SE encoder, the
StyleGAN2-ADA synthesis network with hand-written CUDA kernels for its
fused bias-activation (B1) and smooth 2x upsample (B2), weight transfer
from the JAX package, checkpoints and the inversion CLI.
Slice 2: stage-2 encoder training (the ReStyle pSp coach): the backward
kernels B1b and B2b behind autograd Functions, LPIPS and the identity
losses, Ranger, logging, the checkpoint manager, preemption handling and
the training CLI.
Slice 3: stage-3 face recognition: the IR/IR-SE backbones and the pSp
face-recognition backbone with block dropout and ghost BatchNorm, the
margin heads, focal loss, the SGD trainer, the face datasets, packed
shards and the prefetch to the card, RFW verification, and the training
and verification CLIs. No kernel of its own: its path runs cuDNN and
PyTorch operations only.
Slice 4: stage-1 StyleGAN2-ADA GAN pretraining: the rosinality
discriminator (its activations through B1/B1b, its blurs through
``ops/upfirdn2d.py``), ADA, the mapping network's ``w_avg`` EMA and
truncation, the trainer with lazy R1 (B1b's double backward) and path
length (B2b's backward, B2), g_ema, FID, the stage-1 CLI and the
stage-1 -> stage-2 handoff.
"""
