#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times
    python3 chip_smoke.py --b2-paths

Phases, each fatal on failure (nonzero exit, no result line):
  1. build kernels B1 (fused bias-act), B1b (its gradient), B2 (smooth 2x
     upsample) and B2b (its adjoint) from stylegan_for_facerec_torch/ops/
     csrc with nvcc, in parallel;
  2. hold each kernel against its plain PyTorch version on the card at
     every shape the inversion and training paths give it, in f32 and
     bf16: B1 forward, B1b through autograd (dx, db and the double
     backward, inputs scaled so the clamp saturates), B2 forward, B2b
     through autograd; all four also at ragged shapes (B2b at the
     gradients of B2's) and on a view at storage offset 1 (their scalar
     and packing paths; B2 with its staging in shared memory forced on
     and off). B1 and B1b must equal their plain versions bit for bit (in
     bf16: the plain version in f32, rounded once);
  3. inversion: full-width PSp(output_size=256, input_size=112) ReStyle
     inversion, seeded random weights, batch 8, 5 iterations, and check
     that it launched B1 13 and B2 12 times per iteration;
  4. run the same weights and inputs on the CPU (plain versions) at
     batch 2 for 2 iterations and compare with the card's result;
  5. time each kernel at its largest on-path shape beside its bound and
     its plain version; each kernel at every shape of one bf16 batch-128
     synthesis (13 B1 and 12 B2 launches) or train step's backward (13
     B1b and 12 B2b), summed beside the summed bound; run_on_batch in
     images/s;
  6. profile one bf16 batch-128 run_on_batch: device time by kernel, each
     kernel's total, and the device's busy share;
  7. training: Stage2Coach on the same PSp(256) at input 112, L2 1.0 +
     LPIPS-alex 0.8 (seeded random LPIPS), Ranger lr 1e-4, one refinement
     iteration, 3 steps at batch 8 in f32 with TF32 off: finite losses,
     the decoder unchanged bit for bit, the encoder moved, and per step
     B1 13, B2 12, B1b 13, B2b 12 launches (13 synthesis layers forward
     and back, 12 upsamples: 6 in the up layers, 6 of the image skip);
  8. one first train step from the same seeded weights and inputs at
     batch 2 on the card and on the CPU: loss, every encoder tensor's
     update and the BatchNorm running statistics agree;
  9. training images/s at bf16 batch 32 and 128 and f32 (TF32 off and on)
     batch 32;
 10. profile one bf16 batch-128 train step: device time by kernel and the
     busy share;
 11. stage-3 face-recognition training at full width: the recipe of
     configs/stage3_bupt_ir50.json (PSpFaceRec IR-SE-50 at 112 with block
     dropout 0.15, ArcFace s 64 m 0.5 over 28 000 classes, focal loss, SGD
     lr 0.03 momentum 0.9 weight decay 2e-3 without BatchNorm), its input
     layer and body handed over from phase 7's stage-2 coach with the
     coach's average image; 2 steps with the body frozen and 2 unfrozen at
     f32 batch 8 (TF32 off) on uint8 128 px images that come from packed
     shards through the loader and the pinned side-stream prefetch and are
     cropped and flipped in the step: finite losses, the body
     bit-unchanged over the frozen steps, the input layer, output layer
     and head moved, the BatchNorm running statistics moved, and no launch
     of B1, B1b, B2 or B2b;
 12. one first stage-3 step from the same weights and uint8 inputs at
     batch 4 on the card and on the CPU, dropout off: loss, every tensor's
     update and the BatchNorm running statistics agree;
 13. stage-3 training images/s and peak GiB at bf16 batch 100 and 256, f32
     batch 100 (TF32 off and on); the step's model FLOPs (FlopCounterMode)
     and stage3_train_mfu (FLOPs / step time / 989e12, bf16 batch 256); a
     profile of one bf16 batch-256 step;
 14. RFW-style verification with phase 11's backbone as handed over (before
     its steps on random labels, which pull the embeddings of different
     images together): 6000 seeded synthetic pairs at 112 px (12 000
     images of smooth random fields; a same-identity pair is one image
     twice) through perform_val with centre-crop TTA at batch 256 in f32
     and bf16: finite unit-norm
     embeddings, the first 32 within 1e-3 of the CPU's, 10-fold accuracy
     at least 0.99, no launch of B1, B1b, B2 or B2b; embed images/s.
 15. stage-1 GAN training at full width: the recipe of
     configs/stage1_stylegan2_ada.json (StyleGAN2-ADA G at 128², z/w 512, 8
     mapping layers; rosinality D at 128² with channel multiplier 2; batch
     8, R1 every 16 steps, path length every 4, ADA target 0.6 every 4,
     Adam (0, 0.99), g_ema 0.999), f32 with TF32 off, seeded weights and
     images: steps 0-4 through train_step (R1 and path length at step 0,
     path length and the ADA tick at step 4): finite losses, G, D and g_ema
     moved, w_avg moved in the G steps only, pl_mean in the path-length
     steps only, and each D and G step's B1/B1b/B2/B2b launches as PERF.md
     writes them (D 37/26/10/0, with R1 37/52/10/0; G 24/24/10/10, with
     path length 35/57/25/25); then at ada_p 0.5 every ADA group fires on
     the card, the card's ADA matches the CPU's, and a common step runs;
 16. a first D step with R1 and a first G step with path length from the
     same weights and draws at batch 4 (ada_p 0.5) on the card and on the
     CPU: losses, rt, plp, pl_new, w_avg and every gradient (0.1 of the
     tensor's largest plus 4 ulps), and the first Adam updates where the
     gradient is far above eps;
 17. stage-1 ms and images/s an iteration (D step + G step): common, path
     length, R1 + path length and the 16-step cycle's mean, at bf16 batch
     64 (bench.py's stage-1 cell) and f32 batch 8 with TF32 off and on;
     peak GiB; stage1_train_mfu (FlopCounterMode FLOPs of a common bf16
     batch-64 iteration over its time and 989e12);
 18. profiles of a common and of an R1 + path-length bf16 batch-64
     iteration (device time by kernel, busy share, B1/B1b/B2/B2b totals
     and launches) and each kernel's path_ms over the common iteration's
     shapes beside the summed bound.
 19. stage-2 e4e training at full width: E4eCoach on E4e(256) at input 112
     (phase 7's recipe plus the latent discriminator at lambda 0.1 with
     R1 10 every 16 steps and pools of 50, delta regularisation 2e-4,
     progressive stages 0, 1, 2 at steps 0, 1, 2), 3 iterations (encoder
     step + D step, R1 at step 0) at f32 batch 8 with TF32 off: finite
     losses, the delta loss 0 exactly at stage 0 only, the decoder and
     w_avg unchanged bit for bit, the live encoder tensors and D moved,
     the style heads of unreached stages kept, the BatchNorm running
     statistics moved by each encoder step and kept bit for bit by each
     D step, and each encoder step launching B1/B1b/B2/B2b 13/13/12/12
     times and each D step 0;
 20. one first e4e encoder step (stage 1) and D step with R1 from the same
     weights, inputs and z at batch 2 on the card and on the CPU: losses,
     every encoder update, the BatchNorm batch statistics, every D
     gradient and the first Adam updates of D, at phase 8's tolerances;
 21. encoder bootstrapping: the phase-19 E4e at the inference stage makes
     the first inversion and a PSp(256) runs the other 4 iterations, batch
     8 (65 B1 and 60 B2 launches); card vs CPU at batch 2 over 2
     iterations;
 22. e4e iteration ms and images/s at the inference stage (encoder step +
     D step without R1, and the D step alone, on the host's clock and in
     device time) at bf16 batch 128 (bench.py's e4e cell) and f32 batch 32;
     peak GiB; a profile of one bf16 batch-128 iteration (device time by
     kernel, busy share, B1/B1b/B2/B2b totals);
 23. the pSp encoder family on the card: every encoder build_encoder
     builds (GradualStyleEncoder and ResNetBackboneEncoder at 256 px, the
     IR-SE 34/50/100 and progressive backbones at 112) and the stage-3
     encoder's "pSp" and "both" heads, 16 styles, seeded weights and
     BatchNorm statistics, eval mode, batch 8: the expected shapes, finite,
     no B1/B1b/B2/B2b launch, and the CPU's codes at batch 2.
 24. the rosinality StyleGAN2 generator at full width (256², style 512, 8
     MLP layers, channel multiplier 2; seeded weights, biases and noise
     weights), f32 batch 8: from z with const noise (21 B1: 8 in the style
     MLP, 13 StyledConvs), from w with style mixing at inject_index 5 (13
     B1), truncation 0.7 toward mean_latent, random noise from a
     generator; no B2/B2b launch; the backward of the mean image from z to
     every parameter (21 B1b); card vs CPU at batch 2 (images at phase 4's
     tolerance; every gradient of a seeded weighting of the images at
     phase 8's tolerance of a float64 CPU run's, or no further from it
     than 4 times the CPU's f32 run); bf16 (autocast) against f32;
     synthesis images/s at bf16 batch 128 and f32 batch 8 and a profile of
     the bf16 one (the kernels' share of its device time). Phase 2 holds
     B1/B1b without clamp at its shapes;
 25. the same for the StyleGAN2-ADA G with synthesis_layer="stylegan1" at
     the pSp decoder's widths (13 B1, 12 B2 forward; 13 B1b, 12 B2b
     backward), and EqualizedConv2d (256 -> 256 channels, lrelu, gain 0.5)
     with resample up, down and none: launches each way, card vs CPU;
 26. InceptionV3 (FID variant, seeded weights and BatchNorm statistics)
     pool3 features of 256 g_ema samples of phase 15's stage-1 G (128²,
     resized to 299) and 256 seeded reals at batch 64 in f32 and bf16:
     (B, 2048) finite, the first 8 against the CPU's (f32) or against f32
     (bf16), embedding_fid of the reals with themselves ~0 and with the
     samples and a shifted set > 0, no B1/B1b/B2/B2b launch, images/s, a
     profile of the bf16 batch;
 27. 32 seeded PNG result/ground-truth pairs through calc_losses_on_images
     (l2, lpips, id; seeded weights) and their identity folder through
     extract_features_from_folder (a seeded IR-SE-50) on the card and on
     the CPU: the same numbers within phase 14's tolerance, no launch.
 28. stage 3 with the stage-3 CLI's other backbones (build_backbone) on
     phase 11's recipe: ResNet_50 (its dropout 0.5) and MobileFaceNet, 2
     "frozen" (they have no body: everything trains, as in the JAX
     package) and 2 unfrozen f32 batch-8 steps from packed shards; a first
     step against the CPU at batch 8 (the loss within 1e-3; each update
     within phase 12's tolerance of the CPU's, or of a float64 CPU step's
     or within 4x of the CPU f32 step's distance from it, since a ReLU or
     PReLU input within rounding of 0 takes the other branch on one
     device); train images/s and peak GiB at bf16 batch 256 and f32 batch
     100, stage3_train_mfu and a profile of the bf16 batch-256 step with
     the BatchNorm, depthwise, layout and elementwise shares; remat on and
     off for the recipe's PSpFaceRec at bf16 batch 256: the first step's
     loss, ms a step, peak GiB;
 29. the backbone zoo at full width (ResNet_101, AttentionNet_56,
     EfficientNetB0, GhostNet, gac_resnet50 with adaptive convs and
     attention), seeded weights and BatchNorm statistics, eval mode: card
     vs CPU as phase 24 (batch 2; GAC batch 4, its labels covering the
     four groups), bf16 batch-256 forward images/s;
 30. the seven extra heads at 512 x 28 000, batch 256, forward and
     backward: logits and the feature and class-weight gradients card vs
     CPU, ms; SSTPrototype (queue 16 384) over 3 steps with the same coins
     on both devices: logits, queue, cursor and labels;
 31. RB-WebFace: the test_rb_webface CLI on the card over a synthetic
     partition (4 groups of 100 identities x 5 PNGs and 1 000 negatives)
     with phase 28's ResNet_50, its counts against the same embeddings
     counted on the CPU (a difference only for pairs within 1e-5 of a
     threshold); the impostor sweep alone over 20 000 and 100 000 seeded
     unit embeddings (512-d): ms and peak GiB, no (T, chunk, M) tensor;
 32. the stage-3 CLI on the card from a reference-layout torch .pt (a
     seeded PSpFaceRec's encoder.* state_dict under the reference names):
     the input layer and body loaded bit for bit, 2 steps, the frozen
     body unchanged.
Phases 28-32 launch none of B1, B1b, B2 or B2b.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON, the one before that the card's name and power limit
as nvidia-smi reports them, and the ones before that the stage-1, stage-3,
e4e, phase 24-27 ("generators_fid_eval") and phase 28-32 ("stage3_zoo")
numbers as JSON. Exits
nonzero without a GPU.

--kernel-times builds the kernels, times each kernel at every shape one
synthesis or train step gives it at batch 8 and 128 in f32 and bf16,
profiles one bf16 batch-128 run_on_batch as phase 6 does and one bf16
batch-128 train step as phase 10 does, prints the times as one JSON line
and stops. A copy of this file placed at the root of an older checkout
(from the training slice on) times that checkout's kernels: run both
checkouts in turns in one session to compare.

--b2-paths builds the kernels and times B2 at every shape one synthesis
gives it at batch 8 and 128 in f32 and bf16 on each of its paths, forced:
staged in shared memory, and read straight from x (with the plan's
unstaged tiles, and with tiles of at least one pass of rows). It checks
that the paths' outputs are bit-equal, prints the times as one JSON line
and stops: the measurement behind the wrapper's staging threshold.
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from stylegan_for_facerec_torch.data.packed import (PackedLoader,
                                                    PackedTrainDataset,
                                                    device_prefetch,
                                                    write_packed)
from stylegan_for_facerec_torch.eval.inference import (encoder_bootstrap,
                                                      run_on_batch)
from stylegan_for_facerec_torch.eval.verification import evaluate
from stylegan_for_facerec_torch.eval.verify_runner import (compute_embeddings,
                                                           make_embed_fn,
                                                           perform_val)
from stylegan_for_facerec_torch.losses.perceptual import LPIPS
from stylegan_for_facerec_torch.models.e4e import PROGRESSIVE_STAGE_INFERENCE
from stylegan_for_facerec_torch.models.psp import (BackboneEncoderDiffHead,
                                                  PSpFaceRec, build_encoder,
                                                  build_psp, n_styles_for)
from stylegan_for_facerec_torch.eval.fid import embedding_fid
from stylegan_for_facerec_torch.eval.inference import \
    extract_features_from_folder
from stylegan_for_facerec_torch.models import GeneratorRosinality, InceptionV3
from stylegan_for_facerec_torch.models import (attention, efficientnet, gac,
                                               ghostnet, heads_extra, resnet)
from stylegan_for_facerec_torch.eval import rb_webface
from stylegan_for_facerec_torch.models.irse import IR_SE_50
from stylegan_for_facerec_torch.models.stylegan2 import (
    EqualLinear, NoiseInjection, rosinality_channels)
from stylegan_for_facerec_torch.models.stylegan2_ada import (
    EqualizedConv2d, FullyConnectedLayer, Generator, channels_for)
from stylegan_for_facerec_torch.tools import (calc_losses_on_images,
                                              test_rb_webface, train_stage3)
from stylegan_for_facerec_torch.nn.initializers import init_weights
from stylegan_for_facerec_torch.ops import build, resample
from stylegan_for_facerec_torch.ops.fused_act import (bias_act, bias_act_grad,
                                                      bias_act_grad_plain,
                                                      bias_act_plain)
from stylegan_for_facerec_torch.ops.resample import (
    smooth_upsample, smooth_upsample_grad, smooth_upsample_grad_plain,
    smooth_upsample_plain)
from stylegan_for_facerec_torch.nn.layers import Dropout
from stylegan_for_facerec_torch.train.ada_aug import apply_ada
from stylegan_for_facerec_torch.train.stage1 import Stage1Trainer
from stylegan_for_facerec_torch.train.stage2 import Stage2Coach, Stage2Config
from stylegan_for_facerec_torch.train.stage2_e4e import E4eCoach, E4eConfig
from stylegan_for_facerec_torch.train.stage3 import (Stage3Config,
                                                     Stage3Trainer)
from stylegan_for_facerec_torch.utils.checkpoint import load_stage2_encoder
from stylegan_for_facerec_torch.utils.config import (Stage1Config,
                                                    Stage3Options,
                                                    load_config)

OUTPUT_SIZE, INPUT_SIZE, BATCH, ITERS = 256, 112, 8, 5
CPU_BATCH, CPU_ITERS = 2, 2
TRAIN_STEPS, CPU_TRAIN_BATCH = 3, 2
# relative to the output's largest magnitude: the card's cuDNN convolutions
# (f32, TF32 off) and the CPU's sum in other orders through 50 IR-SE layers
# and 14 synthesis layers
CPU_REL_TOL = 1e-3
# a first train step's encoder update (-lr times the centralised gradient)
# against the CPU's, relative to each tensor's largest update: at batch 2
# a weight-gradient element of the 7x7 stages sums only 98 products, and a
# PReLU or ReLU input within f32 rounding of 0 on one device takes the
# other branch there, moving such an element by several per cent of the
# tensor's largest gradient. On top: 4 f32 ulps of the parameter (p + u
# rounds once per device, and many updates are a few ulps), and 1e-6 of
# the largest update of any tensor for gradients that are zero by
# construction (a shift the next BatchNorm removes) and come out as
# round-off
CPU_UPDATE_TOL = 0.1
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # f32 outside the tensor cores
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
B1_FLOPS_PER_ELEM = 5         # add, compare/select, mul, mul, clamp
B1B_FLOPS_PER_ELEM = 8        # add, compare, 2 mul (y), abs, compare, 2 mul
B2_FLOPS_PER_INPUT = 30       # 3 x 6 vertical + 2 x 6 horizontal
B2B_FLOPS_PER_INPUT = 24      # 2 g rows x 8 horizontally, 8 vertically
KERNELS = ("bias_act", "bias_act_grad", "smooth_upsample",
           "smooth_upsample_grad")
# shapes that reach B1's and B2's scalar and packing paths: HW = 63,
# (N, C) input, 1 x 1 planes, odd W, H and W past a tile's edge; B2's last
# two have rows that start 16-byte aligned, so B2 can stage them
B1_RAGGED = [(3, 5, 7, 9), (8, 512), (2, 3, 1, 1)]
B2_RAGGED = [(2, 3, 1, 1), (1, 2, 1, 7), (2, 5, 3, 9), (1, 64, 130, 66),
             (1, 64, 130, 136), (2, 64, 67, 72)]
PROFILE_NAMES = {"bias_act": "fused_bias_act_kernel",
                 "bias_act_grad": "fused_bias_act_grad_kernel",
                 "smooth_upsample": "smooth_upsample_kernel",
                 "smooth_upsample_grad": "smooth_upsample_grad_kernel"}
SQRT2 = math.sqrt(2.0)
# stage 3: the recipe's configuration file, BUPT-BalancedFace's 4 x 7000
# identities, the batches of each phase, one RFW ethnicity's pair count
STAGE3_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "configs", "stage3_bupt_ir50.json")
S3_CLASSES, S3_BATCH, S3_CPU_BATCH, S3_STEPS = 28000, 8, 4, 4
S3_RATES = (("bf16", "bfloat16", False, 100), ("bf16", "bfloat16", False, 256),
            ("f32", "float32", False, 100), ("tf32", "float32", True, 100))
S3_PROFILE_BATCH = 256
VERIFY_PAIRS, VERIFY_BATCH = 6000, 256
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 dense, NVIDIA data sheet
# stage 1: the recipe's configuration file (128², batch 8), the steps of
# the main path (0: R1 + path length, 1-3: neither, 4: path length and the
# ADA tick), the card-vs-CPU batch, the rate batch (bench.py's stage-1
# cell), and the launches of each step type at 128² (PERF.md, PR 6)
STAGE1_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "configs", "stage1_stylegan2_ada.json")
S1_STEPS, S1_CPU_BATCH, S1_RATE_BATCH = 5, 4, 64
S1_LAUNCHES = {
    ("d_step", False): (37, 26, 10, 0), ("d_step", True): (37, 52, 10, 0),
    ("g_step", False): (24, 24, 10, 10), ("g_step", True): (35, 57, 25, 25)}
S1_CYCLE = 16                 # steps of one R1 period
# e4e: the progressive schedule of the main path (stages 0, 1, 2 at steps
# 0, 1, 2), the rate batches (bench.py's e4e cell: bf16 batch 128) and
# the launches of one encoder step and of one D step
E4E_STEPS, E4E_PROGRESSIVE = 3, (0, 1, 2)
E4E_RATE_BATCH, E4E_F32_RATE_BATCH = 128, 32
E4E_ENC_LAUNCHES = {"bias_act": 13, "bias_act_grad": 13,
                    "smooth_upsample": 12, "smooth_upsample_grad": 12}
E4E_D_LAUNCHES = dict.fromkeys(E4E_ENC_LAUNCHES, 0)
# the rest of stage 2's generator side: the rosinality G (the JAX
# package's default family, at the size PSp runs), the StyleGAN1 ADA G at
# the pSp decoder's widths, their launches per forward (from z; from w the
# MLP's 8 B1 go) and per backward of a loss through both, the rate
# batches; InceptionV3 on 256 stage-1 g_ema samples and 256 reals at batch
# 64; the loss-evaluation folder's 32 pairs
ROSI_SIZE, ROSI_STYLE_DIM, ROSI_N_MLP = 256, 512, 8
ROSI_LAUNCHES = {"bias_act": 21, "bias_act_grad": 0, "smooth_upsample": 0,
                 "smooth_upsample_grad": 0}
SG1_LAUNCHES = {"bias_act": 13, "bias_act_grad": 0, "smooth_upsample": 12,
                "smooth_upsample_grad": 0}
GEN_RATES = (("bf16", 128), ("f32", BATCH))
# a gradient on the card may be further than phase 8's tolerance from the
# float64 run's where the CPU's own f32 run is too, by up to this factor
ROUNDOFF_FACTOR = 4.0
# bf16 against f32 on the same weights and w: 16 units of bf16 round-off
# (2^-8) of the image's largest value, over 13-21 layers
BF16_REL_TOL = 16 * 2.0 ** -8
FID_N, FID_BATCH, FID_CPU = 256, 64, 8
EVAL_PAIRS = 32
# stage 3 with the zoo (phases 28-32): the stage-3 CLI's other backbones on
# the recipe and their rates; the device-time kinds read from their
# profiles; the zoo's models and their rate batch; the extra heads' batch
# and SSTPrototype's queue; the RB-WebFace partition (groups, identities x
# images, negatives a group), the impostor sweeps' sizes and the distance
# from a threshold within which card and CPU counts may differ
ZOO_S3_BACKBONES = ("ResNet_50", "MobileFaceNet")
ZOO_S3_RATES = (("bf16", "bfloat16", 256), ("f32", "float32", 100))
PROFILE_KINDS = {"batchnorm": ("batch_norm", "bn_fw", "bn_bw"),
                 # cuDNN's depthwise kernels: one channel per group
                 "depthwise": ("depthwise", "c1_k1"),
                 "layout": ("nchwToNhwc", "nhwcToNchw"),
                 "elementwise": ("elementwise_kernel",)}
ZOO_MODELS = ("ResNet_101", "AttentionNet_56", "EfficientNetB0", "GhostNet",
              "gac_resnet50")
ZOO_RATE_BATCH = 256
HEAD_BATCH, SST_QUEUE, SST_STEPS = 256, 16384, 3
RBW_GROUPS, RBW_IDS, RBW_POS, RBW_NEG = 4, 100, 5, 1000
RBW_SWEEPS = (20000, 100000)
RBW_NEAR = 1e-5
RBW_NOISE = 3.0


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def on_path_shapes(batch: int = BATCH):
    """(B1 shapes, B2 shapes) that one inversion iteration or train step
    gives the kernels, NCHW (B1b takes B1's, B2b's output is B2's input).
    B1 runs once at 4x4 and twice at each larger resolution (13 launches),
    B2 once at each of its 12 shapes."""
    res = [2 ** i for i in range(2, int(math.log2(OUTPUT_SIZE)) + 1)]
    ch = channels_for(res)
    b1 = [(batch, ch[r], r, r) for r in res]
    b2 = [(batch, ch[r], r // 2, r // 2) for r in res[1:]]
    b2 += [(batch, 3, r // 2, r // 2) for r in res[1:]]
    return b1, b2


def stage1_shapes(batch: int, size: int = 128):
    """The shapes one stage-1 G forward and D forward give the kernels at
    ``size``: ``{"g_b1", "d_b1", "b2"}``, each ``{shape: launches}``. G's
    activations clamp at 256 (11 at 128²), D's ``fused_leaky_relu`` does
    not clamp (13, the last on (N, 512) at ``final_linear.0``); B2 runs
    in G's 5 up layers and 5 image skips."""
    res = [2 ** i for i in range(2, int(math.log2(size)) + 1)]
    ch = channels_for(res)
    g_b1 = {(batch, ch[4], 4, 4): 1}
    b2 = {}
    for r in res[1:]:
        g_b1[(batch, ch[r], r, r)] = 2
        b2[(batch, ch[r], r // 2, r // 2)] = 1
        b2[(batch, 3, r // 2, r // 2)] = 1
    dch = rosinality_channels(2)
    d_b1 = {}

    def add(shape):
        d_b1[shape] = d_b1.get(shape, 0) + 1

    add((batch, dch[size], size, size))
    for i in range(int(math.log2(size)), 2, -1):
        r = 2 ** i
        add((batch, dch[r], r, r))
        add((batch, dch[r // 2], r // 2, r // 2))
    add((batch, dch[4], 4, 4))
    add((batch, dch[4]))
    return {"g_b1": g_b1, "d_b1": d_b1, "b2": b2}


def rosinality_shapes(batch: int, size: int = ROSI_SIZE):
    """{shape: launches} of B1 (and B1b backward) in one forward of the
    rosinality G at ``size`` from z: the 8 style-MLP layers on
    (N, 512), ``conv1`` at 4x4 and two ``StyledConv``s at each larger
    resolution (13 at 256²; channels of multiplier 2)."""
    ch = rosinality_channels(2)
    out = {(batch, ROSI_STYLE_DIM): ROSI_N_MLP, (batch, ch[4], 4, 4): 1}
    for i in range(3, int(math.log2(size)) + 1):
        out[(batch, ch[2 ** i], 2 ** i, 2 ** i)] = 2
    return out


def check_b1_no_clamp(gen, dname, dtype, shapes, errs):
    """B1 and B1b (dx, db, double backward) with no clamp, the
    ``fused_leaky_relu`` of the rosinality D and G, against the plain
    versions at ``shapes``, bit for bit."""
    bits = torch.int32 if dname == "f32" else torch.int16
    for shape in shapes:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(
            dtype).requires_grad_()
        b = torch.randn(shape[1], generator=gen, device="cuda"
                        ).requires_grad_()
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g.requires_grad_()
        gg = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        y = bias_act(x, b, "lrelu", 1.0, None)
        want_y = bias_act_plain(x.detach().float(), b.detach(), "lrelu", 1.0,
                                None).to(dtype)
        if not torch.equal(y.detach().view(bits), want_y.view(bits)):
            fail(f"B1 {dname} {shape} no clamp: not bit-equal to the plain "
                 f"version")
        errs[("bias_act", dname)] = max(
            errs[("bias_act", dname)],
            (y.detach().float() - want_y.float()).abs().max().item())
        dx, db = torch.autograd.grad(y, (x, b), g, create_graph=True)
        (ddg,) = torch.autograd.grad(dx, g, gg)
        xd, bd = x.detach(), b.detach()
        want = bias_act_grad_plain(g.detach(), xd, bd, 0.2, SQRT2, None)
        want_dd = bias_act_grad_plain(gg, xd, bd, 0.2, SQRT2, None)
        err = max(b1b_check(dname, shape, dx, want, "dx, no clamp"),
                  b1b_check(dname, shape, ddg, want_dd,
                            "double backward, no clamp"))
        dims = [d for d in range(len(shape)) if d != 1]
        want_db = want.float().sum(dims)
        tol_db = 1e-5 * want.float().abs().sum(dims).max().item()
        if not (db - want_db).abs().max().item() <= tol_db:
            fail(f"B1b {dname} {shape} no clamp: db off by "
                 f"{(db - want_db).abs().max().item():.3e}")
        errs[("bias_act_grad", dname)] = max(
            errs[("bias_act_grad", dname)], err)


def compare_stage1(gen, dname, dtype, errs):
    """Stage 1's new uses of the kernels against the plain versions: B1
    and B1b (dx, db, double backward) with no clamp at every shape of D's
    activations at 128², batch 8, bit for bit; and B2b's backward, which
    is B2 on a gradient, against the autograd of
    ``smooth_upsample_grad_plain`` at every shape of the stage-1 G's
    upsamples, with B2's tolerance. Returns the shapes checked."""
    shapes = stage1_shapes(BATCH)
    check_b1_no_clamp(gen, dname, dtype, shapes["d_b1"], errs)
    for shape in shapes["b2"]:
        n, c, h, w = shape
        x = torch.randn(shape, generator=gen, device="cuda").to(
            dtype).requires_grad_()
        g = torch.randn((n, c, 2 * h, 2 * w), generator=gen,
                        device="cuda").to(dtype).requires_grad_()
        gg = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        (dx,) = torch.autograd.grad(smooth_upsample(x), x, g,
                                    create_graph=True)
        before = smooth_upsample.launches
        (got,) = torch.autograd.grad(dx, g, gg)
        if smooth_upsample.launches != before + 1:
            fail(f"B2b's backward at {shape} did not launch B2 once")
        g2 = g.detach().requires_grad_()
        (want,) = torch.autograd.grad(smooth_upsample_grad_plain(g2), g2, gg)
        err = (got.float() - want.float()).abs().max().item()
        tol = (2e-6 if dname == "f32" else 2.0 ** -7) * \
            gg.float().abs().max().item()
        if not err <= tol:
            fail(f"B2b's backward (B2) {dname} {shape}: max err {err:.3e} > "
                 f"{tol:.3e}")
        errs[("smooth_upsample", dname)] = max(
            errs[("smooth_upsample", dname)], err)
    return shapes


def b1_launches(shape) -> int:
    return 1 if shape[2] == 4 else 2


def offset_view(shape, dtype, gen, scale: float = 1.0):
    """A contiguous tensor of ``shape`` at storage offset 1: its data
    pointer is not 16-byte aligned, and the kernels' checks take it."""
    flat = (torch.randn(math.prod(shape) + 1, generator=gen, device="cuda")
            * scale).to(dtype)
    return flat[1:].view(shape)


@contextlib.contextmanager
def b2_forced(staged, whole_pass: bool = False):
    """B2's launch plans with its staging forced on (``staged`` True:
    wherever the rows are 16-byte aligned) or off (False: tiles down to a
    quarter pass of rows, as the plan has them, or down to one whole pass
    with ``whole_pass``); None leaves the plan as it is."""
    old = resample._STAGE_MIN_BYTES, resample._UNSTAGED_SPLIT
    if staged is not None:
        resample._STAGE_MIN_BYTES = 0 if staged else 1 << 62
    if whole_pass:
        resample._UNSTAGED_SPLIT = 1
    resample._launch_args.cache_clear()
    try:
        yield
    finally:
        resample._STAGE_MIN_BYTES, resample._UNSTAGED_SPLIT = old
        resample._launch_args.cache_clear()


def b2_staged(x) -> bool:
    """Whether B2's plan stages ``x`` in shared memory."""
    return bool(resample._plan(tuple(x.shape), x.element_size(),
                               x.data_ptr() % 16, 0,
                               build.sm_count(x.device.index))["staged"])


def cuda_time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Device ms per call of ``fn``: CUDA events around ``reps`` calls
    that run back to back. The device first sleeps while the host queues
    them, so the host's time per call (Python, the wrapper, the launch)
    stays out of the reading; if the sleep ended before the host was done,
    it is doubled and the reading taken again."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 24
    while True:
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time or cycles >= 1 << 32:
            return start.elapsed_time(end) / reps
        cycles *= 2


def phase_build():
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def reset_launches():
    for f in (bias_act, bias_act_grad, smooth_upsample, smooth_upsample_grad):
        f.launches = 0


def read_launches():
    return {"bias_act": bias_act.launches,
            "bias_act_grad": bias_act_grad.launches,
            "smooth_upsample": smooth_upsample.launches,
            "smooth_upsample_grad": smooth_upsample_grad.launches}


def b1b_check(dname, shape, got, want, what):
    """B1b against its plain version, bit for bit."""
    bits = torch.int32 if dname == "f32" else torch.int16
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got.view(bits), want.view(bits)):
        fail(f"B1b {dname} {shape} {what}: not bit-equal to the plain "
             f"version, max err {err:.3e}")
    return err


def b2b_check(dname, shape, got, g):
    """B2b against its plain version: f32 sums the taps in another order;
    in bf16 the plain version rounds after each of its steps, the kernel
    once. |dx| <= 2.5^2 max|g| (the edge columns' weights sum to 2.5)."""
    want = smooth_upsample_grad_plain(g)
    err = (got.float() - want.float()).abs().max().item()
    scale = 6.25 * g.float().abs().max().item()
    tol = (1e-6 if dname == "f32" else 2.0 ** -6) * scale
    if not err <= tol:
        fail(f"B2b {dname} g {shape}: max err {err:.3e} > {tol:.3e}")
    return err


def compare_grads(gen, dname, dtype, b1_shapes, b2_shapes, errs):
    """B1b (dx, db and the double backward) and B2b through the autograd
    Functions against the plain versions at the path shapes; both wrappers
    also called straight at ragged shapes and with one operand a view at
    storage offset 1, which take their scalar paths. B1b and its plain
    version do the same f32 operations in the same order and round once:
    they must agree bit for bit."""
    for shape in b1_shapes:
        x = (torch.randn(shape, generator=gen, device="cuda") * 200
             ).to(dtype).requires_grad_()
        b = torch.randn(shape[1], generator=gen, device="cuda"
                        ).requires_grad_()
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g.requires_grad_()
        gg = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        y = bias_act(x, b, "lrelu", 1.0, 256.0)
        dx, db = torch.autograd.grad(y, (x, b), g, create_graph=True)
        (ddg,) = torch.autograd.grad(dx, g, gg)
        xd, bd = x.detach(), b.detach()
        want = bias_act_grad_plain(g.detach(), xd, bd, 0.2, SQRT2, 256.0)
        want_dd = bias_act_grad_plain(gg, xd, bd, 0.2, SQRT2, 256.0)
        want_db = want.float().sum((0, 2, 3))
        if not bool((want == 0).any()):
            fail(f"B1b {dname} {shape}: the clamp never saturated")
        err = max(b1b_check(dname, shape, dx, want, "dx"),
                  b1b_check(dname, shape, ddg, want_dd, "double backward"))
        err_db = (db - want_db).abs().max().item()
        tol_db = 1e-5 * want.float().abs().sum((0, 2, 3)).max().item()
        if not err_db <= tol_db:
            fail(f"B1b {dname} {shape}: db err {err_db:.3e} (tol "
                 f"{tol_db:.3e})")
        errs[("bias_act_grad", dname)] = max(
            errs[("bias_act_grad", dname)], err)
    largest = max(b1_shapes, key=math.prod)
    for shape, off in ([(s, None) for s in B1_RAGGED]
                       + [(largest, k) for k in ("x", "g")]):
        x = (offset_view(shape, dtype, gen, 200) if off == "x" else
             (torch.randn(shape, generator=gen, device="cuda")
              * 200).to(dtype))
        g = (offset_view(shape, dtype, gen) if off == "g" else
             torch.randn(shape, generator=gen, device="cuda").to(dtype))
        b = torch.randn(shape[1], generator=gen, device="cuda")
        want = bias_act_grad_plain(g, x, b, 0.2, SQRT2, 256.0)
        errs[("bias_act_grad", dname)] = max(
            errs[("bias_act_grad", dname)], b1b_check(
                dname, shape, bias_act_grad(g, x, b, 0.2, SQRT2, 256.0),
                want, f"dx, {off or 'no'} operand at offset 1"))
    for shape in b2_shapes:
        x = torch.randn(shape, generator=gen, device="cuda").to(
            dtype).requires_grad_()
        n, c, h, w = shape
        g = torch.randn((n, c, 2 * h, 2 * w), generator=gen,
                        device="cuda").to(dtype)
        (got,) = torch.autograd.grad(smooth_upsample(x), x, g)
        errs[("smooth_upsample_grad", dname)] = max(
            errs[("smooth_upsample_grad", dname)],
            b2b_check(dname, g.shape, got, g))
    # the gradients of B2's ragged outputs (H = 1 and W = 1 inputs among
    # them), and g of the largest path shape at storage offset 1
    g_shapes = [(n, c, 2 * h, 2 * w)
                for n, c, h, w in b2_shapes + B2_RAGGED]
    for shape, offset in ([(s, 0) for s in g_shapes[len(b2_shapes):]]
                          + [(max(g_shapes, key=math.prod), 1)]):
        g = (offset_view(shape, dtype, gen) if offset else
             torch.randn(shape, generator=gen, device="cuda").to(dtype))
        errs[("smooth_upsample_grad", dname)] = max(
            errs[("smooth_upsample_grad", dname)],
            b2b_check(dname, shape, smooth_upsample_grad(g), g))


def phase_compare(gen):
    """Kernel against plain version on the card; returns the largest
    absolute error of each kernel per dtype."""
    b1_shapes, b2_shapes = on_path_shapes()
    errs = {(k, d): 0.0 for k in KERNELS for d in DTYPES}
    for dname, dtype in DTYPES.items():
        compare_grads(gen, dname, dtype, b1_shapes, b2_shapes, errs)
        bits = torch.int32 if dname == "f32" else torch.int16
        for shape, offset in ([(s, 0) for s in b1_shapes + B1_RAGGED]
                              + [(max(b1_shapes, key=math.prod), 1)]):
            x = (offset_view(shape, dtype, gen, 200) if offset else
                 (torch.randn(shape, generator=gen, device="cuda")
                  * 200).to(dtype))
            b = torch.randn(shape[1], generator=gen, device="cuda")
            got = bias_act(x, b, "lrelu", 1.0, 256.0)
            # the same f32 operations in the same order, one rounding
            want = bias_act_plain(x.float(), b, "lrelu", 1.0,
                                  256.0).to(dtype)
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got.view(bits), want.view(bits)):
                fail(f"B1 {dname} {shape} offset {offset}: not bit-equal "
                     f"to the plain version, max err {err:.3e}")
            errs[("bias_act", dname)] = max(errs[("bias_act", dname)], err)
        # path shapes as the plan has them; ragged shapes and the offset
        # view with the staging forced on and off
        staged = 0
        for shape, offset, force in (
                [(s, 0, None) for s in b2_shapes]
                + [(s, 0, f) for s in B2_RAGGED for f in (True, False)]
                + [(max(b2_shapes, key=math.prod), 1, f)
                   for f in (True, False)]):
            x = (offset_view(shape, dtype, gen) if offset else
                 torch.randn(shape, generator=gen, device="cuda").to(dtype))
            with b2_forced(force):
                got = smooth_upsample(x).float()
                took = b2_staged(x)
            if force is not None and took != (
                    force and not offset and shape[3] * x.element_size()
                    % 16 == 0):
                fail(f"B2 {dname} {shape} offset {offset}: staging forced "
                     f"{force}, the plan staged {took}")
            staged += took
            want = smooth_upsample_plain(x).float()
            err = (got - want).abs()
            scale = x.float().abs().max().item()
            # f32: taps summed in another order; bf16: the plain version
            # rounds after each 1-D pass, the kernel once (2 ulps)
            tol = (2e-6 if dname == "f32" else 2.0 ** -7) * scale
            if not err.max().item() <= tol:
                fail(f"B2 {dname} {shape} offset {offset}: max err "
                     f"{err.max().item():.3e} > {tol:.3e}")
            errs[("smooth_upsample", dname)] = max(
                errs[("smooth_upsample", dname)], err.max().item())
        if staged < 3:
            fail(f"B2 {dname}: only {staged} checks went through the staging")
        s1 = compare_stage1(gen, dname, dtype, errs)
        rosinality = rosinality_shapes(BATCH)
        check_b1_no_clamp(gen, dname, dtype, rosinality, errs)
    torch.cuda.synchronize()
    log(f"phase 2: kernels agree with their plain versions at "
        f"{len(b1_shapes)} B1/B1b and {len(b2_shapes)} B2/B2b shapes (the "
        f"inversion and training paths' at batch {BATCH}) in f32 and "
        f"bf16, B1 and B1b bit for bit; B1/B1b and B2/B2b also at "
        f"{len(B1_RAGGED)} and {len(B2_RAGGED)} ragged shapes and at "
        f"storage offset 1 (B2 staged and not); stage 1: B1 and B1b "
        f"(dx, db, double backward) without clamp at D's {len(s1['d_b1'])} "
        f"activation shapes at 128² bit for bit, B2b's backward (B2) at "
        f"G's {len(s1['b2'])} upsample shapes; the rosinality G's B1/B1b "
        f"without clamp at its {len(rosinality)} shapes bit for bit; max "
        f"abs err " + ", ".join(
            f"{k}/{d}={v:.3e}" for (k, d), v in errs.items()))
    return errs


def make_inputs(batch: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((batch, INPUT_SIZE, INPUT_SIZE, 3), generator=g) * 2 - 1
    avg = torch.rand((INPUT_SIZE, INPUT_SIZE, 3), generator=g) * 2 - 1
    return x, avg


def phase_main_path(model):
    x, avg = make_inputs(BATCH)
    reset_launches()
    t0 = time.perf_counter()
    outs, lats = run_on_batch(model, x.cuda(), avg.cuda(), ITERS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    n_styles = model.n_styles
    if tuple(outs.shape) != (ITERS, BATCH, 256, 256, 3):
        fail(f"outputs shape {tuple(outs.shape)}")
    if tuple(lats.shape) != (ITERS, BATCH, n_styles, 512):
        fail(f"latents shape {tuple(lats.shape)}")
    if not (torch.isfinite(outs).all() and torch.isfinite(lats).all()):
        fail("non-finite outputs")
    want = {"bias_act": 13 * ITERS, "bias_act_grad": 0,
            "smooth_upsample": 12 * ITERS, "smooth_upsample_grad": 0}
    if launches != want:
        fail(f"launches {launches}, expected {want}")
    log(f"phase 3: PSp({OUTPUT_SIZE}) inversion, batch {BATCH}, {ITERS} "
        f"iterations in {dt:.2f} s (first call); launches {launches}")
    return outs, lats, launches


def phase_cpu_reference(model, outs, lats):
    cpu_model = copy.deepcopy(model).cpu()
    x, avg = make_inputs(BATCH)
    t0 = time.perf_counter()
    c_outs, c_lats = run_on_batch(cpu_model, x[:CPU_BATCH], avg, CPU_ITERS)
    dt = time.perf_counter() - t0
    for name, got, want in (("images", outs, c_outs),
                            ("latents", lats, c_lats)):
        got = got[:CPU_ITERS, :CPU_BATCH].float().cpu()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"phase 4: card vs CPU {name}: max abs err {err:.3e} "
            f"(scale {scale:.3e}, rel {err / scale:.3e}, tol "
            f"{CPU_REL_TOL:g})")
        if not err <= CPU_REL_TOL * scale:
            fail(f"card and CPU {name} differ by {err:.3e}")
    log(f"phase 4: CPU batch {CPU_BATCH}, {CPU_ITERS} iterations in "
        f"{dt:.1f} s")


def kernel_timings(gen):
    """Each kernel and its plain version at the largest shape the paths
    give it; the bound is bytes moved (each input read once, each output
    written once) over the HBM rate, or operations over the f32 rate."""
    b1_shapes, b2_shapes = on_path_shapes()
    b1_shape = max(b1_shapes, key=math.prod)
    b2_shape = max(b2_shapes, key=math.prod)
    n2, c2, h2, w2 = b2_shape
    b2_out = (n2, c2, 2 * h2, 2 * w2)
    rows = {}
    for dname, dtype in DTYPES.items():
        elem = torch.finfo(dtype).bits // 8
        x = torch.randn(b1_shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn(b1_shape, generator=gen, device="cuda").to(dtype)
        b = torch.randn(b1_shape[1], generator=gen, device="cuda")
        n = x.numel()
        rows[("bias_act", dname)] = dict(
            shape=b1_shape,
            ms=cuda_time_ms(lambda: bias_act(x, b, "lrelu", 1.0, 256.0)),
            plain_ms=cuda_time_ms(lambda: bias_act_plain(
                x, b, "lrelu", 1.0, 256.0)),
            bytes_ms=(2 * n * elem + 4 * b.numel()) / HBM_BYTES_PER_S * 1e3,
            ops_ms=B1_FLOPS_PER_ELEM * n / F32_FLOPS_PER_S * 1e3)
        rows[("bias_act_grad", dname)] = dict(
            shape=b1_shape,
            ms=cuda_time_ms(lambda: bias_act_grad(g, x, b, 0.2, SQRT2,
                                                  256.0)),
            plain_ms=cuda_time_ms(lambda: bias_act_grad_plain(
                g, x, b, 0.2, SQRT2, 256.0)),
            bytes_ms=(3 * n * elem + 4 * b.numel()) / HBM_BYTES_PER_S * 1e3,
            ops_ms=B1B_FLOPS_PER_ELEM * n / F32_FLOPS_PER_S * 1e3)
        x = torch.randn(b2_shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn(b2_out, generator=gen, device="cuda").to(dtype)
        n = x.numel()
        rows[("smooth_upsample", dname)] = dict(
            shape=b2_shape, ms=cuda_time_ms(lambda: smooth_upsample(x)),
            plain_ms=cuda_time_ms(lambda: smooth_upsample_plain(x)),
            bytes_ms=5 * n * elem / HBM_BYTES_PER_S * 1e3,
            ops_ms=B2_FLOPS_PER_INPUT * n / F32_FLOPS_PER_S * 1e3)
        rows[("smooth_upsample_grad", dname)] = dict(
            shape=b2_out, ms=cuda_time_ms(lambda: smooth_upsample_grad(g)),
            plain_ms=cuda_time_ms(lambda: smooth_upsample_grad_plain(g)),
            bytes_ms=5 * n * elem / HBM_BYTES_PER_S * 1e3,
            ops_ms=B2B_FLOPS_PER_INPUT * n / F32_FLOPS_PER_S * 1e3)
    for (k, d), r in rows.items():
        bound = max(r["bytes_ms"], r["ops_ms"])
        log(f"phase 5: {k} {d} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {bound:.4f} ms "
            f"({bound / r['ms']:.1%} of the bound)")
    return rows


def path_times(gen, batch: int, dtype) -> dict:
    """Each kernel at each shape one inversion iteration or train step
    gives it at ``batch``: ``{kernel: [{shape, launches, ms, bound_ms}]}``,
    launches per synthesis (B1, B2) or per train step's backward (B1b, B2b;
    B2b's shape is g's); the bound as in ``kernel_timings``."""
    elem = torch.finfo(dtype).bits // 8
    b1_shapes, b2_shapes = on_path_shapes(batch)
    out = {k: [] for k in KERNELS}

    def add(k, shape, launches, fn, bytes_, ops):
        out[k].append(dict(
            shape=list(shape), launches=launches, ms=cuda_time_ms(fn),
            bound_ms=max(bytes_ / HBM_BYTES_PER_S,
                         ops / F32_FLOPS_PER_S) * 1e3))

    for shape in b1_shapes:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        b = torch.randn(shape[1], generator=gen, device="cuda")
        n = x.numel()
        add("bias_act", shape, b1_launches(shape),
            lambda: bias_act(x, b, "lrelu", 1.0, 256.0),
            2 * n * elem + 4 * b.numel(), B1_FLOPS_PER_ELEM * n)
        add("bias_act_grad", shape, b1_launches(shape),
            lambda: bias_act_grad(g, x, b, 0.2, SQRT2, 256.0),
            3 * n * elem + 4 * b.numel(), B1B_FLOPS_PER_ELEM * n)
    for shape in b2_shapes:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        nb, c, h, w = shape
        g = torch.randn((nb, c, 2 * h, 2 * w), generator=gen,
                        device="cuda").to(dtype)
        n = x.numel()
        add("smooth_upsample", shape, 1, lambda: smooth_upsample(x),
            5 * n * elem, B2_FLOPS_PER_INPUT * n)
        add("smooth_upsample_grad", g.shape, 1,
            lambda: smooth_upsample_grad(g), 5 * n * elem,
            B2B_FLOPS_PER_INPUT * n)
    del x, g
    return out


def path_sums(times: dict) -> dict:
    """``{kernel: (path_ms, path_bound_ms)}``: each summed over one
    synthesis's (B1, B2) or one train step's backward's (B1b, B2b)
    launches."""
    return {k: (sum(r["launches"] * r["ms"] for r in rows),
                sum(r["launches"] * r["bound_ms"] for r in rows))
            for k, rows in times.items()}


def log_path_times(label: str, times: dict):
    for k, rows in times.items():
        for r in rows:
            log(f"{label}: {k} {tuple(r['shape'])} x{r['launches']}: "
                f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_ms'] / r['ms']:.1%})")
    for k, (ms, bound) in path_sums(times).items():
        log(f"{label}: {k} over one "
            f"{'train step' if k.endswith('_grad') else 'synthesis'}: "
            f"{ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.1%} of the "
            f"bound)")


def inversion_rate(model, batch: int, dtype) -> float:
    m = model if dtype == torch.float32 else copy.deepcopy(model).to(dtype)
    x, avg = make_inputs(batch, seed=1)
    x, avg = x.cuda().to(dtype), avg.cuda().to(dtype)
    outs, _ = run_on_batch(m, x, avg, ITERS)        # warm-up
    if not torch.isfinite(outs).all():
        fail(f"non-finite outputs at batch {batch} {dtype}")
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run_on_batch(m, x, avg, ITERS)
    torch.cuda.synchronize()
    return batch * reps / (time.perf_counter() - t0)


def profile_breakdown(label: str, fn, top: int = 12,
                      details: dict = None, kinds: dict = None) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of that call's wall time. Returns B1's and
    B2's device ms and launches in that call; ``details``, when given, is
    filled with the device and wall ms and the top kernels, and with
    ``kinds`` ({kind: name substrings}) each kind's share of the device
    time. Fails when the profiler records no device time: the launch
    checks and the numbers read from the profile would be missing."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                              # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: a user annotation such as the optimizer's
    # "Optimizer.step#Ranger.step" spans kernels that are counted already
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e for e in events if getattr(e, "is_user_annotation", False)
             or e.key.startswith("Optimizer.")]
    kern = [e for e in events if e not in spans]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if dev_ms <= 0:
        fail(f"{label}: the profiler recorded no device time")
    log(f"{label}: device busy {dev_ms:.1f} ms of {wall_ms:.1f} ms wall "
        f"({dev_ms / wall_ms:.1%})")
    tops = sorted(kern, key=lambda e: -e.self_device_time_total)[:top]
    for e in tops:
        t = e.self_device_time_total / 1e3
        log(f"  {t:9.2f} ms {t / dev_ms:6.1%} x{e.count:<5d} {e.key[:90]}")
    if details is not None:
        details.update(device_ms=dev_ms, wall_ms=wall_ms, top=[
            [e.key[:90], e.self_device_time_total / 1e3, e.count]
            for e in tops])
    if kinds:
        shares = {kind: sum(e.self_device_time_total for e in kern if any(
            sub.lower() in e.key.lower() for sub in subs)) / 1e3 / dev_ms
            for kind, subs in kinds.items()}
        log("  shares: " + ", ".join(f"{k} {v:.1%}"
                                     for k, v in shares.items()))
        details["shares"] = shares
    for e in spans:
        log(f"  annotated span {e.key}: {e.device_time_total / 1e3:.2f} ms "
            f"of device time inside it")
    totals = {}
    for k, name in PROFILE_NAMES.items():
        mine = [e for e in kern if name in e.key]
        totals[k] = (sum(e.self_device_time_total for e in mine) / 1e3,
                     sum(e.count for e in mine))
        log(f"  {k} ({name}): {totals[k][0]:.2f} ms over {totals[k][1]} "
            f"launches, {totals[k][0] / dev_ms:.1%} of device time")
    return totals


def make_coach(device: str, compute_dtype: str = "float32") -> Stage2Coach:
    """The stage-2 recipe at full width: PSp(256) at input 112, L2 1.0 +
    LPIPS-alex 0.8 (seeded random LPIPS weights: no pretrained ones are in
    the repository), Ranger lr 1e-4, one refinement iteration. The weights
    are drawn on the CPU from seed 0, so every device gets the same."""
    lpips = LPIPS("alex")
    init_weights(lpips, torch.Generator().manual_seed(99))
    cfg = Stage2Config(output_size=OUTPUT_SIZE, n_iters_per_batch=1,
                       l2_lambda=1.0, lpips_lambda=0.8, learning_rate=1e-4,
                       compute_dtype=compute_dtype)
    return Stage2Coach(cfg, lpips_fn=lpips.requires_grad_(False).eval().to(
        device), device=device, seed=0)


def ready_coach(make=make_coach):
    """``make`` (``make_coach``) on the card with its latent average (4096
    seeded z) and average image, as the training phases start."""
    coach = make("cuda")
    coach.estimate_latent_avg(torch.Generator(device="cuda").manual_seed(1),
                              n_latent=4096)
    return coach, coach.make_avg_image()


def train_profile(label: str, coach, avg) -> dict:
    """Phase 10: ``profile_breakdown`` of one bf16 batch-128 train step."""
    coach.cfg = dataclasses.replace(coach.cfg, compute_dtype="bfloat16")
    xt, yt = (t.cuda() for t in train_inputs(128, seed=8))
    noise = torch.Generator(device="cuda").manual_seed(9)
    return profile_breakdown(label,
                             lambda: coach.train_step(xt, yt, avg, noise))


def train_inputs(batch: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((batch, INPUT_SIZE, INPUT_SIZE, 3), generator=g) * 2
            - 1 for _ in range(2)]


def phase_train(coach, avg):
    """The training main path: TRAIN_STEPS steps at batch BATCH, f32."""
    x, y = (t.cuda() for t in train_inputs(BATCH, seed=3))
    noise = torch.Generator(device="cuda").manual_seed(4)
    before = {k: v.clone() for k, v in coach.model.state_dict().items()}
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        loss, logs, y_hat = coach.train_step(x, y, avg, noise)
        losses.append(loss.item())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training losses {losses}")
    if (tuple(y_hat.shape) != (BATCH, INPUT_SIZE, INPUT_SIZE, 3)
            or not torch.isfinite(y_hat).all()):
        fail(f"y_hat {tuple(y_hat.shape)} or not finite")
    after = coach.model.state_dict()
    dec = [k for k in before if k.startswith("decoder.")]
    changed = [k for k in dec if not torch.equal(before[k], after[k])]
    if changed:
        fail(f"the frozen decoder changed: {changed[:5]}")
    enc = [f"encoder.{k}" for k, _ in coach.model.encoder.named_parameters()]
    moved = [k for k in enc if not torch.equal(before[k], after[k])]
    # a few BatchNorm shifts have gradients that are zero by construction
    if len(moved) < 0.9 * len(enc):
        fail(f"only {len(moved)} of {len(enc)} encoder tensors moved")
    want = {"bias_act": 13 * TRAIN_STEPS, "bias_act_grad": 13 * TRAIN_STEPS,
            "smooth_upsample": 12 * TRAIN_STEPS,
            "smooth_upsample_grad": 12 * TRAIN_STEPS}
    if launches != want:
        fail(f"training launches {launches}, expected {want}")
    log(f"phase 7: Stage2Coach PSp({OUTPUT_SIZE}) f32, batch {BATCH}, "
        f"{TRAIN_STEPS} steps in {dt:.2f} s (first calls); losses "
        + ", ".join(f"{v:.5f}" for v in losses)
        + f"; decoder unchanged ({len(dec)} tensors), {len(moved)} of "
        f"{len(enc)} encoder tensors moved; launches {launches} "
        f"(13/13/12/12 per step)")
    return launches


def phase_train_cpu_reference(latent_avg, avg):
    """One first step of fresh coaches (seed 0: the same weights) on the
    card and on the CPU, same inputs; noise_strength is 0 at init, so the
    two devices' different random noise drops out."""
    card, cpu = make_coach("cuda"), make_coach("cpu")
    with torch.no_grad():
        card.model.latent_avg.copy_(latent_avg)
        cpu.model.latent_avg.copy_(latent_avg.cpu())
    x, y = train_inputs(CPU_TRAIN_BATCH, seed=5)
    before = cpu.model.state_dict()
    before = {k: v.clone() for k, v in before.items()}
    loss, _, _ = card.train_step(x.cuda(), y.cuda(), avg,
                                 torch.Generator(device="cuda"))
    t0 = time.perf_counter()
    c_loss, _, _ = cpu.train_step(x, y, avg.cpu(), torch.Generator())
    dt = time.perf_counter() - t0
    got = {k: v.detach().cpu() for k, v in card.model.state_dict().items()}
    want = cpu.model.state_dict()
    del card
    lrel = abs(loss.item() - c_loss.item()) / abs(c_loss.item())
    if not lrel <= CPU_REL_TOL:
        fail(f"train loss card {loss.item()} vs CPU {c_loss.item()}")
    r = compare_encoder_step(got, want, before, cpu.model, "phase 8")
    log(f"phase 8: first train step card vs CPU at batch "
        f"{CPU_TRAIN_BATCH}: loss {loss.item():.6f} vs {c_loss.item():.6f} "
        f"(rel {lrel:.2e}); worst encoder tensor {r['worst_tensor']} at "
        f"{r['worst_ratio']:.3f} of its tolerance; all encoder updates "
        f"together differ by {r['update_norm_rel']:.2e} in norm; BatchNorm "
        f"batch statistics rel err {r['bn_rel_err']:.2e}; CPU step "
        f"{dt:.1f} s")


def compare_encoder_step(got: dict, want: dict, before: dict, cpu_model,
                         label: str) -> dict:
    """One encoder step on the card (state_dict ``got``, on the CPU)
    against the CPU's (``want``) from the same ``before``: each encoder
    tensor's update within CPU_UPDATE_TOL of the CPU's largest, plus 1e-6
    of the largest update of any tensor and 4 f32 ulps; each BatchNorm
    layer's batch statistics, (running - (1 - m) * before) / m with
    momentum m = 0.1, the mean against the layer's spread and the var
    against its largest var, within CPU_REL_TOL."""
    params = [f"encoder.{k}" for k, _ in cpu_model.encoder.named_parameters()]
    gmax = max((want[k] - before[k]).abs().max().item() for k in params)
    floor = 1e-6 * gmax
    worst, worst_k, sq_diff, sq_u = 0.0, None, 0.0, 0.0
    for k in params:
        u_cpu, u_card = want[k] - before[k], got[k] - before[k]
        diff = (u_card - u_cpu).abs()
        tol = (CPU_UPDATE_TOL * u_cpu.abs().max().item() + floor
               + 4 * torch.finfo(torch.float32).eps * want[k].abs())
        ratio = (diff / tol).max().item()
        if ratio > worst:
            worst, worst_k = ratio, k
        sq_diff += diff.square().sum().item()
        sq_u += u_cpu.square().sum().item()
    if worst > 1.0:
        fail(f"{label}: encoder update {worst_k} differs by {worst:.2f}x the "
             f"tolerance")
    bn_err = 0.0
    for k in want:
        if not k.endswith("running_mean"):
            continue
        kv = k[:-len("mean")] + "var"
        m_cpu, m_card, v_cpu, v_card = (
            (d[n] - 0.9 * before[n]) / 0.1
            for d, n in ((want, k), (got, k), (want, kv), (got, kv)))
        vmax = v_cpu.abs().max().item()
        err = max((m_card - m_cpu).abs().max().item() / math.sqrt(vmax),
                  (v_card - v_cpu).abs().max().item() / vmax)
        if err > CPU_REL_TOL:
            fail(f"{label}: BatchNorm {k[:-len('.running_mean')]}: card vs "
                 f"CPU batch statistics differ by {err:.3e} of the layer's "
                 f"scale")
        bn_err = max(bn_err, err)
    return {"worst_ratio": worst, "worst_tensor": worst_k,
            "update_norm_rel": math.sqrt(sq_diff / sq_u),
            "bn_rel_err": bn_err}


def train_rate(coach, avg, batch: int, compute_dtype: str) -> dict:
    coach.cfg = dataclasses.replace(coach.cfg, compute_dtype=compute_dtype)
    x, y = (t.cuda() for t in train_inputs(batch, seed=6))
    noise = torch.Generator(device="cuda").manual_seed(7)
    coach.train_step(x, y, avg, noise)                # warm-up
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        loss, _, _ = coach.train_step(x, y, avg, noise)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not math.isfinite(loss.item()):
        fail(f"non-finite loss at {compute_dtype} batch {batch}")
    return {"images_per_s": batch * reps / dt, "step_ms": dt / reps * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


# -- stage 3 -----------------------------------------------------------------

def stage3_trainer(device: str, compute_dtype: str = "float32",
                   dropout: bool = True, augment: bool = True,
                   backbone: str = "pSp", remat: bool = False
                   ) -> Stage3Trainer:
    """The stage-3 recipe of ``STAGE3_CONFIG`` at full width over
    ``S3_CLASSES`` classes, with the backbone the stage-3 CLI builds for
    ``backbone`` (the recipe's ``pSp``: ``PSpFaceRec`` IR-SE-50 with its
    block dropout), weights drawn from seed 0 (on the CPU, so every
    device gets the same). ``dropout=False`` sets every dropout to p = 0;
    ``augment`` crops 112 px out of larger inputs and flips them."""
    opts = dataclasses.replace(load_config(Stage3Options, STAGE3_CONFIG),
                               backbone=backbone)
    backbone = train_stage3.build_backbone(opts)
    cfg = Stage3Config(
        emb_size=opts.emb_size, num_classes=S3_CLASSES, head=opts.head,
        loss=opts.loss, arcface_s=opts.arcface_s, margin=opts.margin,
        lr=opts.lr, momentum=opts.momentum, weight_decay=opts.weight_decay,
        batch_size=opts.batch_size, num_epochs=opts.num_epochs,
        stages=tuple(opts.stages),
        freeze_backbone_epochs=opts.freeze_backbone_epochs,
        compute_dtype=compute_dtype, remat=remat,
        augment_crop=opts.input_size[0] if augment else None)
    trainer = Stage3Trainer(backbone, cfg, steps_per_epoch=1000,
                            device=device, seed=0)
    if not dropout:
        for m in backbone.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return trainer


def stage3_inputs(batch: int, seed: int, size: int = 128):
    """uint8 NHWC images and labels, drawn on the CPU."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (batch, size, size, 3), generator=g,
                      dtype=torch.uint8)
    return x, torch.randint(0, S3_CLASSES, (batch,), generator=g)


def _params(module, prefix):
    return {k: v.detach().clone() for k, v in module.named_parameters()
            if k.startswith(prefix)}


def phase_stage3_train(coach, avg):
    """Phase 11: the stage-2 -> stage-3 handoff and the stage-3 main path,
    2 frozen and 2 unfrozen steps at f32 batch S3_BATCH."""
    trainer = stage3_trainer("cuda")
    bb = trainer.backbone
    load_stage2_encoder(bb, coach.model.state_dict())
    with torch.no_grad():
        bb.avg_image.copy_(avg.permute(2, 0, 1))
    # the verification phase's model: the backbone as handed over (steps on
    # random labels draw the embeddings of different images together)
    handed = PSpFaceRec(size=bb.size, emb_size=trainer.cfg.emb_size).cuda()
    handed.load_state_dict(bb.state_dict())
    body0 = _params(bb, "encoder.body.")
    s2 = {k: v for k, v in coach.model.encoder.body.named_parameters()}
    if any(not torch.equal(v, s2[k[len("encoder.body."):]])
           for k, v in body0.items()):
        fail("the stage-2 body did not reach the stage-3 backbone")
    start = {k: v.detach().clone() for k, v in bb.state_dict().items()}
    head0 = trainer.head_weight.detach().clone()
    # the host data path: packed uint8 shards, the loader's producer
    # thread, pinned batches copied on a side stream
    x, y = stage3_inputs(S3_BATCH * S3_STEPS, seed=20)
    with tempfile.TemporaryDirectory() as shards:
        write_packed(shards, x.numpy(), y.numpy(),
                     [str(i) for i in range(S3_CLASSES)], shard_size=16)
        ds = PackedTrainDataset(shards)
        want_labels = [yb.tolist() for _, yb in PackedLoader(ds, S3_BATCH)]
        loader = PackedLoader(ds, S3_BATCH)
        reset_launches()
        t0 = time.perf_counter()
        losses, labels = [], []
        for i, (xb, yb) in enumerate(device_prefetch(iter(loader))):
            if xb.device.type != trainer.device.type or \
                    xb.dtype != torch.uint8:
                fail(f"prefetched batch on {xb.device} as {xb.dtype}")
            frozen = i < S3_STEPS // 2
            m = trainer.train_step(xb, yb, i, trainer.freeze_mask(frozen))
            losses.append(m["loss"].item())
            labels.append(yb.tolist())
            if i == S3_STEPS // 2 - 1:
                after_frozen = _params(bb, "encoder.body.")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = read_launches()
    if labels != want_labels or len(labels) != S3_STEPS:
        fail(f"the prefetched batches are not the loader's: {labels}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite stage-3 losses {losses}")
    changed = [k for k in body0 if not torch.equal(body0[k],
                                                   after_frozen[k])]
    if changed:
        fail(f"the frozen body changed: {changed[:5]}")
    end = bb.state_dict()
    for part in ("encoder.input_layer.", "encoder.output_layer.",
                 "encoder.body."):
        keys = [k for k, _ in bb.named_parameters() if k.startswith(part)]
        moved = [k for k in keys if not torch.equal(start[k], end[k])]
        # BatchNorm shifts right before a train-mode BatchNorm have
        # gradients that are zero by construction
        if len(moved) < 0.9 * len(keys):
            fail(f"only {len(moved)} of {len(keys)} {part} tensors moved")
    if torch.equal(head0, trainer.head_weight):
        fail("the head did not move")
    stats = [k for k in end if k.endswith("running_mean")]
    still = [k for k in stats if torch.equal(start[k], end[k])]
    if still:
        fail(f"BatchNorm statistics did not move: {still[:5]}")
    if any(launches.values()):
        fail(f"the stage-3 train step launched {launches}")
    log(f"phase 11: stage-3 PSpFaceRec IR-SE-50, ArcFace over {S3_CLASSES} "
        f"classes, f32 batch {S3_BATCH}, {S3_STEPS // 2} frozen + "
        f"{S3_STEPS - S3_STEPS // 2} unfrozen steps from packed shards "
        f"through the pinned prefetch in {dt:.2f} s (first calls); losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; body unchanged over the frozen steps ({len(body0)} tensors), "
        f"{len(stats)} BatchNorm statistics moved; launches {launches}")
    return trainer, handed, launches


def phase_stage3_cpu_reference(avg):
    """Phase 12: one first unfrozen step of fresh trainers (seed 0: the
    same weights) on the card and on the CPU, same uint8 inputs, dropout
    off, no crop."""
    card = stage3_trainer("cuda", dropout=False, augment=False)
    cpu = stage3_trainer("cpu", dropout=False, augment=False)
    for t in (card, cpu):
        with torch.no_grad():
            t.backbone.avg_image.copy_(avg.permute(2, 0, 1))
    x, y = stage3_inputs(S3_CPU_BATCH, seed=21, size=112)
    before = {k: v.clone() for k, v in cpu.backbone.state_dict().items()}
    head0 = cpu.head_weight.detach().clone()
    loss = card.train_step(x.cuda(), y.cuda(), 0)["loss"].item()
    t0 = time.perf_counter()
    c_loss = cpu.train_step(x, y, 0)["loss"].item()
    dt = time.perf_counter() - t0
    got = {k: v.cpu() for k, v in card.backbone.state_dict().items()}
    got["head.weight"] = card.head_weight.detach().cpu()
    want = dict(cpu.backbone.state_dict())
    want["head.weight"] = cpu.head_weight.detach()
    before["head.weight"] = head0
    del card
    lrel = abs(loss - c_loss) / abs(c_loss)
    if not lrel <= CPU_REL_TOL:
        fail(f"stage-3 loss card {loss} vs CPU {c_loss}")
    params = [k for k, _ in cpu.backbone.named_parameters()] + ["head.weight"]
    gmax = max((want[k] - before[k]).abs().max().item() for k in params)
    worst, worst_k = 0.0, None
    for k in params:
        u_cpu, u_card = want[k] - before[k], got[k] - before[k]
        tol = (CPU_UPDATE_TOL * u_cpu.abs().max().item() + 1e-6 * gmax
               + 4 * torch.finfo(torch.float32).eps * want[k].abs())
        ratio = ((u_card - u_cpu).abs() / tol).max().item()
        if ratio > worst:
            worst, worst_k = ratio, k
    if worst > 1.0:
        fail(f"stage-3 update {worst_k} differs by {worst:.2f}x the "
             f"tolerance")
    # running statistics: a mean against its layer's spread, a var against
    # its layer's largest var
    bn_err = 0.0
    for k in want:
        if not k.endswith("running_mean"):
            continue
        kv = k[:-len("mean")] + "var"
        vmax = want[kv].abs().max().item()
        err = max((got[k] - want[k]).abs().max().item() / math.sqrt(vmax),
                  (got[kv] - want[kv]).abs().max().item() / vmax)
        if err > 1e-4:
            fail(f"stage-3 BatchNorm {k}: card vs CPU {err:.3e} of scale")
        bn_err = max(bn_err, err)
    log(f"phase 12: first stage-3 step card vs CPU at batch {S3_CPU_BATCH}: "
        f"loss {loss:.6f} vs {c_loss:.6f} (rel {lrel:.2e}); worst tensor "
        f"{worst_k} at {worst:.3f} of its tolerance; BatchNorm running "
        f"statistics {bn_err:.2e} of scale; CPU step {dt:.1f} s")
    return {"loss_rel": lrel, "worst_update_ratio": worst,
            "worst_update_tensor": worst_k, "bn_rel": bn_err}


def stage3_rate(trainer, batch: int, compute_dtype: str) -> dict:
    trainer.cfg = dataclasses.replace(trainer.cfg, compute_dtype=compute_dtype)
    x, y = (t.cuda() for t in stage3_inputs(batch, seed=22))
    trainer.train_step(x, y, 0)                         # warm-up
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        m = trainer.train_step(x, y, i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not math.isfinite(m["loss"].item()):
        fail(f"non-finite stage-3 loss at {compute_dtype} batch {batch}")
    return {"images_per_s": batch * reps / dt, "step_ms": dt / reps * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_stage3_rates(trainer) -> dict:
    """Phase 13: train images/s, the step's model FLOPs and MFU, and a
    profile of one bf16 batch-256 step."""
    from torch.utils.flop_counter import FlopCounterMode
    rates = {}
    for dname, cdt, tf32, batch in S3_RATES:
        torch.backends.cudnn.allow_tf32 = tf32
        r = stage3_rate(trainer, batch, cdt)
        rates[f"{dname}_batch{batch}"] = r
        log(f"phase 13: stage-3 train step {dname} batch {batch}: "
            f"{r['images_per_s']:.1f} images/s, {r['step_ms']:.1f} ms/step, "
            f"peak {r['peak_gib']:.1f} GiB")
        torch.backends.cudnn.allow_tf32 = False
    b = S3_PROFILE_BATCH
    trainer.cfg = dataclasses.replace(trainer.cfg, compute_dtype="bfloat16")
    x, y = (t.cuda() for t in stage3_inputs(b, seed=23))
    with FlopCounterMode(display=False) as fc:
        trainer.train_step(x, y, 0)
    flops = fc.get_total_flops()
    step_s = rates[f"bf16_batch{b}"]["step_ms"] / 1e3
    mfu = flops / step_s / BF16_FLOPS_PER_S
    log(f"phase 13: stage3_train_mfu {mfu:.4f} ({flops / 1e12:.3f} TFLOP a "
        f"bf16 batch-{b} step, {flops / b / 3e9:.2f} GFLOP an image "
        f"forward if backward is twice the forward, over "
        f"{step_s * 1e3:.1f} ms against {BF16_FLOPS_PER_S / 1e12:.0f} "
        f"TFLOP/s)")
    details = {}
    totals = profile_breakdown(
        f"phase 13: profile of a bf16 batch-{b} stage-3 train step",
        lambda: trainer.train_step(x, y, 0), details=details)
    if any(n for _, n in totals.values()):
        fail(f"the stage-3 train step launched B kernels: {totals}")
    if not any("bf16" in k or "bfloat16" in k
                           for k, _, _ in details["top"]):
        fail("no bf16 kernel among the top kernels of the bf16 profile")
    return {"train": rates, "step_flops": flops, "stage3_train_mfu": mfu,
            f"profile_bf16_batch{b}": details}


def verification_pairs(n_pairs: int, seed: int = 24):
    """(images (2 n, 112, 112, 3) float32 in [-1, 1], issame (n,)): every
    other pair, in a seeded order, is one image twice; the other pairs are
    two different images. Each image is a smooth random field (a 7 x 7
    grid, bilinearly upsampled) plus uniform noise of 0.1."""
    g = torch.Generator().manual_seed(seed)
    issame = (torch.randperm(n_pairs, generator=g) % 2 == 0).numpy()
    n_same = int(issame.sum())
    n_unique = n_same + 2 * (n_pairs - n_same)
    unique = torch.nn.functional.interpolate(
        torch.rand((n_unique, 3, 7, 7), generator=g), size=(112, 112),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    unique = (unique * 2 - 1 + 0.1 * (torch.rand(unique.shape, generator=g)
                                      * 2 - 1)).clamp(-1, 1)
    first = np.empty(n_pairs, np.int64)
    second = np.empty(n_pairs, np.int64)
    first[issame] = np.arange(n_same)
    second[issame] = first[issame]
    diff = np.arange(n_same, n_unique).reshape(-1, 2)
    first[~issame], second[~issame] = diff[:, 0], diff[:, 1]
    order = np.stack([first, second], axis=1).reshape(-1)
    return np.ascontiguousarray(unique.numpy()[order]), issame


def phase_verify(backbone) -> dict:
    """Phase 14: perform_val on VERIFY_PAIRS synthetic pairs in f32 and
    bf16 with ``backbone`` (a PSpFaceRec), the embeddings checked, the
    first 32 against the CPU."""
    images, issame = verification_pairs(VERIFY_PAIRS)
    n = len(images)
    out, embs = {}, {}
    reset_launches()
    for dname, cdt in (("f32", "float32"), ("bf16", "bfloat16")):
        fn = make_embed_fn(backbone, device="cuda", compute_dtype=cdt)
        compute_embeddings(fn, images[:VERIFY_BATCH], VERIFY_BATCH)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = compute_embeddings(fn, images, VERIFY_BATCH)
        embed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        acc, thr, _ = perform_val(backbone, images, issame,
                                  batch_size=VERIFY_BATCH, device="cuda",
                                  compute_dtype=cdt)
        val_s = time.perf_counter() - t0
        if not np.isfinite(emb).all():
            fail(f"non-finite {dname} embeddings")
        norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1).max())
        if norm_err > 1e-4:
            fail(f"{dname} embeddings are not unit-norm ({norm_err:.2e})")
        e_acc = float(evaluate(emb, issame)[2].mean())
        same_d = np.sum(np.square(emb[0::2] - emb[1::2]), axis=1)
        if acc < 0.99 or e_acc < 0.99:
            fail(f"{dname} verification accuracy {acc:.4f} ({e_acc:.4f} "
                 f"from the timed embeddings) below 0.99 on duplicate "
                 f"pairs; squared distances: same <= "
                 f"{same_d[issame].max():.3e}, different >= "
                 f"{same_d[~issame].min():.3e}, median "
                 f"{np.median(same_d[~issame]):.3e}")
        embs[dname] = emb
        out[dname] = {"accuracy": acc, "best_threshold": thr,
                      "embed_images_per_s": n / embed_s,
                      "perform_val_images_per_s": n / val_s,
                      "max_same_distance": float(same_d[issame].max()),
                      "min_diff_distance": float(same_d[~issame].min())}
        log(f"phase 14: {dname} perform_val over {VERIFY_PAIRS} pairs "
            f"({n} images): accuracy {acc:.4f}, best threshold {thr:.3f}; "
            f"squared distances same <= {out[dname]['max_same_distance']:.2e}"
            f", different >= {out[dname]['min_diff_distance']:.3f}; embed "
            f"{n / embed_s:.1f} images/s, perform_val {n / val_s:.1f} "
            f"images/s; unit-norm within {norm_err:.1e}")
    torch.cuda.synchronize()
    launches = read_launches()
    if any(launches.values()):
        fail(f"verification launched {launches}")
    cpu = PSpFaceRec(size=backbone.size)
    cpu.load_state_dict(backbone.state_dict())
    c_emb = compute_embeddings(make_embed_fn(cpu, device="cpu"), images[:32],
                               32)
    err = float(np.abs(embs["f32"][:32] - c_emb).max())
    scale = float(np.abs(c_emb).max())
    if not err <= CPU_REL_TOL * scale:
        fail(f"card and CPU embeddings differ by {err:.3e}")
    log(f"phase 14: card vs CPU embeddings of the first 32 images: max abs "
        f"err {err:.3e} (scale {scale:.3e}); launches {launches}")
    out["cpu_max_abs_err"] = err
    return out, launches


# -- stage 1 -----------------------------------------------------------------

def stage1_trainer(device: str, compute_dtype: str = "float32"
                   ) -> Stage1Trainer:
    """The recipe of ``STAGE1_CONFIG`` at full width (G at 128², z/w 512,
    8 mapping layers; D with channel multiplier 2), weights from seed 0
    drawn on the CPU, so every device gets the same."""
    cfg = dataclasses.replace(load_config(Stage1Config, STAGE1_CONFIG),
                              compute_dtype=compute_dtype)
    return Stage1Trainer(cfg, device=device, seed=0)


def stage1_reals(batch: int, seed: int, size: int = 128) -> torch.Tensor:
    """NHWC images in [-1, 1], drawn on the CPU."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((batch, size, size, 3), generator=g) * 2 - 1


def to_device(obj, device):
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_device(v, device) for v in obj]
    return obj.to(device)


def record_steps(trainer) -> list:
    """Wrap the trainer's ``d_step`` and ``g_step`` (on the instance) so each
    call appends (name, regularised, launches in the call, w_avg moved,
    pl_mean moved) to the returned list."""
    record = []
    for name in ("d_step", "g_step"):
        fn = getattr(trainer, name)

        def wrapped(*args, _fn=fn, _name=name):
            w_avg, pl_mean = (trainer.G.mapping.w_avg.clone(),
                              trainer.pl_mean.clone())
            before = read_launches()
            out = _fn(*args)
            after = read_launches()
            record.append((_name, bool(args[-1]),
                           tuple(after[k] - before[k] for k in KERNELS),
                           not torch.equal(w_avg, trainer.G.mapping.w_avg),
                           not torch.equal(pl_mean, trainer.pl_mean)))
            return out
        setattr(trainer, name, wrapped)
    return record


def check_step_record(record, label: str):
    for name, reg, launches, w_moved, pl_moved in record:
        if launches != S1_LAUNCHES[(name, reg)]:
            fail(f"{label}: {name} (regularised {reg}) launched B1/B1b/B2/"
                 f"B2b {launches}, expected {S1_LAUNCHES[(name, reg)]}")
        if w_moved != (name == "g_step"):
            fail(f"{label}: w_avg moved {w_moved} in a {name}")
        if pl_moved != (name == "g_step" and reg):
            fail(f"{label}: pl_mean moved {pl_moved} in a {name} "
                 f"(path length {reg})")


def moved_share(before: dict, module) -> float:
    after = dict(module.named_parameters())
    return sum(not torch.equal(v, after[k]) for k, v in before.items()) \
        / len(before)


def ada_groups_fired(prm) -> list:
    """The ADA groups with at least one image augmented in ``prm``."""
    b, c = prm["blit"], prm["corrupt"]
    fired = {"blit": bool((b["flip"] | (b["rotk"] != 0) | (b["ty"] != 0)
                           | (b["tx"] != 0)).any()),
             "geom": bool(prm["geom"]["active"].any()),
             "color": bool(prm["color"]["active"].any()),
             "filter": bool(prm["filter"]["active"].any()),
             "corrupt": bool((c["do_noise"] | c["cut"]).any())}
    return [k for k, v in fired.items() if v]


def phase_stage1_train():
    """Phase 15: the stage-1 main path, steps 0-4 of the recipe at f32
    batch 8 through ``train_step``; then one step at ada_p 0.5."""
    tr = stage1_trainer("cuda")
    batch = tr.cfg.batch_size
    reals = stage1_reals(batch, seed=30).cuda()
    g0, d0, e0 = ({k: v.detach().clone() for k, v in m.named_parameters()}
                  for m in (tr.G, tr.D, tr.g_ema))
    record = record_steps(tr)
    reset_launches()
    t0 = time.perf_counter()
    logs = [tr.train_step(reals) for _ in range(S1_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    logs = [{k: v.item() for k, v in lg.items()} for lg in logs]
    if not all(math.isfinite(v) for lg in logs for v in lg.values()):
        fail(f"non-finite stage-1 logs {logs}")
    check_step_record(record, "phase 15")
    kinds = [(r[0], r[1]) for r in record]
    want_kinds = [("d_step", True), ("g_step", True)] + [
        ("d_step", False), ("g_step", False)] * 3 + [("d_step", False),
                                                     ("g_step", True)]
    if kinds != want_kinds:
        fail(f"phase 15: step types {kinds}, expected {want_kinds}")
    shares = {n: moved_share(b, m) for n, b, m in (
        ("G", g0, tr.G), ("D", d0, tr.D), ("g_ema", e0, tr.g_ema))}
    if min(shares.values()) < 0.9:
        fail(f"phase 15: too few tensors moved {shares}")
    if tr.rt_count.item() != 0 or tr.step != S1_STEPS:
        fail(f"phase 15: the ADA tick at step 4 did not reset r_t "
             f"({tr.rt_count.item()}) or the step is {tr.step}")
    if not torch.equal(tr.g_ema.mapping.w_avg, tr.G.mapping.w_avg):
        fail("phase 15: g_ema does not carry G's w_avg")
    # every augmentation group on the card: ada_p 0.5, one common step,
    # and the card's ADA on the reals against the CPU's
    tr.ada_p = torch.tensor(0.5, device=tr.device)
    d_draws, g_draws = tr.draw(batch, False)
    for label, prm in (("reals", d_draws["ada_real"]),
                       ("D fakes", d_draws["ada_fake"]),
                       ("G fakes", g_draws["ada_fake"])):
        fired = ada_groups_fired(prm)
        if len(fired) != 5:
            fail(f"phase 15: at ada_p 0.5 only {fired} fired on the {label}")
    aug = apply_ada(reals.permute(0, 3, 1, 2), d_draws["ada_real"]).cpu()
    want = apply_ada(reals.cpu().permute(0, 3, 1, 2),
                     to_device(d_draws["ada_real"], "cpu"))
    ada_err = (aug - want).abs().max().item()
    if not ada_err <= 1e-5 * want.abs().max().item():
        fail(f"phase 15: ADA card vs CPU differ by {ada_err:.3e}")
    n_rec = len(record)
    half = {**tr.d_step(reals, d_draws, False), **tr.g_step(g_draws, False)}
    check_step_record(record[n_rec:], "phase 15, ada_p 0.5")
    if not all(math.isfinite(v.item()) for v in half.values()):
        fail(f"phase 15: non-finite logs at ada_p 0.5 {half}")
    per_step = {f"{n}{'_reg' if r else ''}": dict(zip(KERNELS, la))
                for n, r, la, _, _ in record}
    log(f"phase 15: Stage1Trainer recipe (G 128², D 128² x2), f32 batch "
        f"{batch}, steps 0-{S1_STEPS - 1} in {dt:.2f} s (first calls): "
        + "; ".join(f"step {i} d_loss {lg['d_loss']:.4f} g_loss "
                    f"{lg['g_loss']:.4f} rt {lg['rt']:+.2f} plp "
                    f"{lg['plp']:.4f}" for i, lg in enumerate(logs))
        + f"; moved {shares}; launches {launches} (per step type "
        f"{per_step}); ada_p 0.5: all 5 groups fired, ADA card vs CPU "
        f"{ada_err:.2e}, d_loss {half['d_loss'].item():.4f} g_loss "
        f"{half['g_loss'].item():.4f}")
    return tr, launches, per_step, logs


def grad_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| over phase 8's tolerance: 0.1 of the tensor's largest
    plus 4 f32 ulps of each element."""
    tol = (CPU_UPDATE_TOL * want.abs().max()
           + 4 * torch.finfo(torch.float32).eps * want.abs())
    return ((got - want).abs() / tol.clamp_min(1e-30)).max().item()


def compare_params(card_mod, cpu_mod, label: str) -> dict:
    """Gradients of every parameter against phase 8's tolerance."""
    worst, worst_k, sq_d, sq = 0.0, None, 0.0, 0.0
    for (k, pc), pu in zip(card_mod.named_parameters(),
                           cpu_mod.parameters()):
        if pu.grad is None:
            if pc.grad is not None:
                fail(f"{label}: {k} has a gradient on the card only")
            continue
        got, want = pc.grad.detach().cpu(), pu.grad.detach()
        r = grad_ratio(got, want)
        if r > worst:
            worst, worst_k = r, k
        sq_d += (got - want).square().sum().item()
        sq += want.square().sum().item()
    if worst > 1.0:
        fail(f"{label}: gradient {worst_k} differs by {worst:.2f}x the "
             f"tolerance")
    return {"worst_grad_ratio": worst, "worst_grad_tensor": worst_k,
            "grad_norm_rel": math.sqrt(sq_d / sq)}


def compare_adam(card_mod, cpu_mod, card_opt, cpu_opt, lr, label) -> int:
    """The first Adam steps where the gradient is far above eps and
    round-off (|g| >= 1e-3 of the tensor's largest and >= 1e4 eps): there
    the update is -lr g / (|g| + eps) = -lr sign(g) (1 - eps / |g|) on both
    sides, within 1e-4 lr plus 4 ulps of the parameter, even where the two
    devices' g differ by their size. Returns the number of elements
    compared."""
    before = [p.detach().clone() for p in cpu_mod.parameters()]
    card_before = [p.detach().to("cpu", copy=True)
                   for p in card_mod.parameters()]
    card_opt.step()
    cpu_opt.step()
    return compare_adam_updates(card_mod, cpu_mod, card_before, before, lr,
                                label)


def compare_adam_updates(card_mod, cpu_mod, card_before, before, lr,
                         label) -> int:
    """``compare_adam``'s check of first Adam updates already taken from
    the parameters ``card_before`` (card) and ``before`` (CPU)."""
    n = 0
    for (k, pc), pu, b, cb in zip(card_mod.named_parameters(),
                                  cpu_mod.parameters(), before, card_before):
        if pu.grad is None:
            continue
        g = pu.grad.abs()
        mask = (g >= 1e-3 * g.max()) & (g >= 1e-4)
        du = ((pc.detach().cpu() - cb) - (pu.detach() - b)).abs()
        # p + u rounds once on each device: 4 f32 ulps of the parameter
        tol = 1e-4 * lr + 4 * torch.finfo(torch.float32).eps * b.abs()
        ratio = (du / tol)[mask]
        if ratio.numel() and ratio.max().item() > 1.0:
            fail(f"{label}: Adam update of {k} differs by "
                 f"{du[mask].max().item():.3e} (lr {lr})")
        n += int(mask.sum())
    return n


def phase_stage1_cpu_reference():
    """Phase 16: a first D step with R1 and a first G step with path
    length from the same weights and draws (ada_p 0.5) at batch
    S1_CPU_BATCH on the card and on the CPU's plain versions."""
    card, cpu = stage1_trainer("cuda"), stage1_trainer("cpu")
    for t in (card, cpu):
        t.ada_p = torch.tensor(0.5, device=t.device)
    reals = stage1_reals(S1_CPU_BATCH, seed=31)
    d_draws, g_draws = cpu.draw(S1_CPU_BATCH, True)
    out = {}
    t0 = time.perf_counter()
    for t, r, dd in ((card, reals.to(card.device),
                      to_device(d_draws, card.device)),
                     (cpu, reals, d_draws)):
        loss, rt = t.d_loss(r, dd, True)
        loss.backward()
        out.setdefault("d", []).append((loss.item(), rt.item()))
    (dlc, rc), (dlu, ru) = out["d"]
    if abs(dlc - dlu) > CPU_REL_TOL * abs(dlu) or rc != ru:
        fail(f"phase 16: D loss/rt card {dlc}/{rc} vs CPU {dlu}/{ru}")
    d_cmp = compare_params(card.D, cpu.D, "phase 16 D step")
    d_n = compare_adam(card.D, cpu.D, card.opt_d, cpu.opt_d, card.cfg.lr_d,
                       "phase 16 D step")
    for t, gd in ((card, to_device(g_draws, card.device)), (cpu, g_draws)):
        t.D.requires_grad_(False)
        loss, plp, pl_new = t.g_loss(gd, True)
        loss.backward()
        out.setdefault("g", []).append(
            (loss.item(), plp.item(), pl_new.item(),
             t.G.mapping.w_avg.detach().cpu()))
    (lc, pc, nc, wc), (lu, pu, nu, wu) = out["g"]
    for name, a, b in (("loss", lc, lu), ("plp", pc, pu),
                       ("pl_new", nc, nu)):
        if abs(a - b) > CPU_REL_TOL * abs(b):
            fail(f"phase 16: G {name} card {a} vs CPU {b}")
    w_err = (wc - wu).abs().max().item()
    if w_err > CPU_REL_TOL * wu.abs().max().item():
        fail(f"phase 16: w_avg card vs CPU {w_err:.3e}")
    g_cmp = compare_params(card.G, cpu.G, "phase 16 G step")
    g_n = compare_adam(card.G, cpu.G, card.opt_g, cpu.opt_g, card.cfg.lr_g,
                       "phase 16 G step")
    dt = time.perf_counter() - t0
    res = {"d_loss": out["d"], "g": [o[:3] for o in out["g"]],
           "w_avg_err": w_err, "d": d_cmp, "g_grads": g_cmp,
           "adam_elements": {"d": d_n, "g": g_n}}
    log(f"phase 16: first D step (R1) and G step (path length) card vs "
        f"CPU at batch {S1_CPU_BATCH}, ada_p 0.5: D loss {dlc:.6f} vs "
        f"{dlu:.6f}, rt {rc:+.2f}; G loss / plp / pl_new {lc:.6f} / "
        f"{pc:.6f} / {nc:.6f} vs {lu:.6f} / {pu:.6f} / {nu:.6f}; w_avg "
        f"{w_err:.2e}; "
        f"worst D gradient {d_cmp['worst_grad_tensor']} at "
        f"{d_cmp['worst_grad_ratio']:.3f} of its tolerance (norm "
        f"{d_cmp['grad_norm_rel']:.2e}), worst G gradient "
        f"{g_cmp['worst_grad_tensor']} at {g_cmp['worst_grad_ratio']:.3f} "
        f"(norm {g_cmp['grad_norm_rel']:.2e}); Adam updates agree on "
        f"{d_n} + {g_n} elements; {dt:.1f} s (CPU included)")
    return res


S1_KINDS = {"common": 1, "plp": 4, "r1_plp": 0}   # a step of each type


def stage1_rate(tr, reals, kind: str, reps: int) -> float:
    """ms per iteration (D step + G step) of step type ``kind``."""
    step = S1_KINDS[kind]
    tr.train_step(reals, step=step)                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        logs = tr.train_step(reals, step=step)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    if not all(math.isfinite(v.item()) for v in logs.values()):
        fail(f"non-finite stage-1 logs at {kind}: {logs}")
    return ms


def stage1_rates(tr, batch: int, compute_dtype: str, tf32: bool) -> dict:
    tr.cfg = dataclasses.replace(tr.cfg, compute_dtype=compute_dtype)
    torch.backends.cudnn.allow_tf32 = tf32
    reals = stage1_reals(batch, seed=32).cuda()
    ms = {k: stage1_rate(tr, reals, k, 3) for k in ("common", "plp")}
    torch.cuda.reset_peak_memory_stats()
    ms["r1_plp"] = stage1_rate(tr, reals, "r1_plp", 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.backends.cudnn.allow_tf32 = False
    # one R1 period: step 0 R1 + path length, every 4th path length
    n_plp = S1_CYCLE // tr.cfg.lazy_path_penalty_interval - 1
    cycle = (ms["r1_plp"] + n_plp * ms["plp"]
             + (S1_CYCLE - 1 - n_plp) * ms["common"]) / S1_CYCLE
    out = {f"{k}_ms": v for k, v in ms.items()}
    out.update({f"{k}_images_per_s": batch / v * 1e3 for k, v in ms.items()},
               cycle_ms=cycle, cycle_images_per_s=batch / cycle * 1e3,
               peak_gib=peak)
    return out


def stage1_path_times(gen, batch: int, dtype) -> dict:
    """Each kernel at each shape of one common stage-1 iteration at
    ``batch``, with its launches in that iteration: G forwards 2 (D step,
    G step), D forwards 3 (reals, fakes; fakes), D backwards 3, G
    backwards 1."""
    elem = torch.finfo(dtype).bits // 8
    sh = stage1_shapes(batch)
    out = {k: [] for k in KERNELS}

    def add(k, shape, launches, fn, bytes_, ops):
        out[k].append(dict(
            shape=list(shape), launches=launches, ms=cuda_time_ms(fn),
            bound_ms=max(bytes_ / HBM_BYTES_PER_S,
                         ops / F32_FLOPS_PER_S) * 1e3))

    for key, clamp, fwd, bwd in (("g_b1", 256.0, 2, 1),
                                 ("d_b1", None, 3, 3)):
        for shape, k in sh[key].items():
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            b = torch.randn(shape[1], generator=gen, device="cuda")
            n = x.numel()
            add("bias_act", shape, k * fwd,
                lambda: bias_act(x, b, "lrelu", 1.0, clamp),
                2 * n * elem + 4 * b.numel(), B1_FLOPS_PER_ELEM * n)
            add("bias_act_grad", shape, k * bwd,
                lambda: bias_act_grad(g, x, b, 0.2, SQRT2, clamp),
                3 * n * elem + 4 * b.numel(), B1B_FLOPS_PER_ELEM * n)
    for shape in sh["b2"]:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        nb, c, h, w = shape
        g = torch.randn((nb, c, 2 * h, 2 * w), generator=gen,
                        device="cuda").to(dtype)
        n = x.numel()
        add("smooth_upsample", shape, 2, lambda: smooth_upsample(x),
            5 * n * elem, B2_FLOPS_PER_INPUT * n)
        add("smooth_upsample_grad", g.shape, 1,
            lambda: smooth_upsample_grad(g), 5 * n * elem,
            B2B_FLOPS_PER_INPUT * n)
    return out


def phase_stage1_rates(tr, gen) -> dict:
    """Phases 17 and 18: iteration rates (bf16 batch 64, f32 batch 8 with
    TF32 off and on), peak memory, MFU of a common bf16 batch-64
    iteration, its profile and the kernels' path_ms over it."""
    from torch.utils.flop_counter import FlopCounterMode
    rates = {}
    for name, cdt, tf32, batch in (
            ("bf16", "bfloat16", False, S1_RATE_BATCH),
            ("f32", "float32", False, tr.cfg.batch_size),
            ("tf32", "float32", True, tr.cfg.batch_size)):
        r = stage1_rates(tr, batch, cdt, tf32)
        rates[f"{name}_batch{batch}"] = r
        log(f"phase 17: stage-1 {name} batch {batch}: common iteration "
            f"{r['common_ms']:.1f} ms ({r['common_images_per_s']:.1f} "
            f"images/s), path length {r['plp_ms']:.1f} ms, R1 + path "
            f"length {r['r1_plp_ms']:.1f} ms ({r['r1_plp_images_per_s']:.1f}"
            f" images/s), {S1_CYCLE}-step cycle {r['cycle_ms']:.1f} ms an "
            f"iteration ({r['cycle_images_per_s']:.1f} images/s); peak "
            f"{r['peak_gib']:.1f} GiB")
    b = S1_RATE_BATCH
    tr.cfg = dataclasses.replace(tr.cfg, compute_dtype="bfloat16")
    reals = stage1_reals(b, seed=33).cuda()
    with FlopCounterMode(display=False) as fc:
        tr.train_step(reals, step=S1_KINDS["common"])
    flops = fc.get_total_flops()
    it_s = rates[f"bf16_batch{b}"]["common_ms"] / 1e3
    mfu = flops / it_s / BF16_FLOPS_PER_S
    log(f"phase 17: stage1_train_mfu {mfu:.4f} ({flops / 1e12:.3f} TFLOP a "
        f"common bf16 batch-{b} iteration, {flops / b / 1e9:.1f} GFLOP an "
        f"image, over {it_s * 1e3:.1f} ms against "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s)")
    details = {}
    totals = profile_breakdown(
        f"phase 18: profile of a common bf16 batch-{b} stage-1 iteration",
        lambda: tr.train_step(reals, step=S1_KINDS["common"]), top=16,
        details=details)
    want = {k: S1_LAUNCHES[("d_step", False)][i]
            + S1_LAUNCHES[("g_step", False)][i]
            for i, k in enumerate(KERNELS)}
    if any(totals[k][1] != want[k] for k in KERNELS):
        fail(f"phase 18: profiled launches {totals}, expected {want}")
    reg_details = {}
    reg_totals = profile_breakdown(
        f"phase 18: profile of an R1 + path-length bf16 batch-{b} stage-1 "
        f"iteration", lambda: tr.train_step(reals, step=S1_KINDS["r1_plp"]),
        details=reg_details)
    want = {k: S1_LAUNCHES[("d_step", True)][i]
            + S1_LAUNCHES[("g_step", True)][i]
            for i, k in enumerate(KERNELS)}
    if any(reg_totals[k][1] != want[k] for k in KERNELS):
        fail(f"phase 18: profiled R1 + path-length launches {reg_totals}, "
             f"expected {want}")
    path = stage1_path_times(gen, b, torch.bfloat16)
    sums = path_sums(path)
    for k, (ms, bound) in sums.items():
        log(f"phase 18: {k} over one common bf16 batch-{b} iteration's "
            f"{sum(r['launches'] for r in path[k])} launches: {ms:.4f} ms, "
            f"bound {bound:.4f} ms ({bound / ms:.1%} of the bound)")
    return {"rates": rates, "iteration_flops": flops,
            "stage1_train_mfu": mfu, f"profile_bf16_batch{b}": details,
            f"profile_r1_plp_bf16_batch{b}": reg_details,
            "kernel_totals": totals, "kernel_totals_r1_plp": reg_totals,
            "path": {k: {"path_ms": v[0], "path_bound_ms": v[1]}
                     for k, v in sums.items()}}


# -- stage 2, e4e -------------------------------------------------------------

def make_e4e_coach(device: str, compute_dtype: str = "float32") -> E4eCoach:
    """``make_coach``'s recipe on ``E4e``, with bench.py's e4e knobs: the
    latent discriminator at lambda 0.1 (Adam 2e-5, R1 10 every 16 steps,
    pools of 50), delta regularisation 2e-4 and progressive stages at
    steps E4E_PROGRESSIVE. Weights from seed 0 (D from seed 1), on the
    CPU first, so every device gets the same."""
    lpips = LPIPS("alex")
    init_weights(lpips, torch.Generator().manual_seed(99))
    cfg = E4eConfig(output_size=OUTPUT_SIZE, n_iters_per_batch=1,
                    l2_lambda=1.0, lpips_lambda=0.8, learning_rate=1e-4,
                    compute_dtype=compute_dtype, w_discriminator_lambda=0.1,
                    delta_norm_lambda=2e-4,
                    progressive_steps=E4E_PROGRESSIVE, d_reg_every=16)
    return E4eCoach(cfg, lpips_fn=lpips.requires_grad_(False).eval().to(
        device), device=device, seed=0)


def e4e_iteration(coach, x, y, avg, noise, zgen, step: int):
    """One e4e iteration of the CLI: the encoder step, then the D step.
    Returns both losses."""
    loss, _, _ = coach.train_step(x, y, avg, noise)
    return loss, coach.train_discriminator(x, avg, step, zgen)


def phase_e4e_train(coach, avg):
    """Phase 19: E4E_STEPS iterations of the main path at batch BATCH,
    f32, the stage switching at each step."""
    x, y = (t.cuda() for t in train_inputs(BATCH, seed=40))
    noise = torch.Generator(device="cuda").manual_seed(41)
    zgen = torch.Generator(device="cuda").manual_seed(42)
    before = {k: v.clone() for k, v in coach.model.state_dict().items()}
    d_before = {k: v.clone() for k, v in
                coach.discriminator.state_dict().items()}
    t0 = time.perf_counter()
    rows, totals = [], dict.fromkeys(KERNELS, 0)
    for step in range(E4E_STEPS):
        coach.set_stage(coach.stage_for_step(step))
        bn = {k: v.clone() for k, v in coach.model.encoder.named_buffers()}
        w_avg = coach.model.decoder.mapping.w_avg.clone()
        reset_launches()
        loss, logs, _ = coach.train_step(x, y, avg, noise)
        enc = read_launches()
        kept = [k for k, v in coach.model.encoder.named_buffers()
                if k.endswith(("running_mean", "running_var"))
                and torch.equal(v, bn[k])]
        if kept:
            fail(f"phase 19: step {step}: the encoder step left BatchNorm "
                 f"statistics unmoved: {kept[:3]}")
        bn = {k: v.clone() for k, v in coach.model.encoder.named_buffers()}
        reset_launches()
        d_loss = coach.train_discriminator(x, avg, step, zgen)
        dl = read_launches()
        # the D step's encoder pass and real w's move no statistic
        for k, v in coach.model.encoder.named_buffers():
            if not torch.equal(v, bn[k]):
                fail(f"phase 19: step {step}: the D step moved {k}")
        if not torch.equal(coach.model.decoder.mapping.w_avg, w_avg):
            fail(f"phase 19: step {step}: w_avg moved")
        if enc != E4E_ENC_LAUNCHES or dl != E4E_D_LAUNCHES:
            fail(f"phase 19: step {step}: launches encoder {enc}, D {dl}; "
                 f"expected {E4E_ENC_LAUNCHES} and {E4E_D_LAUNCHES}")
        for k in KERNELS:
            totals[k] += enc[k] + dl[k]
        row = {k: v.item() for k, v in logs.items()}
        row.update(stage=coach.model.stage, d_loss=d_loss.item(),
                   r1=step % coach.cfg.d_reg_every == 0)
        rows.append(row)
        if not all(math.isfinite(v) for v in row.values()):
            fail(f"phase 19: step {step}: non-finite losses {row}")
        if (row["total_delta_loss"] == 0.0) != (row["stage"] == 0):
            fail(f"phase 19: step {step}: delta loss "
                 f"{row['total_delta_loss']} at stage {row['stage']}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = coach.model.state_dict()
    changed = [k for k in before if k.startswith("decoder.")
               and not torch.equal(before[k], after[k])]
    if changed:
        fail(f"phase 19: the frozen decoder changed: {changed[:5]}")
    # the heads of the stages reached train; the others take no gradient
    last = coach.model.stage
    enc = {f"encoder.{k}": k for k, _ in
           coach.model.encoder.named_parameters()}
    idle = [k for k, n in enc.items() if n.startswith("styles.")
            and int(n.split(".")[1]) > last]
    live = [k for k in enc if k not in idle]
    moved = [k for k in live if not torch.equal(before[k], after[k])]
    if len(moved) < 0.9 * len(live):
        fail(f"phase 19: only {len(moved)} of {len(live)} encoder tensors "
             f"moved")
    if any(not torch.equal(before[k], after[k]) for k in idle):
        fail("phase 19: a style head of an unreached stage moved")
    d_moved = [k for k, v in coach.discriminator.state_dict().items()
               if not torch.equal(v, d_before[k])]
    if len(d_moved) != len(d_before):
        fail(f"phase 19: D moved in {len(d_moved)} of {len(d_before)} "
             f"tensors")
    log(f"phase 19: E4eCoach E4e({OUTPUT_SIZE}) f32, batch {BATCH}, "
        f"{E4E_STEPS} iterations in {dt:.2f} s (first calls): "
        + "; ".join(f"stage {r['stage']} loss {r['loss']:.5f} adv "
                    f"{r['encoder_discriminator_loss']:.5f} delta "
                    f"{r['total_delta_loss']:.5f} D {r['d_loss']:.5f}"
                    + (" (R1)" if r["r1"] else "") for r in rows)
        + f"; decoder and w_avg unchanged, {len(moved)} of {len(live)} "
        f"live encoder tensors moved, {len(idle)} idle head tensors kept, D "
        f"moved; BatchNorm statistics kept by the D steps; launches per "
        f"encoder step {E4E_ENC_LAUNCHES}, per D step 0")
    return totals, rows


def phase_e4e_cpu_reference(latent_avg, avg):
    """Phase 20: a first encoder step (stage 1) and a first D step with R1
    of fresh e4e coaches (seed 0) on the card and on the CPU, same inputs
    and z; noise_strength is 0 at init. Phase 8's tolerances."""
    card, cpu = make_e4e_coach("cuda"), make_e4e_coach("cpu")
    for c, la in ((card, latent_avg), (cpu, latent_avg.cpu())):
        with torch.no_grad():
            c.model.latent_avg.copy_(la)
        c.set_stage(1)
    x, y = train_inputs(CPU_TRAIN_BATCH, seed=43)
    before = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    loss, logs, _ = card.train_step(x.cuda(), y.cuda(), avg,
                                    torch.Generator(device="cuda"))
    t0 = time.perf_counter()
    c_loss, c_logs, _ = cpu.train_step(x, y, avg.cpu(), torch.Generator())
    dt = time.perf_counter() - t0
    for k, v in c_logs.items():
        err = abs(logs[k].item() - v.item())
        if not err <= CPU_REL_TOL * abs(v.item()):
            fail(f"phase 20: {k} card {logs[k].item()} vs CPU {v.item()}")
    got = {k: v.detach().cpu() for k, v in card.model.state_dict().items()}
    r = compare_encoder_step(got, cpu.model.state_dict(), before, cpu.model,
                             "phase 20")
    z = torch.randn((CPU_TRAIN_BATCH, 512),
                    generator=torch.Generator().manual_seed(44))
    bufs = [{k: v.clone() for k, v in c.model.encoder.named_buffers()}
            for c in (card, cpu)]
    d_before = [[p.detach().to("cpu", copy=True)
                 for p in c.discriminator.parameters()] for c in (card, cpu)]
    d_loss = card.train_discriminator(x.cuda(), avg, 0, z=z.cuda())
    c_d_loss = cpu.train_discriminator(x, avg.cpu(), 0, z=z)
    drel = abs(d_loss.item() - c_d_loss.item()) / abs(c_d_loss.item())
    if not drel <= CPU_REL_TOL:
        fail(f"phase 20: D loss card {d_loss.item()} vs CPU "
             f"{c_d_loss.item()}")
    for c, b in zip((card, cpu), bufs):
        for k, v in c.model.encoder.named_buffers():
            if not torch.equal(v, b[k]):
                fail(f"phase 20: the D step moved {k} on {v.device}")
    gr = compare_params(card.discriminator, cpu.discriminator, "phase 20: D")
    n = compare_adam_updates(card.discriminator, cpu.discriminator,
                             d_before[0], d_before[1],
                             cpu.cfg.w_discriminator_lr, "phase 20: D")
    log(f"phase 20: first e4e step card vs CPU at batch {CPU_TRAIN_BATCH}, "
        f"stage 1: loss {loss.item():.6f} vs {c_loss.item():.6f}, adv "
        f"{logs['encoder_discriminator_loss'].item():.6f} vs "
        f"{c_logs['encoder_discriminator_loss'].item():.6f}, delta "
        f"{logs['total_delta_loss'].item():.6f} vs "
        f"{c_logs['total_delta_loss'].item():.6f}; worst encoder tensor "
        f"{r['worst_tensor']} at {r['worst_ratio']:.3f} of its tolerance, "
        f"updates {r['update_norm_rel']:.2e} apart in norm, BatchNorm batch "
        f"statistics rel err {r['bn_rel_err']:.2e}; D step with R1: loss "
        f"{d_loss.item():.6f} vs {c_d_loss.item():.6f} (rel {drel:.2e}), "
        f"worst D gradient {gr['worst_grad_tensor']} at "
        f"{gr['worst_grad_ratio']:.3f} of its tolerance "
        f"({gr['grad_norm_rel']:.2e} in norm), first Adam updates agree on "
        f"{n} elements, BatchNorm statistics kept on both; CPU encoder step "
        f"{dt:.1f} s")
    return {"loss": [loss.item(), c_loss.item()],
            "d_loss": [d_loss.item(), c_d_loss.item()], **r, **gr,
            "adam_elements": n}


def phase_e4e_bootstrap(model):
    """Phase 21: encoder bootstrapping at full width: the phase-19 e4e
    model (inference stage) makes the first inversion, a PSp(256) of seed
    0 the other ITERS - 1, at batch BATCH; then both on the CPU at batch
    CPU_BATCH over CPU_ITERS iterations."""
    m1 = copy.deepcopy(model).eval().set_stage(PROGRESSIVE_STAGE_INFERENCE)
    m2 = build_psp(OUTPUT_SIZE, INPUT_SIZE, seed=0, device="cuda")
    x, avg = make_inputs(BATCH, seed=45)
    reset_launches()
    t0 = time.perf_counter()
    outs, lats = encoder_bootstrap(m1, m2, x.cuda(), avg.cuda(), ITERS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    # a synthesis forward launches B1 and B2 as often as an encoder step
    want = {"bias_act": E4E_ENC_LAUNCHES["bias_act"] * ITERS,
            "bias_act_grad": 0,
            "smooth_upsample": E4E_ENC_LAUNCHES["smooth_upsample"] * ITERS,
            "smooth_upsample_grad": 0}
    if launches != want:
        fail(f"phase 21: launches {launches}, expected {want}")
    finite = torch.isfinite(outs).all() and torch.isfinite(lats).all()
    if (tuple(outs.shape) != (ITERS, BATCH, 256, 256, 3)
            or tuple(lats.shape) != (ITERS, BATCH, m1.n_styles, 512)
            or not finite):
        fail(f"phase 21: outputs {tuple(outs.shape)}, latents "
             f"{tuple(lats.shape)} or not finite")
    c1, c2 = copy.deepcopy(m1).cpu(), copy.deepcopy(m2).cpu()
    c_outs, c_lats = encoder_bootstrap(c1, c2, x[:CPU_BATCH], avg, CPU_ITERS)
    errs = {}
    for name, got, ref in (("images", outs, c_outs), ("latents", lats,
                                                      c_lats)):
        got = got[:CPU_ITERS, :CPU_BATCH].float().cpu()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= CPU_REL_TOL * scale:
            fail(f"phase 21: card and CPU {name} differ by {err:.3e} "
                 f"(scale {scale:.3e})")
        errs[name] = err / scale
    log(f"phase 21: encoder bootstrapping E4e -> PSp({OUTPUT_SIZE}), batch "
        f"{BATCH}, {ITERS} iterations in {dt:.2f} s (first call); launches "
        f"{launches}; card vs CPU at batch {CPU_BATCH}, {CPU_ITERS} "
        f"iterations: images rel {errs['images']:.2e}, latents rel "
        f"{errs['latents']:.2e} (tol {CPU_REL_TOL:g})")
    return launches, errs


def e4e_rate(coach, avg, batch: int, compute_dtype: str) -> dict:
    """ms and images/s of one e4e iteration (encoder step + D step without
    R1) and of its D step alone, at the inference stage; peak GiB."""
    coach.cfg = dataclasses.replace(coach.cfg, compute_dtype=compute_dtype)
    coach.set_stage(PROGRESSIVE_STAGE_INFERENCE)
    x, y = (t.cuda() for t in train_inputs(batch, seed=46))
    noise = torch.Generator(device="cuda").manual_seed(47)
    zgen = torch.Generator(device="cuda").manual_seed(48)
    e4e_iteration(coach, x, y, avg, noise, zgen, 1)        # warm-up
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        loss, d_loss = e4e_iteration(coach, x, y, avg, noise, zgen, 1)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    d_reps = 10
    t0 = time.perf_counter()
    for _ in range(d_reps):
        coach.train_discriminator(x, avg, 1, zgen)
    torch.cuda.synchronize()
    d_dt = (time.perf_counter() - t0) / d_reps
    if not (math.isfinite(loss.item()) and math.isfinite(d_loss.item())):
        fail(f"phase 22: non-finite losses at {compute_dtype} batch {batch}")
    # the D step's device time beside its wall time: where the device
    # idles, the host's launches set the D step's pace
    d_details = {}
    totals = profile_breakdown(
        f"phase 22: profile of a {compute_dtype} batch-{batch} D step",
        lambda: coach.train_discriminator(x, avg, 1, zgen), top=4,
        details=d_details)
    if any(totals[k][1] for k in KERNELS):
        fail(f"phase 22: the D step launched {totals}")
    return {"images_per_s": batch / dt, "iteration_ms": dt * 1e3,
            "d_step_ms": d_dt * 1e3,
            "d_step_device_ms": d_details["device_ms"],
            "peak_gib": peak}


def phase_e4e_rates(coach, avg) -> dict:
    """Phase 22: e4e iteration rates at bf16 batch 128 and f32 batch 32
    (TF32 off), and a profile of one bf16 batch-128 iteration."""
    rates = {}
    for name, cdt, batch in (("bf16", "bfloat16", E4E_RATE_BATCH),
                             ("f32", "float32", E4E_F32_RATE_BATCH)):
        r = e4e_rate(coach, avg, batch, cdt)
        rates[f"{name}_batch{batch}"] = r
        log(f"phase 22: e4e iteration {name} batch {batch}: "
            f"{r['iteration_ms']:.1f} ms ({r['images_per_s']:.1f} images/s), "
            f"of which the D step {r['d_step_ms']:.1f} ms "
            f"({r['d_step_device_ms']:.1f} ms of device time); peak "
            f"{r['peak_gib']:.1f} GiB")
    b = E4E_RATE_BATCH
    coach.cfg = dataclasses.replace(coach.cfg, compute_dtype="bfloat16")
    x, y = (t.cuda() for t in train_inputs(b, seed=49))
    noise = torch.Generator(device="cuda").manual_seed(50)
    zgen = torch.Generator(device="cuda").manual_seed(51)
    details = {}
    totals = profile_breakdown(
        f"phase 22: profile of a bf16 batch-{b} e4e iteration",
        lambda: e4e_iteration(coach, x, y, avg, noise, zgen, 1), top=16,
        details=details)
    if any(totals[k][1] != E4E_ENC_LAUNCHES[k] for k in KERNELS):
        fail(f"phase 22: profiled launches {totals}, expected "
             f"{E4E_ENC_LAUNCHES}")
    return {"rates": rates, f"profile_bf16_batch{b}": details,
            "kernel_totals": totals}


# the pSp encoder family: each encoder build_encoder names (n_styles of
# the 256 px generator) and the stage-3 encoder's "pSp" and "both" heads,
# at the input size its style heads are made for
ENCODER_INPUTS = (("GradualStyleEncoder", 256), ("BackboneEncoder", 112),
                  ("BackboneEncoder34", 112), ("BackboneEncoder100", 112),
                  ("ResNetBackboneEncoder", 256),
                  ("ProgressiveBackboneEncoder", 112), ("head pSp", 112),
                  ("head both", 112))


def seeded_batchnorm_(model, seed: int):
    """Every BatchNorm's weight, bias and running statistics drawn from
    ``seed`` (the ResNet blocks' last BatchNorm weight is 0 at init, and
    the default statistics are the identity)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return model


def phase_encoders() -> dict:
    """Phase 23: the pSp encoder family on the card in eval mode, each
    built on the card from seed 0 (``build_encoder``'s default device; the
    heads through ``BackboneEncoderDiffHead``) with seeded BatchNorm
    statistics, at batch BATCH: finite codes of the expected shape, no
    launch of B1/B1b/B2/B2b, and the first CPU_BATCH rows within
    CPU_REL_TOL of the same weights on the CPU."""
    n_styles = n_styles_for(OUTPUT_SIZE)
    out = {}
    for name, size in ENCODER_INPUTS:
        if name.startswith("head "):
            m = BackboneEncoderDiffHead(output_layer_type=name[5:],
                                        n_styles=n_styles)
            init_weights(m, torch.Generator().manual_seed(0))
            m = m.cuda()
        else:
            m = build_encoder(name, n_styles)
        if next(m.parameters()).device.type != "cuda":
            fail(f"phase 23: {name} was not built on the card")
        m = seeded_batchnorm_(m, seed=52).eval()
        x = torch.randn(BATCH, 6, size, size,
                        generator=torch.Generator().manual_seed(53))
        reset_launches()
        with torch.no_grad():
            got = m(x.cuda())
        torch.cuda.synchronize()
        launches = read_launches()
        with torch.no_grad():
            want = copy.deepcopy(m).cpu()(x[:CPU_BATCH])
        if not isinstance(got, dict):
            got, want = {"pSp": got}, {"pSp": want}
        errs = {}
        for k, g in got.items():
            shape = (BATCH, 512) if k == "facerec" else (BATCH, n_styles, 512)
            if tuple(g.shape) != shape or not torch.isfinite(g).all():
                fail(f"phase 23: {name} {k}: {tuple(g.shape)} (expected "
                     f"{shape}) or not finite")
            err = (g[:CPU_BATCH].cpu() - want[k]).abs().max().item()
            scale = want[k].abs().max().item()
            if not err <= CPU_REL_TOL * scale:
                fail(f"phase 23: {name} {k}: card and CPU differ by "
                     f"{err:.3e} (scale {scale:.3e})")
            errs[k] = err / scale
        if any(launches.values()):
            fail(f"phase 23: {name} launched {launches}")
        log(f"phase 23: {name} at {size} px, batch {BATCH}: card vs CPU "
            + ", ".join(f"{k} rel {v:.2e}" for k, v in errs.items())
            + f" (tol {CPU_REL_TOL:g}); no B1/B1b/B2/B2b launch")
        out[name] = errs
        del m
    return out


def seeded_generator_(model, seed: int):
    """Every bias outside the style and mapping layers, every noise weight
    and noise strength (zeros at init) moved by 0.1 N(0, 1) from ``seed``,
    so that their paths count."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (EqualLinear, FullyConnectedLayer)):
                continue
            for k, p in mod.named_parameters(recurse=False):
                if k in ("bias", "noise_strength") or isinstance(
                        mod, NoiseInjection):
                    p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model


def make_rosinality(device: str = "cuda"):
    """The rosinality G at 256² (style 512, 8 MLP layers, channel
    multiplier 2), weights from seed 0 drawn on the CPU."""
    g = GeneratorRosinality(ROSI_SIZE, ROSI_STYLE_DIM, ROSI_N_MLP, 2)
    init_weights(g, torch.Generator().manual_seed(0))
    return seeded_generator_(g, 1).to(device).eval()


def make_stylegan1(device: str = "cuda"):
    """The StyleGAN2-ADA G with the StyleGAN1 layer family at the pSp
    decoder's widths (z/w 512, 8 mapping layers, 256²), seed 0."""
    g = Generator(512, 512, 8, OUTPUT_SIZE, synthesis_layer="stylegan1")
    init_weights(g, torch.Generator().manual_seed(0))
    return seeded_generator_(g, 1).to(device).eval()


def check_image(label: str, img, shape):
    if tuple(img.shape) != shape or not torch.isfinite(img).all():
        fail(f"{label}: image {tuple(img.shape)} (expected {shape}) or not "
             f"finite")


def check_launches(label: str, got: dict, want: dict):
    if got != want:
        fail(f"{label}: launches {got}, expected {want}")


def forward_backward(label: str, model, run, inputs, want_fwd: dict,
                     want_bwd: dict) -> dict:
    """``run(model, inputs)`` and the backward of its mean image to every
    parameter, launches held per direction; every gradient finite."""
    model.zero_grad(set_to_none=True)
    reset_launches()
    img = run(model, inputs)
    torch.cuda.synchronize()
    fwd = read_launches()
    check_launches(f"{label} forward", fwd, want_fwd)
    reset_launches()
    img.float().mean().backward()
    torch.cuda.synchronize()
    bwd = read_launches()
    check_launches(f"{label} backward", bwd, want_bwd)
    for k, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            fail(f"{label}: gradient of {k} missing or not finite")
    model.zero_grad(set_to_none=True)
    return {k: fwd[k] + bwd[k] for k in KERNELS}


def card_vs_cpu(label: str, model, run, inputs,
                f64_on_miss: bool = False) -> dict:
    """``run`` at CPU_BATCH on the card, on a CPU copy of ``model`` and on
    a float64 CPU copy: the card's output within CPU_REL_TOL of the CPU's
    scale; after the backward of a seeded random weighting of the output
    (not the mean: behind the StyleGAN1 layers' instance norm its
    gradients are 0 by construction, round-off), every parameter's
    gradient on the card within phase 8's tolerance of the float64 run's,
    or no further from it than ROUNDOFF_FACTOR times the CPU's f32 run.
    A scalar noise weight's gradient is a sum of up to a million products
    that cancel to 1e-4 of their absolute sum, so f32 round-off alone can
    move it by 10 % on either device (PERF.md, PR 8). With
    ``f64_on_miss`` the float64 run is made only when a card gradient is
    past phase 8's tolerance of the CPU's f32 one."""
    cpu = copy.deepcopy(model).cpu()
    ref = copy.deepcopy(model).cpu().double()
    outs = {}
    t0 = time.perf_counter()
    runs = [(model, "cuda"), (cpu, "cpu"), (ref, "f64")]
    if f64_on_miss:
        for m, dev in runs[:2]:
            m.zero_grad(set_to_none=True)
            y = run(m, to_device(inputs, dev))
            wt = torch.randn(y.shape, generator=torch.Generator(
            ).manual_seed(77)).to(y.device, y.dtype)
            (y * wt).sum().backward()
            outs[dev] = y.detach().float().cpu()
        ratios = [grad_ratio(pc.grad.detach().cpu().double(),
                             pu.grad.double())
                  for pc, pu in zip(model.parameters(), cpu.parameters())
                  if pc.grad is not None and pu.grad is not None]
        if max(ratios) <= 1.0:
            err = (outs["cuda"] - outs["cpu"]).abs().max().item()
            scale = outs["cpu"].abs().max().item()
            if not err <= CPU_REL_TOL * scale:
                fail(f"{label}: card and CPU outputs differ by {err:.3e} "
                     f"(scale {scale:.3e})")
            model.zero_grad(set_to_none=True)
            return {"output_rel_err": err / scale,
                    "worst_grad_ratio_vs_cpu_f32": max(ratios),
                    "seconds": time.perf_counter() - t0}
        runs = runs[2:]
    for m, dev in runs:
        m.zero_grad(set_to_none=True)
        x = to_device(inputs, "cpu" if dev == "f64" else dev)
        if dev == "f64":
            x = [t.double() for t in x] if isinstance(x, list) else x.double()
        y = run(m, x)
        wt = torch.randn(y.shape, generator=torch.Generator().manual_seed(
            77)).to(y.device, y.dtype)
        (y * wt).sum().backward()
        outs[dev] = y.detach().float().cpu()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    if not err <= CPU_REL_TOL * scale:
        fail(f"{label}: card and CPU outputs differ by {err:.3e} (scale "
             f"{scale:.3e})")
    res = {"output_rel_err": err / scale, "worst_grad_ratio": 0.0,
           "cpu_f32_worst_grad_ratio": 0.0, "past_tolerance_as_cpu": []}
    for (k, pc), pu, pr in zip(model.named_parameters(), cpu.parameters(),
                               ref.parameters()):
        grads = [p.grad is None for p in (pc, pu, pr)]
        if all(grads):           # a parameter the forward does not use
            res["unused_parameters"] = res.get("unused_parameters", 0) + 1
            continue
        if any(grads):
            fail(f"{label}: gradient {k} missing on one device")
        rc = grad_ratio(pc.grad.detach().cpu().double(), pr.grad)
        ru = grad_ratio(pu.grad.double(), pr.grad)
        if rc > max(1.0, ROUNDOFF_FACTOR * ru):
            fail(f"{label}: gradient {k} is {rc:.2f}x phase 8's tolerance "
                 f"from the float64 run's (the CPU's f32 {ru:.2f}x)")
        if rc > 1.0:
            res["past_tolerance_as_cpu"].append([k, rc, ru])
        if rc > res["worst_grad_ratio"]:
            res.update(worst_grad_ratio=rc, worst_grad_tensor=k)
        if ru > res["cpu_f32_worst_grad_ratio"]:
            res.update(cpu_f32_worst_grad_ratio=ru,
                       cpu_f32_worst_grad_tensor=k)
    res["seconds"] = time.perf_counter() - t0
    model.zero_grad(set_to_none=True)
    return res


def bf16_vs_f32(label: str, run, inputs) -> float:
    """``run(inputs)`` under bf16 autocast against f32: finite, within
    BF16_REL_TOL of the f32 output's largest value."""
    with torch.no_grad():
        want = run(inputs).float()
        with torch.autocast("cuda", torch.bfloat16):
            got = run(inputs).float()
    if not torch.isfinite(got).all():
        fail(f"{label}: bf16 output not finite")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    if not rel <= BF16_REL_TOL:
        fail(f"{label}: bf16 differs from f32 by {rel:.3e} of scale")
    return rel


def no_grad_rate(run, inputs, batch: int, dname: str) -> dict:
    """Images/s of ``run(inputs)`` without gradients (bf16: autocast) on
    the host's clock over 3 calls, and its device ms."""
    def fn():
        with torch.no_grad(), torch.autocast(
                "cuda", torch.bfloat16, enabled=dname == "bf16"):
            return run(inputs)

    if not torch.isfinite(fn()).all():
        fail(f"non-finite output at {dname} batch {batch}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    return {"images_per_s": batch / ms * 1e3, "ms": ms,
            "device_ms": cuda_time_ms(fn, reps=3, warmup=1)}


def generator_rates(label: str, run, make_inputs_for) -> dict:
    """``no_grad_rate`` at GEN_RATES and a profile of the bf16 batch-128
    call: the four kernels' share of its device time."""
    out = {}
    for dname, batch in GEN_RATES:
        inputs = make_inputs_for(batch)
        r = no_grad_rate(run, inputs, batch, dname)
        out[f"{dname}_batch{batch}"] = r
        log(f"{label}: synthesis {dname} batch {batch}: "
            f"{r['images_per_s']:.1f} images/s, {r['ms']:.2f} ms "
            f"({r['device_ms']:.2f} ms device)")
        if dname == "bf16":
            details = {}

            def fn():
                with torch.no_grad(), torch.autocast("cuda",
                                                     torch.bfloat16):
                    return run(inputs)

            totals = profile_breakdown(
                f"{label}: profile of a bf16 batch-{batch} synthesis", fn,
                details=details)
            out["profile"] = {
                "device_ms": details["device_ms"],
                "wall_ms": details["wall_ms"],
                "kernels_ms": {k: v[0] for k, v in totals.items()},
                "kernel_launches": {k: v[1] for k, v in totals.items()},
                "kernels_share": sum(v[0] for v in totals.values())
                / details["device_ms"]}
        del inputs
    return out


def phase_rosinality() -> dict:
    """Phase 24: the rosinality G at full width on the card."""
    G = make_rosinality()
    zg = torch.Generator().manual_seed(60)
    z, z2 = (torch.randn((BATCH, ROSI_STYLE_DIM), generator=zg).cuda()
             for _ in range(2))
    shape = (BATCH, 3, ROSI_SIZE, ROSI_SIZE)
    from_w = dict(ROSI_LAUNCHES,
                  bias_act=ROSI_LAUNCHES["bias_act"] - ROSI_N_MLP)
    with torch.no_grad():
        reset_launches()
        check_image("phase 24 from z", G([z], randomize_noise=False), shape)
        check_launches("phase 24 from z", read_launches(), ROSI_LAUNCHES)
        w1, w2 = G.style_mlp(z), G.style_mlp(z2)
        reset_launches()
        img, lat = G([w1, w2], input_is_latent=True, inject_index=5,
                     randomize_noise=False, return_latents=True)
        check_image("phase 24 mixing", img, shape)
        check_launches("phase 24 mixing", read_launches(), from_w)
        if not (torch.equal(lat[:, :5], w1[:, None].expand(-1, 5, -1))
                and torch.equal(lat[:, 5:], w2[:, None].expand(
                    -1, G.n_latent - 5, -1))):
            fail("phase 24: inject_index 5 did not split the latents at 5")
        ml = G.mean_latent(4096, torch.Generator("cuda").manual_seed(61))
        reset_launches()
        img = G([z], truncation=0.7, truncation_latent=ml,
                randomize_noise=False)
        check_image("phase 24 truncation", img, shape)
        check_launches("phase 24 truncation", read_launches(),
                       ROSI_LAUNCHES)
        check_image("phase 24 random noise", G(
            [z, z2], generator=torch.Generator("cuda").manual_seed(62)),
            shape)
    launches = forward_backward(
        "phase 24 mean-image loss from z", G,
        lambda m, x: m([x], randomize_noise=False), z, ROSI_LAUNCHES,
        dict(ROSI_LAUNCHES, bias_act=0,
             bias_act_grad=ROSI_LAUNCHES["bias_act"]))
    cpu = card_vs_cpu(
        "phase 24 card vs CPU", G,
        lambda m, x: m(list(x), inject_index=5, randomize_noise=False),
        [z[:CPU_BATCH], z2[:CPU_BATCH]])
    synth = (lambda w: G([w], input_is_latent=True, randomize_noise=False))
    bf16 = bf16_vs_f32("phase 24 bf16", synth, w1)
    log(f"phase 24: rosinality G({ROSI_SIZE}) batch {BATCH}: from z, w "
        f"mixing at 5, truncation 0.7 toward mean_latent, random noise: "
        f"finite; launches from z {ROSI_LAUNCHES['bias_act']} B1, from w "
        f"{from_w['bias_act']}, no B2/B2b; forward + backward {launches}; "
        f"card vs CPU at "
        f"batch {CPU_BATCH}: image rel {cpu['output_rel_err']:.2e}, worst "
        f"gradient against float64 {cpu['worst_grad_tensor']} at "
        f"{cpu['worst_grad_ratio']:.3f} of its tolerance (the CPU's f32 "
        f"{cpu['cpu_f32_worst_grad_tensor']} at "
        f"{cpu['cpu_f32_worst_grad_ratio']:.3f}; past it on the card as on "
        f"the CPU: {cpu['past_tolerance_as_cpu']}); bf16 vs f32 {bf16:.2e} "
        f"of scale")
    del w1, w2, ml, img, lat

    def ws_for(batch):
        g = torch.Generator().manual_seed(63)
        with torch.no_grad():
            return G.style_mlp(torch.randn((batch, ROSI_STYLE_DIM),
                                           generator=g).cuda())

    rates = generator_rates("phase 24", synth, ws_for)
    del G
    return {"launches_fwd_bwd": launches, "cpu_vs_card": cpu,
            "bf16_vs_f32_rel": bf16, "rates": rates}


def phase_stylegan1() -> dict:
    """Phase 25: the StyleGAN1 ADA G at the pSp decoder's widths, and
    ``EqualizedConv2d`` up, down and none, on the card."""
    G = make_stylegan1()
    zg = torch.Generator().manual_seed(64)
    z = torch.randn((BATCH, 512), generator=zg).cuda()
    shape = (BATCH, 3, OUTPUT_SIZE, OUTPUT_SIZE)
    with torch.no_grad():
        check_image("phase 25 random noise", G(
            z, generator=torch.Generator("cuda").manual_seed(65)), shape)
        ws = G.mapping(z)
    run = (lambda m, x: m(x, noise_mode="const"))
    launches = forward_backward(
        "phase 25 mean-image loss from z", G, run, z, SG1_LAUNCHES,
        {"bias_act": 0, "bias_act_grad": SG1_LAUNCHES["bias_act"],
         "smooth_upsample": 0,
         "smooth_upsample_grad": SG1_LAUNCHES["smooth_upsample"]})
    cpu = card_vs_cpu("phase 25 card vs CPU", G, run, z[:CPU_BATCH])
    synth = (lambda w: G.synthesis(w, noise_mode="const"))
    bf16 = bf16_vs_f32("phase 25 bf16", synth, ws)
    convs = {}
    for resample in ("up", "down", "none"):
        conv = EqualizedConv2d(256, 256, 3, activation="lrelu",
                               resample=resample)
        init_weights(conv, torch.Generator().manual_seed(66))
        conv = seeded_generator_(conv, 67).cuda()
        # an input that needs its gradient, so the backward runs B2b
        x = torch.randn((BATCH, 256, 32, 32),
                        generator=torch.Generator().manual_seed(68)).cuda()
        x.requires_grad_()
        up = int(resample == "up")
        got = forward_backward(
            f"phase 25 EqualizedConv2d {resample}", conv,
            lambda m, t: m(t, gain=0.5), x,
            {"bias_act": 1, "bias_act_grad": 0, "smooth_upsample": up,
             "smooth_upsample_grad": 0},
            {"bias_act": 0, "bias_act_grad": 1, "smooth_upsample": 0,
             "smooth_upsample_grad": up})
        convs[resample] = {"launches_fwd_bwd": got, "cpu_vs_card":
                           card_vs_cpu(f"phase 25 EqualizedConv2d "
                                       f"{resample}", conv,
                                       lambda m, t: m(t, gain=0.5),
                                       x.detach()[:CPU_BATCH])}
    log(f"phase 25: StyleGAN1 G({OUTPUT_SIZE}) batch {BATCH}: forward + "
        f"backward {launches}; card vs CPU at batch {CPU_BATCH}: image rel "
        f"{cpu['output_rel_err']:.2e}, worst gradient against float64 "
        f"{cpu['worst_grad_tensor']} at {cpu['worst_grad_ratio']:.3f} of "
        f"its tolerance (the CPU's f32 {cpu['cpu_f32_worst_grad_tensor']} "
        f"at {cpu['cpu_f32_worst_grad_ratio']:.3f}; past it on the card as "
        f"on the CPU: {cpu['past_tolerance_as_cpu']}); bf16 vs f32 "
        f"{bf16:.2e} of scale; EqualizedConv2d "
        + ", ".join(f"{k}: rel {v['cpu_vs_card']['output_rel_err']:.2e}, "
                    f"grads {v['cpu_vs_card']['worst_grad_ratio']:.3f}"
                    for k, v in convs.items()))
    del ws

    def ws_for(batch):
        g = torch.Generator().manual_seed(69)
        with torch.no_grad():
            return G.mapping(torch.randn((batch, 512), generator=g).cuda())

    rates = generator_rates("phase 25", synth, ws_for)
    del G
    return {"launches_fwd_bwd": launches, "cpu_vs_card": cpu,
            "bf16_vs_f32_rel": bf16, "equalized_conv": convs,
            "rates": rates}


def phase_inception(g_ema) -> dict:
    """Phase 26: InceptionV3 (FID variant, seeded weights and BatchNorm
    statistics) features of FID_N stage-1 g_ema samples (128², resized to
    299) and FID_N seeded reals at batch FID_BATCH, in f32 and bf16."""
    net = InceptionV3()
    init_weights(net, torch.Generator().manual_seed(70))
    net = seeded_batchnorm_(net, 71).cuda().eval()
    zg = torch.Generator("cuda").manual_seed(72)
    fakes = []
    with torch.no_grad():
        for _ in range(FID_N // FID_BATCH):
            z = torch.randn((FID_BATCH, g_ema.z_dim), generator=zg,
                            device="cuda")
            fakes.append(g_ema(z, generator=zg).float())
    fakes = torch.cat(fakes)
    reals = stage1_reals(FID_N, seed=73).permute(0, 3, 1, 2).contiguous()
    reals = reals.cuda()
    shifted = (reals + 0.5).clamp(-1, 1)
    out, f32_feats = {}, None
    for dname in ("f32", "bf16"):
        def embed(x, _bf16=dname == "bf16"):
            with torch.no_grad(), torch.autocast("cuda", torch.bfloat16,
                                                 enabled=_bf16):
                return net(x).float()

        reset_launches()
        feats = torch.cat([embed(fakes[i: i + FID_BATCH])
                           for i in range(0, FID_N, FID_BATCH)])
        torch.cuda.synchronize()
        check_launches(f"phase 26 {dname}", read_launches(),
                       dict.fromkeys(KERNELS, 0))
        if tuple(feats.shape) != (FID_N, 2048) or \
                not torch.isfinite(feats).all():
            fail(f"phase 26 {dname}: features {tuple(feats.shape)} or not "
                 f"finite")
        res = {}
        if dname == "f32":
            f32_feats = feats
            with torch.no_grad():
                want = copy.deepcopy(net).cpu()(fakes[:FID_CPU].cpu())
            err = (feats[:FID_CPU].cpu() - want).abs().max().item()
            scale = want.abs().max().item()
            if not err <= CPU_REL_TOL * scale:
                fail(f"phase 26: card and CPU features differ by {err:.3e} "
                     f"(scale {scale:.3e})")
            res["cpu_rel_err"] = err / scale
        else:
            rel = ((feats - f32_feats).abs().max()
                   / f32_feats.abs().max()).item()
            if not rel <= BF16_REL_TOL:
                fail(f"phase 26: bf16 features differ from f32 by {rel:.3e}")
            res["bf16_vs_f32_rel"] = rel
        fid = {k: embedding_fid(embed, reals, other, FID_BATCH)
               for k, other in (("same", reals), ("g_ema", fakes),
                                ("shifted", shifted))}
        trace = float(torch.var(f32_feats.double(), dim=0).sum())
        if not (abs(fid["same"]) <= 1e-3 * trace
                and fid["g_ema"] > 10 * abs(fid["same"])
                and fid["shifted"] > 10 * abs(fid["same"])):
            fail(f"phase 26 {dname}: FID {fid} (feature variance {trace})")
        ms = cuda_time_ms(lambda: embed(fakes[:FID_BATCH]), reps=5,
                          warmup=1)
        res.update(fid=fid, device_ms=ms,
                   images_per_s=FID_BATCH / ms * 1e3)
        if dname == "bf16":
            details = {}
            profile_breakdown(f"phase 26: profile of InceptionV3 bf16 batch "
                              f"{FID_BATCH}",
                              lambda: embed(fakes[:FID_BATCH]),
                              details=details)
            res["profile"] = details
        out[dname] = res
        log(f"phase 26: InceptionV3 {dname} batch {FID_BATCH}: features "
            f"({FID_N}, 2048) finite, no B1/B1b/B2/B2b launch, "
            + (f"card vs CPU rel {res['cpu_rel_err']:.2e}" if dname == "f32"
               else f"vs f32 rel {res['bf16_vs_f32_rel']:.2e}")
            + f"; FID reals/reals {fid['same']:.3e}, reals/g_ema "
            f"{fid['g_ema']:.4f}, reals/shifted {fid['shifted']:.4f}; "
            f"{ms:.2f} ms device a batch ({res['images_per_s']:.1f} "
            f"images/s)")
    del net, fakes, reals, shifted
    return out


def write_eval_folder(root: str, n: int, seed: int = 74):
    """``res/`` and ``gt/`` with n seeded 128 px PNG pairs of the same
    names, and ``faces/<identity>/`` with the ground truths under 4
    identities."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:128, 0:128] / 128.0
    for sub in ("res", "gt", "faces"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        base = np.stack([np.sin(6 * xx + i), np.cos(5 * yy + i), xx * yy],
                        -1)
        gt = 127.5 + 90 * base + 10 * rng.randn(128, 128, 3)
        res = gt + 25 * rng.randn(128, 128, 3)
        for sub, img in (("gt", gt), ("res", res)):
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(root, sub, f"{i:03d}.png"))
        ident = os.path.join(root, "faces", f"id{i % 4}")
        os.makedirs(ident, exist_ok=True)
        Image.fromarray(np.clip(gt, 0, 255).astype(np.uint8)).save(
            os.path.join(ident, f"{i:03d}.png"))


def phase_eval_tools() -> dict:
    """Phase 27: EVAL_PAIRS seeded result/GT pairs through the
    ``calc_losses_on_images`` CLI (l2, lpips, id; seeded weights) and the
    identity folder through ``extract_features_from_folder`` (a seeded
    IR-SE-50), on the card and on the CPU."""
    out = {}
    with tempfile.TemporaryDirectory() as root:
        write_eval_folder(root, EVAL_PAIRS)
        argv = ["--data_path", os.path.join(root, "res"), "--gt_path",
                os.path.join(root, "gt"), "--mode", "l2", "lpips", "id",
                "--batch_size", "16", "--device"]
        reset_launches()
        card = calc_losses_on_images.main(argv + ["cuda"])
        torch.cuda.synchronize()
        check_launches("phase 27 calc_losses", read_launches(),
                       dict.fromkeys(KERNELS, 0))
        cpu = calc_losses_on_images.main(argv + ["cpu"])
        for mode, stats in cpu.items():
            for k, v in stats.items():
                if not abs(card[mode][k] - v) <= CPU_REL_TOL * abs(v):
                    fail(f"phase 27: {mode} {k} card {card[mode][k]} vs CPU "
                         f"{v}")
        out["losses"] = {"card": card, "cpu": cpu}
        net = IR_SE_50(112)
        init_weights(net, torch.Generator().manual_seed(75))
        net = seeded_batchnorm_(net, 76).eval()
        cpu_net = copy.deepcopy(net)
        faces = os.path.join(root, "faces")
        reset_launches()
        feats = extract_features_from_folder(net, faces, batch_size=16)
        torch.cuda.synchronize()
        check_launches("phase 27 features", read_launches(),
                       dict.fromkeys(KERNELS, 0))
        want = extract_features_from_folder(cpu_net, faces, batch_size=16,
                                            device="cpu")
        err = float(np.abs(feats - want).max())
        norms = np.linalg.norm(feats, axis=1)
        if feats.shape != (EVAL_PAIRS, 512) or not np.allclose(norms, 1,
                                                                atol=1e-5):
            fail(f"phase 27: features {feats.shape}, norms {norms.min()} - "
                 f"{norms.max()}")
        if not err <= CPU_REL_TOL:
            fail(f"phase 27: card and CPU features differ by {err:.3e}")
        out["features_cpu_abs_err"] = err
    log(f"phase 27: calc_losses_on_images over {EVAL_PAIRS} pairs, card vs "
        f"CPU: " + ", ".join(f"{m} {card[m]['mean']:.6f} vs "
                             f"{cpu[m]['mean']:.6f}" for m in cpu)
        + f"; extract_features_from_folder ({EVAL_PAIRS}, 512) card vs "
        f"CPU {err:.2e}; no B1/B1b/B2/B2b launch")
    return out


# -- stage 3 with the zoo (phases 28-32) -------------------------------------

def zoo_step_vs_cpu(name: str) -> dict:
    """Phase 28b: one first step of fresh ``name`` trainers (seed 0, dropout
    off, no crop) on the card and on the CPU at batch S3_BATCH, uint8
    inputs: the loss within CPU_REL_TOL; each update within phase 12's
    tolerance of the CPU's or, where a ReLU or PReLU input within rounding
    of 0 takes the other branch on one device (a train-mode BatchNorm at
    batch 8 makes such steps chaotic), within it of a float64 CPU step's
    or no further from that than ROUNDOFF_FACTOR times the CPU's f32 step;
    BatchNorm running statistics 1e-4 of scale."""
    card = stage3_trainer("cuda", dropout=False, augment=False,
                          backbone=name)
    cpu = stage3_trainer("cpu", dropout=False, augment=False, backbone=name)
    x, y = stage3_inputs(S3_BATCH, seed=21, size=112)
    before = {k: v.clone() for k, v in cpu.backbone.state_dict().items()}
    before["head.weight"] = cpu.head_weight.detach().clone()
    reset_launches()
    loss = card.train_step(x.cuda(), y.cuda(), 0)["loss"].item()
    torch.cuda.synchronize()
    launches = read_launches()
    t0 = time.perf_counter()
    c_loss = cpu.train_step(x, y, 0)["loss"].item()
    dt = time.perf_counter() - t0

    def state(t):
        out = {k: v.detach().cpu().double() for k, v in
               t.backbone.state_dict().items()}
        out["head.weight"] = t.head_weight.detach().cpu().double()
        return out

    got, want = state(card), state(cpu)
    before = {k: v.double() for k, v in before.items()}
    del card
    lrel = abs(loss - c_loss) / abs(c_loss)
    if not lrel <= CPU_REL_TOL:
        fail(f"phase 28 {name}: loss card {loss} vs CPU {c_loss}")
    params = [k for k, _ in cpu.backbone.named_parameters()] + ["head.weight"]

    def ratios(a, b):
        """|update a - update b| over phase 12's tolerance (from b)."""
        gmax = max((b[k] - before[k]).abs().max().item() for k in params)
        out = {}
        for k in params:
            ub = b[k] - before[k]
            tol = (CPU_UPDATE_TOL * ub.abs().max().item() + 1e-6 * gmax
                   + 4 * torch.finfo(torch.float32).eps * b[k].abs())
            out[k] = (((a[k] - before[k]) - ub).abs() / tol).max().item()
        return out

    direct = ratios(got, want)
    past = sorted(k for k, r in direct.items() if r > 1.0)
    res = {"loss_rel": lrel, "launches": launches, "cpu_step_s": dt,
           "worst_update_ratio": max(direct.values()),
           "worst_update_tensor": max(direct, key=direct.get),
           "past_tolerance": len(past)}
    if past:
        ref = stage3_trainer("cpu", dropout=False, augment=False,
                             backbone=name)
        ref.backbone.double()
        ref.head_weight.data = ref.head_weight.data.double()
        ref.train_step(x.double() / 127.5 - 1.0, y, 0)
        f64 = state(ref)
        card64, cpu64 = ratios(got, f64), ratios(want, f64)
        for k in past:
            if card64[k] > max(1.0, ROUNDOFF_FACTOR * cpu64[k]):
                fail(f"phase 28 {name}: update {k} is {direct[k]:.2f}x phase "
                     f"12's tolerance from the CPU's and {card64[k]:.2f}x "
                     f"from a float64 step's (the CPU's f32 step "
                     f"{cpu64[k]:.2f}x)")
        res["past_tolerance_vs_f64"] = [[k, direct[k], card64[k], cpu64[k]]
                                        for k in past]
    bn_err = 0.0
    for k in want:
        if not k.endswith("running_mean"):
            continue
        kv = k[:-len("mean")] + "var"
        vmax = want[kv].abs().max().item()
        err = max((got[k] - want[k]).abs().max().item() / math.sqrt(vmax),
                  (got[kv] - want[kv]).abs().max().item() / vmax)
        if err > 1e-4:
            fail(f"phase 28 {name}: BatchNorm {k} card vs CPU {err:.3e} of "
                 f"scale")
        bn_err = max(bn_err, err)
    res["bn_rel"] = bn_err
    if any(launches.values()):
        fail(f"phase 28 {name}: the step launched {launches}")
    log(f"phase 28: {name} first step card vs CPU at batch {S3_BATCH}: loss "
        f"{loss:.6f} vs {c_loss:.6f} (rel {lrel:.2e}); worst update "
        f"{res['worst_update_tensor']} at {res['worst_update_ratio']:.3f} of "
        f"phase 12's tolerance ({len(past)} past it"
        + (", each within the float64 rule" if past else "")
        + f"); BatchNorm statistics {bn_err:.2e} of scale; CPU step "
        f"{dt:.1f} s")
    return res


def phase_zoo_stage3(name: str) -> dict:
    """Phase 28: the stage-3 recipe with the CLI's ``name`` backbone:
    2 "frozen" + 2 unfrozen f32 steps at batch S3_BATCH from packed shards
    through the prefetch (the backbone has no body, so the frozen epochs
    train everything, as in the JAX package), the first step against the
    CPU, train rates at bf16 batch 256 and f32 batch 100, the MFU and a
    profile of the bf16 batch-256 step."""
    from torch.utils.flop_counter import FlopCounterMode
    trainer = stage3_trainer("cuda", backbone=name)
    bb = trainer.backbone
    start = {k: v.detach().clone() for k, v in bb.state_dict().items()}
    head0 = trainer.head_weight.detach().clone()
    x, y = stage3_inputs(S3_BATCH * S3_STEPS, seed=20)
    with tempfile.TemporaryDirectory() as shards:
        write_packed(shards, x.numpy(), y.numpy(),
                     [str(i) for i in range(S3_CLASSES)], shard_size=16)
        loader = PackedLoader(PackedTrainDataset(shards), S3_BATCH)
        reset_launches()
        losses = []
        for i, (xb, yb) in enumerate(device_prefetch(iter(loader))):
            mask = trainer.freeze_mask(i < S3_STEPS // 2)
            if not all(mask.values()):
                fail(f"phase 28 {name}: the frozen mask froze "
                     f"{[k for k, v in mask.items() if not v][:3]}")
            losses.append(trainer.train_step(xb, yb, i, mask)["loss"].item())
        torch.cuda.synchronize()
    launches = read_launches()
    if len(losses) != S3_STEPS or not all(map(math.isfinite, losses)):
        fail(f"phase 28 {name}: losses {losses}")
    end = bb.state_dict()
    keys = [k for k, _ in bb.named_parameters()]
    moved = [k for k in keys if not torch.equal(start[k], end[k])]
    if len(moved) < 0.9 * len(keys) or torch.equal(head0,
                                                   trainer.head_weight):
        fail(f"phase 28 {name}: only {len(moved)} of {len(keys)} tensors "
             f"moved")
    still = [k for k in end if k.endswith("running_mean")
             and torch.equal(start[k], end[k])]
    if still:
        fail(f"phase 28 {name}: BatchNorm statistics did not move: "
             f"{still[:5]}")
    if any(launches.values()):
        fail(f"phase 28 {name}: the train steps launched {launches}")
    log(f"phase 28: stage-3 {name}, ArcFace over {S3_CLASSES} classes, f32 "
        f"batch {S3_BATCH}, {S3_STEPS} steps from packed shards (the first "
        f"{S3_STEPS // 2} 'frozen': no body, everything trains): losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; {len(moved)} of {len(keys)} tensors moved; launches "
        f"{launches}")
    out = {"losses": losses, "launches": launches,
           "cpu_vs_card": zoo_step_vs_cpu(name), "train": {}}
    for dname, cdt, batch in ZOO_S3_RATES:
        r = stage3_rate(trainer, batch, cdt)
        out["train"][f"{dname}_batch{batch}"] = r
        log(f"phase 28: {name} train step {dname} batch {batch}: "
            f"{r['images_per_s']:.1f} images/s, {r['step_ms']:.1f} ms/step, "
            f"peak {r['peak_gib']:.1f} GiB")
    b = S3_PROFILE_BATCH
    trainer.cfg = dataclasses.replace(trainer.cfg, compute_dtype="bfloat16")
    xb, yb = (t.cuda() for t in stage3_inputs(b, seed=23))
    with FlopCounterMode(display=False) as fc:
        trainer.train_step(xb, yb, 0)
    flops = fc.get_total_flops()
    step_s = out["train"][f"bf16_batch{b}"]["step_ms"] / 1e3
    out.update(step_flops=flops,
               stage3_train_mfu=flops / step_s / BF16_FLOPS_PER_S)
    log(f"phase 28: {name} stage3_train_mfu {out['stage3_train_mfu']:.4f} "
        f"({flops / 1e12:.3f} TFLOP a bf16 batch-{b} step, "
        f"{flops / b / 3e9:.2f} GFLOP an image forward if backward is twice "
        f"the forward)")
    details = {}
    totals = profile_breakdown(
        f"phase 28: profile of a {name} bf16 batch-{b} stage-3 train step",
        lambda: trainer.train_step(xb, yb, 0), details=details,
        kinds=PROFILE_KINDS)
    if any(n for _, n in totals.values()):
        fail(f"phase 28 {name}: the profiled step launched {totals}")
    out[f"profile_bf16_batch{b}"] = details
    if name == "ResNet_50":
        out["checkpoint"] = {"backbone": {k: v.cpu() for k, v in
                                          bb.state_dict().items()}}
    return out


def phase_remat() -> dict:
    """Phase 28c: ``Stage3Config.remat`` on and off for the recipe's
    ``PSpFaceRec`` IR-SE-50 at bf16 batch 256: the first step's loss
    (the same weights and dropout draws), peak GiB and ms a step."""
    x, y = (t.cuda() for t in stage3_inputs(S3_PROFILE_BATCH, seed=24))
    out = {}
    for remat in (False, True):
        tr = stage3_trainer("cuda", "bfloat16", remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        loss = tr.train_step(x, y, 0)["loss"].item()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3):
            m = tr.train_step(x, y, i + 1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        launches = read_launches()
        if any(launches.values()) or not math.isfinite(m["loss"].item()):
            fail(f"phase 28 remat={remat}: launches {launches}, loss "
                 f"{m['loss'].item()}")
        out["on" if remat else "off"] = {
            "first_loss": loss, "step_ms": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del tr, m
        torch.cuda.empty_cache()
    on, off = out["on"], out["off"]
    out["loss_rel"] = abs(on["first_loss"] - off["first_loss"]) / abs(
        off["first_loss"])
    if not out["loss_rel"] <= CPU_REL_TOL:
        fail(f"phase 28: remat changed the step's loss {off['first_loss']} "
             f"-> {on['first_loss']}")
    log(f"phase 28: remat off/on, PSpFaceRec IR-SE-50 bf16 batch "
        f"{S3_PROFILE_BATCH}: loss {off['first_loss']:.6f} / "
        f"{on['first_loss']:.6f} (rel {out['loss_rel']:.1e}); "
        f"{off['step_ms']:.1f} / {on['step_ms']:.1f} ms a step; peak "
        f"{off['peak_gib']:.2f} / {on['peak_gib']:.2f} GiB")
    return out


def zoo_model(name: str):
    """Phase 29's ``name`` at full width from seed 0, seeded BatchNorm
    statistics (and GAC attention gates), eval mode, on the card; its
    inputs at ``batch`` (GAC: the 6-channel input and labels 0-3)."""
    builders = {
        "ResNet_101": lambda: resnet.ResNet_101(112),
        "AttentionNet_56": lambda: attention.AttentionNet_56(),
        "EfficientNetB0": lambda: efficientnet.EfficientNetB0(),
        "GhostNet": lambda: ghostnet.GhostNet(),
        "gac_resnet50": lambda: gac.gac_resnet50(ndemog=4, adap=True,
                                                 use_att=True)}
    m = builders[name]()
    init_weights(m, torch.Generator().manual_seed(0))
    seeded_batchnorm_(m, 52)
    g = torch.Generator().manual_seed(53)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, gac.AttBlock):
                mod.att_channel.normal_(0.0, 1.0, generator=g)
    return m.cuda().eval()


def zoo_inputs(name: str, batch: int):
    g = torch.Generator().manual_seed(54)
    if name.startswith("gac"):
        return [torch.randn(batch, 6, 112, 112, generator=g),
                torch.arange(batch) % 4]
    return torch.randn(batch, 3, 112, 112, generator=g)


def zoo_run(m, inputs):
    return m(*inputs) if isinstance(inputs, list) else m(inputs)


def phase_zoo() -> dict:
    """Phase 29: the backbone zoo on the card in eval mode: each model's
    output and the gradients of a seeded weighting of it against the CPU
    (``card_vs_cpu``; batch 2, GAC batch 4 so that its labels cover the
    four groups), no B1/B1b/B2/B2b launch, and bf16 batch-256 forward
    images/s."""
    out = {}
    for name in ZOO_MODELS:
        m = zoo_model(name)
        reset_launches()
        res = card_vs_cpu(f"phase 29 {name}", m, zoo_run,
                          zoo_inputs(name, 4 if name.startswith("gac")
                                     else CPU_BATCH), f64_on_miss=True)
        inputs = to_device(zoo_inputs(name, ZOO_RATE_BATCH), "cuda")
        res["bf16_batch256"] = no_grad_rate(lambda i: zoo_run(m, i), inputs,
                                            ZOO_RATE_BATCH, "bf16")
        torch.cuda.synchronize()
        res["launches"] = read_launches()
        if any(res["launches"].values()):
            fail(f"phase 29 {name}: launched {res['launches']}")
        grads = (f"{res['worst_grad_ratio_vs_cpu_f32']:.3f} of phase 8's "
                 f"tolerance from the CPU's"
                 if "worst_grad_ratio_vs_cpu_f32" in res else
                 f"{res['worst_grad_ratio']:.3f} of phase 8's tolerance from "
                 f"a float64 run (CPU f32 "
                 f"{res['cpu_f32_worst_grad_ratio']:.3f})")
        log(f"phase 29: {name}: card vs CPU output rel "
            f"{res['output_rel_err']:.2e}, worst gradient {grads}; "
            f"bf16 batch {ZOO_RATE_BATCH} forward "
            f"{res['bf16_batch256']['images_per_s']:.1f} images/s "
            f"({res['bf16_batch256']['device_ms']:.2f} ms device)")
        out[name] = res
        del m, inputs
        torch.cuda.empty_cache()
    return out


HEAD_KINDS = ("AMSoftmaxV2", "ArcNegFace", "CircleLoss", "MagFace",
              "MVSoftmax", "NPCFace")


def _head_grads(head, feats, labels, w):
    """Logits (and MagFace's regularizer) and the gradients of a weighting
    of them with respect to the features and the class weights."""
    f = feats.clone().requires_grad_(True)
    head.zero_grad(set_to_none=True)
    out = head(f, labels)
    logits, reg = out if isinstance(out, tuple) else (out, None)
    loss = (logits * w).sum() + (0 if reg is None else reg.sum())
    loss.backward()
    (pname, p), = head.named_parameters()
    return {"logits": logits.detach(), "features": f.grad,
            pname: p.grad}


def phase_heads_extra() -> dict:
    """Phase 30: the seven extra heads at 512 x S3_CLASSES, batch
    HEAD_BATCH, forward and backward on the card against the CPU (logits
    within CPU_REL_TOL of scale, the feature and class-weight gradients
    within phase 12's tolerance of their largest), the card's ms; and
    SSTPrototype (queue SST_QUEUE) over SST_STEPS steps with the same
    coins (a CPU generator) on both devices: logits as above, the queue
    within 1e-5, the cursor and labels equal."""
    g = torch.Generator().manual_seed(60)
    feats = torch.randn(HEAD_BATCH, 512, generator=g) * 2.0
    labels = torch.randint(0, S3_CLASSES, (HEAD_BATCH,), generator=g)
    w = torch.randn(HEAD_BATCH, S3_CLASSES, generator=g)
    out = {}
    reset_launches()
    for name in HEAD_KINDS:
        cpu = getattr(heads_extra, name)(512, S3_CLASSES)
        card = copy.deepcopy(cpu).cuda()
        dev = [t.cuda() for t in (feats, labels, w)]
        got = _head_grads(card, *dev)
        want = _head_grads(cpu, feats, labels, w)
        res = {}
        for k, v in want.items():
            err = (got[k].cpu() - v).abs().max().item()
            scale = v.abs().max().item()
            tol = (CPU_REL_TOL if k == "logits" else CPU_UPDATE_TOL) * scale
            if not err <= tol:
                fail(f"phase 30 {name}: card and CPU {k} differ by "
                     f"{err:.3e} (scale {scale:.3e})")
            res[f"{k}_rel_err"] = err / scale
        res["ms"] = cuda_time_ms(lambda: _head_grads(card, *dev), reps=5,
                                 warmup=1)
        log(f"phase 30: {name} 512 x {S3_CLASSES} batch {HEAD_BATCH}: card "
            f"vs CPU " + ", ".join(f"{k} {v:.1e}" for k, v in res.items()
                                   if k != "ms")
            + f" of scale; forward + backward {res['ms']:.2f} ms")
        out[name] = res
        del card, dev
    cpu = heads_extra.SSTPrototype(512, SST_QUEUE)
    card = copy.deepcopy(cpu).cuda()
    rows = []
    for step in range(SST_STEPS):
        views = [torch.randn(HEAD_BATCH, 512, generator=g) for _ in range(4)]
        ids = torch.randint(0, S3_CLASSES, (HEAD_BATCH,), generator=g)
        o_card = card(*[v.cuda() for v in views], ids.cuda(),
                      generator=torch.Generator().manual_seed(70 + step))
        o_cpu = cpu(*views, ids,
                    generator=torch.Generator().manual_seed(70 + step))
        errs = [((a.cpu() - b).abs().max() / b.abs().max()).item()
                for a, b in zip(o_card[:2], o_cpu[:2])]
        q_err = (card.queue.cpu() - cpu.queue).abs().max().item()
        if max(errs) > CPU_REL_TOL or q_err > 1e-5 or not (
                torch.equal(card.labels.cpu(), cpu.labels)
                and int(card.index) == int(cpu.index)
                and torch.equal(o_card[2].cpu(), o_cpu[2])):
            fail(f"phase 30 SSTPrototype step {step}: logits {errs}, queue "
                 f"{q_err:.2e}, index {int(card.index)} vs {int(cpu.index)}")
        rows.append({"logits_rel_err": max(errs), "queue_abs_err": q_err,
                     "index": int(card.index)})
    torch.cuda.synchronize()
    out["SSTPrototype"] = rows
    out["launches"] = read_launches()
    if any(out["launches"].values()):
        fail(f"phase 30: the heads launched {out['launches']}")
    log(f"phase 30: SSTPrototype queue {SST_QUEUE}, {SST_STEPS} steps with "
        f"the same coins: logits within "
        f"{max(r['logits_rel_err'] for r in rows):.1e} of scale, queue "
        f"{max(r['queue_abs_err'] for r in rows):.1e}, cursor "
        f"{rows[-1]['index']}, labels equal; no launch")
    return out


def write_rb_partition(root: str, seed: int = 80):
    """RBW_GROUPS groups of RBW_IDS identities x RBW_POS images and RBW_NEG
    negatives, 128 px PNGs. An identity is a smooth random field (a 7 x 7
    grid upsampled), its j-th image that field plus noise of RBW_NOISE * j
    / (RBW_POS - 1); the negatives are pairs of a field and that field plus
    noise of up to RBW_NOISE. With random weights an image's embedding
    turns away from its field's quickly as the noise grows, so the noise
    levels spread the similarities over the thresholds."""
    from PIL import Image
    g = torch.Generator().manual_seed(seed)
    os.makedirs(os.path.join(root, "lists"))

    def fields(n):
        f = torch.nn.functional.interpolate(
            torch.rand((n, 3, 7, 7), generator=g), size=(128, 128),
            mode="bilinear", align_corners=False)
        return f.permute(0, 2, 3, 1) * 255

    def noise(shape, sigma):
        return sigma * torch.randn(shape, generator=g)

    levels = RBW_NOISE * torch.arange(RBW_POS) / (RBW_POS - 1)
    for grp in rb_webface.ETHNICITIES[:RBW_GROUPS]:
        os.makedirs(os.path.join(root, "images", grp))
        ids = fields(RBW_IDS)[:, None]
        pos = ids + noise(ids.shape[:1] + (RBW_POS, 128, 128, 3),
                          levels[None, :, None, None, None])
        base = fields(RBW_NEG // 2)
        neg = torch.stack([base, base + noise(base.shape, RBW_NOISE * torch.rand(
            (len(base), 1, 1, 1), generator=g))], 1)
        for kind, arr in (("pos", pos), ("neg", neg)):
            arr = arr.reshape(-1, 128, 128, 3).clamp(0, 255).round().to(
                torch.uint8).numpy()
            names = [f"{grp}/{kind}{i:05d}.png" for i in range(len(arr))]
            with ThreadPoolExecutor(8) as ex:
                list(ex.map(lambda a, n: Image.fromarray(a).save(
                    os.path.join(root, "images", n), compress_level=1),
                    arr, names))
            with open(os.path.join(root, "lists", f"{kind}_pairs_samples_"
                                   f"{grp}.txt"), "w") as f:
                f.write("\n".join(names))


@torch.no_grad()
def recalibrated_resnet50(checkpoint: dict, root: str):
    """The ResNet_50 of ``checkpoint`` on the card with every BatchNorm's
    running statistics estimated anew over the positive images of
    ``root``'s partition (their plain averages): after a few steps on
    random labels its stale statistics map every image to nearly one
    embedding, which leaves every similarity above the thresholds."""
    net = resnet.ResNet_50(112)
    net.load_state_dict(checkpoint["backbone"])
    net = net.cuda().train()
    net.dropout.eval()
    bns = [m for m in net.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    names = []
    for grp in rb_webface.ETHNICITIES[:RBW_GROUPS]:
        with open(os.path.join(root, "lists",
                               f"pos_pairs_samples_{grp}.txt")) as f:
            names += f.read().splitlines()
    for i in range(0, len(names), 500):
        x = np.stack([rb_webface.load_image(os.path.join(root, "images", n))
                      for n in names[i:i + 500]])
        net(torch.from_numpy(x).cuda().permute(0, 3, 1, 2))
    for m in bns:
        m.momentum = 0.1
    return net.eval()


def phase_rb_webface(checkpoint: dict) -> dict:
    """Phase 31: the RB-WebFace CLI on the card over a synthetic partition
    with phase 28's ResNet_50 checkpoint (its BatchNorm statistics
    estimated over the partition); the same embeddings counted on
    the CPU (counts may differ only for pairs within RBW_NEAR of a
    threshold); the impostor sweep alone on RBW_SWEEPS seeded unit
    embeddings: ms and peak GiB, below a (thresholds, chunk, M) bool
    tensor's size."""
    out = {}
    thresholds = np.linspace(0.3, 0.6, num=20)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_rb_partition(root)
        out["write_s"] = time.perf_counter() - t0
        net = recalibrated_resnet50(checkpoint, root)
        ckpt = os.path.join(root, "s3.pt")
        torch.save({"backbone": net.state_dict()}, ckpt)
        argv = ["--checkpoint", ckpt, "--data_path",
                os.path.join(root, "images"), "--partition_path",
                os.path.join(root, "lists"), "--backbone", "ResNet_50",
                "--device", "cuda", "--groups",
                *rb_webface.ETHNICITIES[:RBW_GROUPS]]
        reset_launches()
        t0 = time.perf_counter()
        card = test_rb_webface.main(argv)
        torch.cuda.synchronize()
        out["cli_s"] = time.perf_counter() - t0
        out["launches"] = read_launches()
        fn = make_embed_fn(net, tta=False, ccrop=False, device="cuda")
        groups = {}
        for grp, res in card.items():
            lists = {}
            for kind in ("pos", "neg"):
                with open(os.path.join(root, "lists", f"{kind}_pairs_"
                                       f"samples_{grp}.txt")) as f:
                    lists[kind] = rb_webface.embed_images(
                        fn, os.path.join(root, "images"),
                        f.read().splitlines())
            cpu = rb_webface.evaluate_group(lists["pos"], lists["neg"],
                                            device="cpu")
            # pairs whose similarity lies within RBW_NEAR of a threshold
            neg = torch.from_numpy(lists["neg"]).double()
            sims = (neg @ neg.t())[torch.triu(torch.ones(
                len(neg), len(neg), dtype=torch.bool), 1)].numpy()
            pos = rb_webface.genuine_similarities(lists["pos"], device="cpu")
            near = int(sum((np.abs(s[:, None] - thresholds) <= RBW_NEAR).sum()
                           for s in (sims, pos)))
            diff_pairs = sum(
                np.abs(np.round(res[c] * n) - np.round(cpu[c] * n)).sum()
                for c, n in (("fnr_curve", pos.size),
                             ("fpr_curve", sims.size)))
            if diff_pairs > near:
                fail(f"phase 31 {grp}: card and CPU counts differ by "
                     f"{diff_pairs:.0f} pairs, {near} lie within "
                     f"{RBW_NEAR:g} of a threshold")
            groups[grp] = {"card": {k: res[k] for k in ("tpr_at_fpr_1e3",
                                                        "tpr_at_fpr_1e4")},
                           "cpu": {k: cpu[k] for k in ("tpr_at_fpr_1e3",
                                                       "tpr_at_fpr_1e4")},
                           "count_diff_pairs": float(diff_pairs),
                           "pairs_near_threshold": near,
                           "fpr_range": [float(res["fpr_curve"].min()),
                                         float(res["fpr_curve"].max())],
                           "fnr_range": [float(res["fnr_curve"].min()),
                                         float(res["fnr_curve"].max())]}
            log(f"phase 31: {grp}: TPR@FPR 1e-3 / 1e-4 card "
                f"{res['tpr_at_fpr_1e3']:.4f} / {res['tpr_at_fpr_1e4']:.4f}, "
                f"CPU {cpu['tpr_at_fpr_1e3']:.4f} / "
                f"{cpu['tpr_at_fpr_1e4']:.4f}; counts differ by "
                f"{diff_pairs:.0f} pairs ({near} within {RBW_NEAR:g} of a "
                f"threshold); FPR {groups[grp]['fpr_range']}, FNR "
                f"{groups[grp]['fnr_range']}")
        out["groups"] = groups
    if any(out["launches"].values()):
        fail(f"phase 31: the CLI launched {out['launches']}")
    g = torch.Generator(device="cuda").manual_seed(81)
    out["sweeps"] = {}
    for m in RBW_SWEEPS:
        # unit embeddings around a shared direction: the similarities of
        # pairs spread over the thresholds (mean ~0.39, spread ~0.04)
        emb = torch.randn(m, 512, generator=g, device="cuda")
        emb[:, 0] += 18.0
        emb = emb / emb.norm(dim=1, keepdim=True)
        e = emb[:4096]
        sub = rb_webface.fmr_counts(e, thresholds)[0]             # warm-up
        sub_cpu = rb_webface.fmr_counts(e.cpu(), thresholds,
                                        device="cpu")[0]
        e = e.cpu().double()
        s = (e @ e.t())[torch.triu(torch.ones(len(e), len(e),
                                              dtype=torch.bool), 1)].numpy()
        near = int((np.abs(s[:, None] - thresholds) <= RBW_NEAR).sum())
        if np.abs(sub - sub_cpu).sum() > near:
            fail(f"phase 31: the sweep over 4096 embeddings counts "
                 f"{sub} on the card, {sub_cpu} on the CPU")
        del e, s
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        counts, pairs = rb_webface.fmr_counts(emb, thresholds)
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        forbidden = len(thresholds) * 2048 * m / 2 ** 30
        if not peak < forbidden or pairs != m * (m - 1) // 2 or not (
                np.all(np.diff(counts) <= 0) and counts[0] > counts[-1]):
            fail(f"phase 31: sweep over {m}: peak {peak:.2f} GiB (a "
                 f"(T, chunk, M) bool tensor: {forbidden:.2f}), counts "
                 f"{counts[:3]}..., pairs {pairs}")
        out["sweeps"][str(m)] = {"ms": ms, "peak_gib_above_inputs": peak,
                                 "tchunkm_bool_gib": forbidden,
                                 "fpr_curve": (counts / pairs).tolist()}
        log(f"phase 31: impostor sweep over {m} embeddings ({pairs} pairs, "
            f"20 thresholds): {ms:.1f} ms, peak {peak:.2f} GiB above the "
            f"inputs (a (T, chunk, M) bool tensor alone: {forbidden:.2f} "
            f"GiB)")
        del emb
    return out


def phase_handoff() -> dict:
    """Phase 32: the stage-3 CLI on the card from a reference-layout .pt
    (a seeded full-width PSpFaceRec's ``encoder.*`` state_dict under the
    reference names, its weights moved off init, with decoder and style
    keys beside them), 2 steps at batch S3_BATCH from packed shards: the
    handoff loads ``input_layer`` and ``body`` bit for bit (buffers
    included), the CLI's checkpoint keeps the frozen body's parameters bit
    for bit and not the file's output layer; no launch."""
    src = PSpFaceRec(size=112)
    init_weights(src, torch.Generator().manual_seed(90))
    seeded_batchnorm_(src, 91)
    g = torch.Generator().manual_seed(92)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=g))
    sd = {f"encoder.{k}": v for k, v in src.encoder.state_dict().items()}
    sd["decoder.synthesis.b4.const"] = torch.zeros(512, 4, 4)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "reference.pt")
        torch.save({"state_dict": sd, "latent_avg": torch.zeros(18, 512)},
                   path)
        fresh = PSpFaceRec(size=112).cuda()
        train_stage3.load_encoder_handoff(fresh, path)
        for part in ("input_layer", "body"):
            got = getattr(fresh.encoder, part).state_dict()
            for k, v in getattr(src.encoder, part).state_dict().items():
                if not torch.equal(got[k].cpu(), v):
                    fail(f"phase 32: {part}.{k} was not loaded bit for bit")
        del fresh
        x, y = stage3_inputs(2 * S3_BATCH, seed=93)
        shards = os.path.join(root, "shards")
        write_packed(shards, x.numpy(), y.numpy() % 16,
                     [str(i) for i in range(16)], shard_size=16)
        cfg = dict(json.load(open(STAGE3_CONFIG)), data_root=root,
                   train_subdir="shards", model_root=os.path.join(root, "runs"),
                   name="handoff", batch_size=S3_BATCH, eval_benchmarks=[])
        cfg_path = os.path.join(root, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        reset_launches()
        t0 = time.perf_counter()
        train_stage3.main(["--config", cfg_path, "--encoder_checkpoint", path,
                           "--max_steps", "2", "--device", "cuda"])
        torch.cuda.synchronize()
        out["cli_s"] = time.perf_counter() - t0
        out["launches"] = read_launches()
        run = os.path.join(root, "runs", "handoff")
        ck = torch.load(os.path.join(run, sorted(
            f for f in os.listdir(run) if f.startswith("step_"))[-1]),
            map_location="cpu", weights_only=True)["backbone"]
        body = [k for k, _ in src.encoder.body.named_parameters()]
        changed = [k for k in body if not torch.equal(
            ck[f"encoder.body.{k}"], sd[f"encoder.body.{k}"])]
        head_kept = [k for k, _ in src.encoder.output_layer.named_parameters()
                     if torch.equal(ck[f"encoder.output_layer.{k}"],
                                    sd[f"encoder.output_layer.{k}"])]
        if changed or head_kept or any(out["launches"].values()):
            fail(f"phase 32: body changed {changed[:3]}, output layer from "
                 f"the file {head_kept[:3]}, launches {out['launches']}")
    out["body_tensors"] = len(body)
    log(f"phase 32: stage-3 CLI from a reference-layout .pt on the card, 2 "
        f"steps in {out['cli_s']:.1f} s: input_layer and body loaded bit for "
        f"bit, the frozen body's {len(body)} parameters unchanged, the "
        f"output layer fresh; launches {out['launches']}")
    return out


def zoo_launches(zoo: dict) -> dict:
    """B1/B1b/B2/B2b launches summed over phases 28-32's recorded counts."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            if set(node) == set(KERNELS):
                found.append(node)
            else:
                for v in node.values():
                    walk(v)

    walk(zoo)
    return {k: sum(d[k] for d in found) for k in KERNELS}


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


SOURCES = {
    "bias_act": ("stylegan_for_facerec_torch/ops/csrc/bias_act.cu",
                 "stylegan_for_facerec_tpu/ops/fused_act.py:72"),
    "bias_act_grad": ("stylegan_for_facerec_torch/ops/csrc/bias_act_grad.cu",
                      "stylegan_for_facerec_tpu/ops/fused_act.py:80"),
    "smooth_upsample": (
        "stylegan_for_facerec_torch/ops/csrc/smooth_upsample.cu",
        "stylegan_for_facerec_tpu/ops/upfirdn_pallas.py:42"),
    # no Pallas twin: the JAX package leaves this gradient to XLA's
    # autodiff of the function named here
    "smooth_upsample_grad": (
        "stylegan_for_facerec_torch/ops/csrc/smooth_upsample_grad.cu",
        "stylegan_for_facerec_tpu/ops/resample.py:41"),
}


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    # full-f32 convolutions and matmuls: TF32 keeps ~3 decimal digits and
    # would swamp the differences the comparisons are there to bound
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)

    phase_build()
    errs = phase_compare(gen)
    model = build_psp(OUTPUT_SIZE, INPUT_SIZE, seed=0, device="cuda")
    outs, lats, inv_launches = phase_main_path(model)
    phase_cpu_reference(model, outs, lats)
    timings = kernel_timings(gen)
    path = path_times(gen, 128, torch.bfloat16)
    log_path_times("phase 5: bf16 batch 128", path)
    rates = {}
    # "tf32": f32 tensors with cuDNN's TF32 convolutions, PyTorch's default
    for dname, dtype, tf32 in (("f32", torch.float32, False),
                               ("tf32", torch.float32, True),
                               ("bf16", torch.bfloat16, False)):
        torch.backends.cudnn.allow_tf32 = tf32
        for batch in (BATCH, 128):
            rates[(dname, batch)] = inversion_rate(model, batch, dtype)
            log(f"phase 5: run_on_batch {dname} batch {batch}, {ITERS} "
                f"iterations: {rates[(dname, batch)]:.1f} images/s")
        torch.backends.cudnn.allow_tf32 = False
    m16 = copy.deepcopy(model).to(torch.bfloat16)
    x16, avg16 = (t.cuda().to(torch.bfloat16)
                  for t in make_inputs(128, seed=2))
    profile_breakdown("phase 6: profile of run_on_batch bf16 batch 128",
                      lambda: run_on_batch(m16, x16, avg16, ITERS))
    del model, m16, outs, lats, x16, avg16

    coach, avg = ready_coach()
    train_launches = phase_train(coach, avg)
    phase_train_cpu_reference(coach.model.latent_avg, avg)
    train_rates = {}
    for dname, cdt, tf32, batch in (("bf16", "bfloat16", False, 32),
                                    ("bf16", "bfloat16", False, 128),
                                    ("f32", "float32", False, 32),
                                    ("tf32", "float32", True, 32)):
        torch.backends.cudnn.allow_tf32 = tf32
        r = train_rate(coach, avg, batch, cdt)
        train_rates[f"{dname}_batch{batch}"] = r
        log(f"phase 9: train step {dname} batch {batch}: "
            f"{r['images_per_s']:.1f} images/s, {r['step_ms']:.1f} ms/step, "
            f"peak {r['peak_gib']:.1f} GiB")
        torch.backends.cudnn.allow_tf32 = False
    train_profile("phase 10: profile of a bf16 batch-128 train step",
                  coach, avg)

    trainer, handed, s3_train_launches = phase_stage3_train(coach, avg)
    del coach
    stage3 = {"cpu_vs_card": phase_stage3_cpu_reference(avg)}
    stage3.update(phase_stage3_rates(trainer))
    del trainer
    stage3["verify"], s3_verify_launches = phase_verify(handed)
    del handed

    tr1, s1_launches, s1_per_step, s1_logs = phase_stage1_train()
    stage1 = {"launches_steps_0_4": s1_launches,
              "launches_per_step_type": s1_per_step, "logs": s1_logs,
              "cpu_vs_card": phase_stage1_cpu_reference()}
    stage1.update(phase_stage1_rates(tr1, gen))
    s1_g_ema = tr1.g_ema
    del tr1

    e4e_coach, e4e_avg = ready_coach(make_e4e_coach)
    e4e_launches, e4e_rows = phase_e4e_train(e4e_coach, e4e_avg)
    e4e = {"launches_steps_0_2": e4e_launches, "steps": e4e_rows,
           "cpu_vs_card": phase_e4e_cpu_reference(
               e4e_coach.model.latent_avg, e4e_avg)}
    e4e["bootstrap_launches"], e4e["bootstrap_cpu_rel_err"] = \
        phase_e4e_bootstrap(e4e_coach.model)
    e4e.update(phase_e4e_rates(e4e_coach, e4e_avg))
    del e4e_coach
    e4e["encoders_cpu_rel_err"] = phase_encoders()
    gens = {"rosinality": phase_rosinality(), "stylegan1": phase_stylegan1(),
            "inception": phase_inception(s1_g_ema)}
    del s1_g_ema
    gens["eval_tools"] = phase_eval_tools()
    zoo = {name: phase_zoo_stage3(name) for name in ZOO_S3_BACKBONES}
    zoo["remat"] = phase_remat()
    zoo["zoo"] = phase_zoo()
    zoo["heads_extra"] = phase_heads_extra()
    zoo["rb_webface"] = phase_rb_webface(zoo["ResNet_50"].pop("checkpoint"))
    zoo["handoff"] = phase_handoff()
    smi = nvidia_smi_line()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")

    kernels = []
    sums = path_sums(path)
    for name, (src, replaces) in SOURCES.items():
        r, rb = timings[(name, "f32")], timings[(name, "bf16")]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": errs[(name, "f32")], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"]
            else "operations",
            "library_ms": None, "shape": list(r["shape"]), "dtype": "f32",
            "launches_inversion": inv_launches[name],
            "launches_stage3": s3_train_launches[name]
            + s3_verify_launches[name],
            "launches_stage1": s1_launches[name],
            "launches_e4e": e4e_launches[name],
            "launches_rosinality": gens["rosinality"]["launches_fwd_bwd"][
                name],
            "launches_stylegan1": gens["stylegan1"]["launches_fwd_bwd"][
                name],
            # phases 28-32: each checked to be 0
            "launches_stage3_zoo": zoo_launches(zoo)[name],
            "bf16": {"max_abs_err": errs[(name, "bf16")], "ms": rb["ms"],
                     "plain_ms": rb["plain_ms"],
                     "bound_ms": max(rb["bytes_ms"], rb["ops_ms"])}})
        # bf16 at batch 128: one synthesis (B1, B2) or train step's
        # backward (B1b, B2b)
        kernels[-1]["path_ms"], kernels[-1]["path_bound_ms"] = sums[name]
    print(json.dumps({"inversion_images_per_s": {
        f"{d}_batch{b}": v for (d, b), v in rates.items()},
        "train": train_rates}))
    print(json.dumps({"stage3": stage3}))
    print(json.dumps({"stage1": stage1}))
    print(json.dumps({"e4e": e4e}))
    print(json.dumps({"generators_fid_eval": gens}))
    print(json.dumps({"stage3_zoo": zoo}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def kernel_times_main():
    """``--kernel-times``: every kernel at every path shape, and the
    phase-6 and phase-10 profiles, for a comparison between two checkouts
    on one card."""
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_build()
    result = {}
    for batch in (BATCH, 128):
        for dname, dtype in DTYPES.items():
            times = path_times(gen, batch, dtype)
            log_path_times(f"{dname} batch {batch}", times)
            result[f"{dname}_batch{batch}"] = times
    model = build_psp(OUTPUT_SIZE, INPUT_SIZE, seed=0, device="cuda").to(
        torch.bfloat16)
    x16, avg16 = (t.cuda().to(torch.bfloat16)
                  for t in make_inputs(128, seed=2))
    result["profile"] = profile_breakdown(
        "profile of run_on_batch bf16 batch 128",
        lambda: run_on_batch(model, x16, avg16, ITERS))
    del model, x16, avg16
    result["train_profile"] = train_profile(
        "profile of a bf16 batch-128 train step", *ready_coach())
    print(nvidia_smi_line())
    print(json.dumps({"kernel_times": result}))


def b2_paths_main():
    """``--b2-paths``: B2 at every path shape on each of its paths. Per
    shape the readings run direct, direct whole-pass, staged, staged,
    direct whole-pass, direct, so each path has two."""
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_build()
    paths = (("direct", False, False), ("whole_pass", False, True),
             ("staged", True, False))
    rows = []
    for batch in (BATCH, 128):
        for dname, dtype in DTYPES.items():
            for shape in on_path_shapes(batch)[1]:
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                row = {"dtype": dname, "shape": list(shape),
                       "bytes": x.numel() * x.element_size(),
                       "plan_staged": b2_staged(x)}
                outs = {}
                for name, staged, whole in paths + paths[::-1]:
                    with b2_forced(staged, whole):
                        if staged and not b2_staged(x):
                            row[name] = None     # rows not 16-byte aligned
                            continue
                        outs[name] = smooth_upsample(x)
                        row.setdefault(name, []).append(
                            cuda_time_ms(lambda: smooth_upsample(x)))
                for name, y in outs.items():
                    if not torch.equal(y, outs["direct"]):
                        fail(f"B2 {dname} {shape}: {name} and direct differ")
                log(f"{dname} {shape} {row['bytes']} B (plan: "
                    f"{'staged' if row['plan_staged'] else 'direct'}): "
                    + ", ".join(f"{n} " + ("n/a" if row[n] is None else
                                           " ".join(f"{1e3 * v:.3f}"
                                                    for v in row[n]))
                                for n, _, _ in paths) + " us")
                rows.append(row)
    print(nvidia_smi_line())
    print(json.dumps({"b2_paths": rows}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--kernel-times"]:
        kernel_times_main()
    elif sys.argv[1:] == ["--b2-paths"]:
        b2_paths_main()
    elif sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    else:
        main()
