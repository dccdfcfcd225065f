#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times
    python3 chip_smoke.py --b2-paths
    python3 chip_smoke.py --parallel
    python3 chip_smoke.py --spatial

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
     body unchanged; then test_rfw on the run's newest checkpoint file
     over 600 seeded pairs (the run directory is kept for phase 47).
 33. MTCNN with its real weights: PNet at every pyramid shape of a 250²
     image, RNet on 24² and ONet on 48² batches, card vs CPU; the whole
     cascade on seeded drawn faces (boxes must reach ONet), card vs CPU
     boxes and landmarks (a difference only where one side agrees with a
     float64 CPU run); align_multi's crops card vs CPU; detection images/s
     of drawn faces at 250² (min face 20) and square-padded 1024² (min
     face 100, thresholds 0.9, mtcnn_crop_align's settings), beside the
     PNet calls and the RNet and ONet candidates an image, and the
     device's busy share of each;
 34. the data CLIs on the card over a generated tree of 24 photos (1024 x
     768 drawn faces, 4 identities): mtcnn_crop_align -> make_filelist ->
     pack_train -> pack_rfw, rfw_crop_align from one photo's landmarks
     (the crop mtcnn_crop_align wrote, within a level on average), then
     train_stage3 --packed_dir on the shards, 2 steps of the recipe with
     the packed pairs as its verification set;
 35. the loaders: which C++ loader was built (printed as "native_loader:
     built (png yes|no)" or "native_loader: unavailable: <reason>"); when
     built, its batches against the Python loader's (PNG at the target
     size bit for bit, JPEG 112 -> 128 within 2.2/255) and its images/s
     (8 threads; 112² JPEGs to 128, 512² JPEGs to 128 with and without
     fast_decode); the Python loader's images/s, RandAugment's (2 ops, one
     thread), pack_dataset's, and PackedLoader + device_prefetch's at
     batch 256;
 36. does the loader keep up with stage 3: ResNet_50 and the recipe's
     PSpFaceRec (IR-SE-50) bf16 batch-256 steps fed by PackedLoader +
     device_prefetch (pinning and copying on its producer thread) at
     depth 1, 2 and 4 from 2048 page-cached packed images, against the
     same steps on a resident batch: ms a step over two epochs (two epoch
     restarts), the host's wait for a batch, and the device's idle share
     over one epoch's steps; at each depth the card's batches hash as a
     CPU pass over the same loader does, the pinning runs on the producer
     thread, and an iterator that fails after 3 batches delivers those 3
     on the card, then raises RuntimeError("prefetch producer failed").
 37. the int8 embedder: the recipe's PSpFaceRec (IR-SE-50 at 112, seeded
     weights and BatchNorm statistics) calibrated on 4 batches of 8 and
     stripped (the weight bytes, the f32 model's torch.cuda.
     memory_allocated and what stripping frees of it), embed images/s at batch 256 through make_embed_fn (centre
     crop, TTA) in int8, bf16 and f32, the cosine of the int8 to the f32
     embeddings, the int32 accumulators of the stem conv, a body conv and
     the output linear card vs CPU on the same int8 codes (equal), no
     B1/B1b/B2/B2b launch;
 38. int8 ReStyle inversion on phase 3's PSp(256): calibrate_with over
     run_on_batch, the int8 loop at batch 8 for 5 iterations launching
     B1/B2 as often as the f32 loop (65/60), the image error against f32,
     ms an iteration int8 and f32;
 39. the same PSpFaceRec exported (torch.export, symbolic batch) in f32
     and bf16, saved, loaded and run at batch 8 and 256 against eager
     (1e-5 / 1e-2 of scale), export seconds, ms exported and eager, no
     launch;
 40. a seeded StyleGAN2-ADA G at 256² through tools/export_model.py from
     a torch ADA .pt: the loaded graph holds the sgfr::bias_act and
     sgfr::smooth_upsample nodes, its output at batch 8 equals eager's bit
     for bit, and B1/B2 launch as often as eager's; then the host µs a B1
     call takes through the custom op and through its CUDA implementation
     called directly (launches counted, not part of any path).
 41. the stage-3 convergence run: tools/convergence_run.py in-process at
     its defaults (IR-SE-50 at 112, ArcFace + focal, SGD lr 0.03 with 200
     warmup steps, 512 synthetic identities x 40 images of 128 px made
     from seed 0, crops of 112, bf16 batch 256) for CONV_STEPS steps: the
     tool's pass rule (last-50 mean loss under half the first-50's,
     last-50 top-1 over 50x chance) must hold; its curve and images/s end
     to end;
 42. data parallelism at world 1: initialize_distributed_from_env with
     torchrun's variables set (NCCL for CUDA tensors), then a bf16
     batch-256 recipe step of Stage3Trainer on make_mesh(1, 1) against
     the plain trainer from the same seed: loss, parameters and BatchNorm
     statistics within 4 ulps (bit-equal expected); ms a step of each;
 43. two ranks on one card: two parallel/_mp_worker.py processes on
     cuda:0 joined by gloo (NCCL takes one rank a device; gloo runs CUDA
     tensors, each collective staged by gloo itself), one step each at
     the recipes' widths on half the global batch: stage 3 at (data 2,
     model 1) and (data 1, model 2, the ArcFace head's 28 000 classes
     split; global batch 8), stage 1's R1 + path-length iteration (128²,
     global batch 8) and one e4e iteration (E4e(256) at 112, global batch
     4), each held
     against one process stepping the whole batch on the card at phase
     12's tolerances (Adam's first updates where phase 16 holds them:
     |g| >= 1e-3 of the tensor's largest and >= 1e4 eps); each rank's
     B1/B1b/B2/B2b launches as S1_LAUNCHES'
     R1 D step + path-length G step, E4E_ENC_LAUNCHES and 0 for stage 3;
 44. export_embedder_sharded + run_sharded at data 1 (phase 42's mesh)
     and data 2 (phase 43's ranks) against export_embedder on the whole
     batch (IR-SE-50 at 112, 8 images, f32), 1e-5 of scale.
 45. spatially sharded synthesis: two worker processes on cuda:0 joined
     by gloo, each computing half of every image's rows through
     parallel/spatial.py (halo exchanges as all-reduces of edge rows; B1
     and B2 launched on each band), against one process's whole image:
     the ADA G at 1024² (z/w 512, 8 mapping layers, channel_base 16384,
     channel_max 512) at batch 4 in f32 and bf16 with const and random
     noise, the rosinality G in config-f at 1024² (style 512, 8 MLP
     layers, channel multiplier 2) at batch 2 with and without random
     noise, and the StyleGAN1-layer ADA G at 256² at batch 8; each rank's
     f32 band within 1e-4 of the image's scale (bf16 measured), its
     B1/B1b/B2/B2b launches the one process's, the gathered image holding
     its band; ms a call and peak GiB above the weights a rank against
     the one process's;
 46. the stage-3 sweep: the port's tools/tune_stage3.py, IR_SE_50 at bf16
     (ArcFace over 28 000 classes), batches 128 and 256, remat off and
     on: ms a step, images/s, FlopCounterMode TFLOP a step and MFU
     against 989e12, in (0, 1]; no error row; remat slower than no remat
     at each batch.
 47. the last slice: device_augment on the card at batch 256, 128² ->
     112, uint8 and bf16, over 4096 images: every output a window of its
     input, flipped or not, exactly (offsets read from images whose
     pixels hold their coordinates, then random images held to those
     windows), every offset 0-16 seen on each side, the flip share within
     0.5 +- 0.05; modulated_conv2d against modulated_conv2d_grouped at
     the ADA G's widths (512 -> 512, 3x3, demodulated, batch 8) at 4² to
     256², f32 with TF32 off within 1e-5 of scale, bf16 measured;
     export_jittable of a plain function that calls a seeded 256² ADA G,
     bit-equal to eager with B1/B2 launched as eager's; test_rfw with
     --checkpoint set to phase 32's run directory (resolved to its newest
     checkpoint) gives phase 32's result.
Phases 28-37, 39, 41, 42, 44 and 46 launch none of B1, B1b, B2 or B2b;
phase 47 launches B1 and B2 only in its generator.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON, the one before that the card's name and power limit
as nvidia-smi reports them, and the ones before that the stage-1, stage-3,
e4e, phase 24-27 ("generators_fid_eval"), phase 28-32 ("stage3_zoo"),
phase 33-36 ("host_data"), phase 37-40 ("serving"), phase 41-44
("parallel"), phase 45-46 ("spatial_tune") and phase 47 ("last_slice")
numbers as JSON. Exits
nonzero without a GPU.

--parallel builds the kernels and runs phases 41-44 alone; --spatial
phases 45-46.

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
import hashlib
import itertools
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from stylegan_for_facerec_torch.data import native_loader
from stylegan_for_facerec_torch.data.dataset import (DataLoader, FacesDataset,
                                                     device_augment)
from stylegan_for_facerec_torch.data.packed import (PackedLoader,
                                                    PackedTrainDataset,
                                                    device_prefetch,
                                                    pack_dataset,
                                                    write_packed)
from stylegan_for_facerec_torch.data.randaugment import RandAugment
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
from stylegan_for_facerec_torch.models import mtcnn
from stylegan_for_facerec_torch.tools import (calc_losses_on_images,
                                              export_model, make_filelist,
                                              mtcnn_crop_align, pack_rfw,
                                              pack_train, rfw_crop_align,
                                              test_rb_webface, test_rfw,
                                              train_stage3)
from stylegan_for_facerec_torch.tools import convergence_run, tune_stage3
from stylegan_for_facerec_torch.parallel import _mp_worker as mp_worker
from stylegan_for_facerec_torch.parallel import mesh as mesh_lib
from stylegan_for_facerec_torch.nn.initializers import init_weights
from stylegan_for_facerec_torch.ops import build, fused_act, resample
from stylegan_for_facerec_torch.ops.modconv import (modulated_conv2d,
                                                    modulated_conv2d_grouped)
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
from stylegan_for_facerec_torch.utils import export as export_utils
from stylegan_for_facerec_torch.utils import quantize
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
# host data and face preprocessing (phases 33-36): MTCNN's nets card vs
# CPU within 1e-4 of each output's scale (cuDNN's f32 convolutions against
# the CPU's), boxes and landmarks within 1e-2 pixel through the cascade,
# aligned crops within one level; the detector's two settings (its
# default on 250² images; mtcnn_crop_align's on square-padded 1024²
# photos) and their rate images; the photo tree of phase 34 (drawn faces
# at 1024 x 768, seeds 0-23: the faces of 11 pass thresholds 0.9 on the
# CPU with scores of 0.97 and more); the loader trees, the rate batch and
# the loader-fed steps of phase 36
MT_NET_TOL, MT_BOX_TOL = 1e-4, 1e-2
MT_SETTINGS = {
    "250px_min20": (250, {}),
    "1024px_padded_min100": (1024, {"min_face_size": 100.0,
                                    "thresholds": (0.9, 0.9, 0.9),
                                    "nms_thresholds": (0.9, 0.9, 0.9)})}
MT_IMAGES, MT_RATE_IMAGES, MT_NET_BATCH = 8, 16, 64
PHOTO_IDS, PHOTOS_PER_ID = 4, 6
LOADER_IMAGES, LOADER_BIG, LOADER_BATCH, LOADER_WORKERS = 2048, 256, 256, 8
RA_IMAGES = 512
FEED_BACKBONES = ("ResNet_50", "pSp")
FEED_EPOCH = LOADER_IMAGES // LOADER_BATCH      # steps an epoch: 8
FEED_STEPS = 2 * FEED_EPOCH
FEED_DEPTHS = (1, 2, 4)                         # device_prefetch's depth
FEED_FAIL_AFTER = 3


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
                   backbone: str = "pSp", remat: bool = False, mesh=None
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
                            device=device, seed=0, mesh=mesh)
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


# phase 32's stage-3 run directory, its pairs and test_rfw's result on its
# newest checkpoint file, for phase 47
HANDOFF: dict = {}
HANDOFF_PAIRS = 600


def phase_handoff() -> dict:
    """Phase 32: the stage-3 CLI on the card from a reference-layout .pt
    (a seeded full-width PSpFaceRec's ``encoder.*`` state_dict under the
    reference names, its weights moved off init, with decoder and style
    keys beside them), 2 steps at batch S3_BATCH from packed shards: the
    handoff loads ``input_layer`` and ``body`` bit for bit (buffers
    included), the CLI's checkpoint keeps the frozen body's parameters bit
    for bit and not the file's output layer; no launch. Then test_rfw on
    that checkpoint file over HANDOFF_PAIRS seeded pairs, the result phase
    47 holds test_rfw on the run directory to."""
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
    # kept for phase 47, which reads the run directory again; removed
    # at exit
    keep = tempfile.TemporaryDirectory()
    HANDOFF["tmp"] = keep
    root = keep.name
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
    step_file = os.path.join(run, sorted(
        f for f in os.listdir(run) if f.startswith("step_"))[-1])
    ck = torch.load(step_file, map_location="cpu",
                    weights_only=True)["backbone"]
    body = [k for k, _ in src.encoder.body.named_parameters()]
    changed = [k for k in body if not torch.equal(
        ck[f"encoder.body.{k}"], sd[f"encoder.body.{k}"])]
    head_kept = [k for k, _ in src.encoder.output_layer.named_parameters()
                 if torch.equal(ck[f"encoder.output_layer.{k}"],
                                sd[f"encoder.output_layer.{k}"])]
    if changed or head_kept or any(out["launches"].values()):
        fail(f"phase 32: body changed {changed[:3]}, output layer from "
             f"the file {head_kept[:3]}, launches {out['launches']}")
    images, issame = verification_pairs(HANDOFF_PAIRS, seed=94)
    np.savez(os.path.join(root, "rfw_African.npz"), images=images,
             issame=issame)
    out["rfw"] = test_rfw.main(["--checkpoint", step_file, "--data_root",
                                root, "--benchmarks", "rfw_African",
                                "--device", "cuda"])
    HANDOFF.update(run=run, data_root=root, rfw=out["rfw"])
    out["body_tensors"] = len(body)
    log(f"phase 32: stage-3 CLI from a reference-layout .pt on the card, 2 "
        f"steps in {out['cli_s']:.1f} s: input_layer and body loaded bit for "
        f"bit, the frozen body's {len(body)} parameters unchanged, the "
        f"output layer fresh; launches {out['launches']}; test_rfw on its "
        f"last checkpoint over {HANDOFF_PAIRS} pairs: {out['rfw']}")
    return out


# -- host data and face preprocessing (phases 33-36) -------------------------

def draw_faces(seed: int, w: int, h: int, n: int, smin: int, smax: int):
    """A seeded RGB PIL image of ``n`` drawn faces (hair, neck, eyes,
    brows, nose, mouth) of heights ~2 x [smin, smax), blurred, with noise:
    enough of a face for MTCNN's cascade to reach ONet."""
    from PIL import Image, ImageDraw, ImageFilter
    r = np.random.RandomState(seed)
    img = Image.new("RGB", (w, h), tuple(int(x) for x in r.randint(0, 256, 3)))
    d = ImageDraw.Draw(img)
    for k in range(n):
        s = r.randint(smin, smax)
        cx = (k + 0.5) * w / n + r.randint(-w // (8 * n), w // (8 * n) + 1)
        cy = h / 2 + r.randint(-h // 10, h // 10 + 1)
        skin = r.randint(150, 235, 3)
        skin[2] = min(skin[2], skin[0] - 20)
        skin = tuple(int(x) for x in skin)
        dark = tuple(int(x * 0.55) for x in skin)
        hair = tuple(int(x) for x in r.randint(10, 80, 3))
        d.ellipse([cx - 0.95 * s, cy - 1.25 * s, cx + 0.95 * s, cy + 0.6 * s],
                  fill=hair)
        d.rectangle([cx - 0.35 * s, cy + 0.7 * s, cx + 0.35 * s,
                     cy + 1.6 * s], fill=dark)
        d.ellipse([cx - 0.8 * s, cy - s, cx + 0.8 * s, cy + s], fill=skin)
        for ex in (-0.35, 0.35):
            d.ellipse([cx + (ex - 0.17) * s, cy - 0.42 * s,
                       cx + (ex + 0.17) * s, cy - 0.18 * s], fill=dark)
            d.ellipse([cx + (ex - 0.13) * s, cy - 0.36 * s,
                       cx + (ex + 0.13) * s, cy - 0.24 * s],
                      fill=(245, 245, 245))
            d.ellipse([cx + (ex - 0.06) * s, cy - 0.36 * s,
                       cx + (ex + 0.06) * s, cy - 0.24 * s],
                      fill=(30, 20, 20))
            d.rectangle([cx + (ex - 0.18) * s, cy - 0.55 * s,
                         cx + (ex + 0.18) * s, cy - 0.48 * s], fill=hair)
        d.polygon([(cx, cy - 0.2 * s), (cx - 0.12 * s, cy + 0.18 * s),
                   (cx + 0.12 * s, cy + 0.18 * s)], fill=dark)
        d.ellipse([cx - 0.3 * s, cy + 0.4 * s, cx + 0.3 * s, cy + 0.56 * s],
                  fill=(140, 40, 50))
    arr = np.asarray(img.filter(ImageFilter.GaussianBlur(max(1, smin // 40))),
                     np.float32) + r.randn(h, w, 3) * 5
    return Image.fromarray(arr.clip(0, 255).astype(np.uint8))


def mtcnn_image(setting: str, seed: int):
    """A detector input of ``MT_SETTINGS[setting]``: one to three faces
    at 250², or one face on a 1024 x 768 photo zero-padded to 1024²."""
    from PIL import Image
    size, _ = MT_SETTINGS[setting]
    if size == 250:
        return draw_faces(seed, 250, 250, 1 + seed % 3, 25, 70)
    photo = np.asarray(draw_faces(seed, 1024, 768, 1, 150, 300))
    return Image.fromarray(mtcnn_crop_align.square_pad(photo))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def cascade_agree(a, b) -> bool:
    (ba, la), (bb, lb) = a, b
    return len(ba) == len(bb) and (len(ba) == 0 or (
        np.abs(np.asarray(ba) - bb).max() <= MT_BOX_TOL
        and np.abs(np.asarray(la) - lb).max() <= MT_BOX_TOL))


def check_no_launch(label: str) -> dict:
    """The launches since ``reset_launches``, which must all be 0."""
    got = read_launches()
    check_launches(label, got, dict.fromkeys(KERNELS, 0))
    return got


def phase_mtcnn() -> dict:
    """Phase 33: MTCNN on the card against the CPU, detection rates and
    the device's busy share."""
    reset_launches()
    card = mtcnn.MTCNN(device="cuda")
    cpu = mtcnn.MTCNN(device="cpu")
    cpu64 = mtcnn.MTCNN(device="cpu")
    for net in (cpu64.pnet, cpu64.rnet, cpu64.onet):
        net.double()
    out = {"nets_rel_err": {}}
    rng = np.random.RandomState(33)
    sides = [math.ceil(250 * s) for s in mtcnn.pyramid_scales(250, 250)]
    for name, shapes in (("pnet", [(1, s, s, 3) for s in sides]),
                         ("rnet", [(MT_NET_BATCH, 24, 24, 3)]),
                         ("onet", [(MT_NET_BATCH, 48, 48, 3)])):
        worst = 0.0
        for shape in shapes:
            x = rng.uniform(-1, 1, shape).astype(np.float32)
            for a, b in zip(card._net(getattr(card, name), x),
                            cpu._net(getattr(cpu, name), x)):
                worst = max(worst, rel_err(a, b))
        out["nets_rel_err"][name] = worst
        if not worst <= MT_NET_TOL:
            fail(f"phase 33: {name} card vs CPU {worst:.3e} of scale")
    faces, worst_box, fallback = 0, 0.0, 0
    for setting, (_, kw) in MT_SETTINGS.items():
        for seed in range(MT_IMAGES if setting == "250px_min20" else 2):
            img = mtcnn_image(setting, seed)
            got, want = card.detect_faces(img, **kw), cpu.detect_faces(img,
                                                                       **kw)
            if cascade_agree(got, want):
                if len(got[0]):
                    worst_box = max(worst_box, float(max(
                        np.abs(np.asarray(got[0]) - want[0]).max(),
                        np.abs(np.asarray(got[1]) - want[1]).max())))
            else:
                exact = cpu64.detect_faces(img, **kw)
                if not (cascade_agree(got, exact)
                        or cascade_agree(want, exact)):
                    fail(f"phase 33: {setting} seed {seed}: card "
                         f"{len(got[0])} faces, CPU {len(want[0])}, and "
                         f"neither agrees with float64")
                fallback += 1
            faces += len(got[0])
    if faces == 0:
        fail("phase 33: no face reached ONet's output")
    out.update(cascade_faces=faces, cascade_box_err_px=worst_box,
               cascade_float64_fallbacks=fallback)
    img = mtcnn_image("250px_min20", 2)
    _, fc, _ = card.align_multi(img, min_face_size=20.0)
    _, fu, _ = cpu.align_multi(img, min_face_size=20.0)
    if not fc or len(fc) != len(fu):
        fail(f"phase 33: align_multi gave {len(fc)} crops on the card, "
             f"{len(fu)} on the CPU")
    d = np.concatenate([np.abs(np.asarray(a, np.int64) - np.asarray(b))
                        .ravel() for a, b in zip(fc, fu)])
    out["align_crops"] = {"n": len(fc), "max_levels": int(d.max()),
                          "share_off": float((d > 0).mean())}
    if d.max() > 1 or (d > 0).mean() > 0.01:
        fail(f"phase 33: align_multi crops card vs CPU {out['align_crops']}")
    out["rates"] = {}
    # what the cascade did a rate image: PNet calls (pyramid levels), the
    # candidates RNet and ONet were given
    seen = dict.fromkeys(("pnet_calls", "rnet_boxes", "onet_boxes"), 0)

    def counter(key, per_box):
        def hook(module, inputs, output):
            seen[key] += inputs[0].shape[0] if per_box else 1
        return hook

    for setting, (_, kw) in MT_SETTINGS.items():
        imgs = [mtcnn_image(setting, 100 + i) for i in range(MT_RATE_IMAGES)]
        card.detect_faces(imgs[0], **kw)                   # warm-up
        hooks = [net.register_forward_hook(counter(key, per_box))
                 for net, key, per_box in (
                     (card.pnet, "pnet_calls", False),
                     (card.rnet, "rnet_boxes", True),
                     (card.onet, "onet_boxes", True))]
        seen.update(dict.fromkeys(seen, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(len(card.detect_faces(im, **kw)[0]) for im in imgs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for h in hooks:
            h.remove()
        per_image = {k: v / MT_RATE_IMAGES for k, v in seen.items()}
        details = {}
        profile_breakdown(f"phase 33: profile of detect_faces ({setting}) "
                          f"over 4 images",
                          lambda: [card.detect_faces(im, **kw)
                                   for im in imgs[:4]], top=5,
                          details=details)
        out["rates"][setting] = {
            "images_per_s": MT_RATE_IMAGES / dt, "faces": n,
            "per_image": per_image,
            "busy_share": details["device_ms"] / details["wall_ms"],
            "device_ms": details["device_ms"], "wall_ms": details["wall_ms"]}
        log(f"phase 33: detect_faces {setting}, drawn faces (not photos): "
            f"{MT_RATE_IMAGES / dt:.1f} images/s ({n} faces in "
            f"{MT_RATE_IMAGES} images; an image: "
            f"{per_image['pnet_calls']:.1f} PNet calls, "
            f"{per_image['rnet_boxes']:.1f} RNet and "
            f"{per_image['onet_boxes']:.1f} ONet candidates), device busy "
            f"{out['rates'][setting]['busy_share']:.1%}")
    out["launches"] = check_no_launch("phase 33")
    log(f"phase 33: MTCNN card vs CPU: nets {out['nets_rel_err']} of scale "
        f"(tolerance {MT_NET_TOL:g}); cascade {faces} faces, boxes and "
        f"landmarks within {worst_box:.2e} px ({fallback} float64 "
        f"fallbacks); align_multi crops {out['align_crops']}; launches "
        f"{out['launches']}")
    return out


def phase_data_clis() -> dict:
    """Phase 34: mtcnn_crop_align -> make_filelist -> pack_train ->
    pack_rfw on a generated photo tree, rfw_crop_align on one photo's
    landmarks, then 2 recipe steps of train_stage3 from the shards."""
    reset_launches()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        photos = os.path.join(root, "photos")
        for i in range(PHOTO_IDS):
            os.makedirs(os.path.join(photos, f"id{i}"))
            for j in range(PHOTOS_PER_ID):
                seed = i * PHOTOS_PER_ID + j
                draw_faces(seed, 1024, 768, 1, 150, 300).save(
                    os.path.join(photos, f"id{i}", f"{j}.jpg"), quality=95)
        crops = os.path.join(root, "crops")
        t0 = time.perf_counter()
        n = mtcnn_crop_align.main(["--in_dir", photos, "--out_dir", crops,
                                   "--device", "cuda"])
        out["crop_align_s"] = time.perf_counter() - t0
        if n < S3_BATCH:
            fail(f"phase 34: mtcnn_crop_align aligned {n} faces")
        listed = make_filelist.main(["--in_dir", crops, "--out_file",
                                     os.path.join(root, "list.txt")])
        packed = os.path.join(root, "packed")
        meta = pack_train.main(["--root", crops, "--out", packed])
        ids = sorted(os.listdir(crops))
        if len(listed) != n or meta["n_images"] != n or \
                meta["id_list"] != ids:
            fail(f"phase 34: {n} crops, {len(listed)} listed, meta {meta}")
        # pairs of the crops: each with the next (same identity or not)
        rel = sorted(os.path.relpath(p, crops) for p in listed)
        with open(os.path.join(root, "pairs.txt"), "w") as f:
            for a, b in zip(rel, rel[1:] + rel[:1]):
                same = a.split(os.sep)[0] == b.split(os.sep)[0]
                f.write(f"{a} {b} {int(same)}\n")
        n_pairs = pack_rfw.main(["--pairs", os.path.join(root, "pairs.txt"),
                                 "--image_root", crops, "--out",
                                 os.path.join(root, "rfw_African")])
        # rfw_crop_align from the landmarks of one padded photo (stored
        # losslessly under a .jpg name, so the crop is written as JPEG as
        # mtcnn_crop_align writes it) gives that photo's crop
        from PIL import Image
        first = rel[0]
        src = os.path.join(photos, first.split(os.sep)[0],
                           os.path.basename(first).rsplit("_", 1)[0])
        padded = mtcnn_crop_align.square_pad(np.asarray(
            Image.open(src).convert("RGB")))
        _, lms = mtcnn.MTCNN(device="cuda").detect_faces(
            Image.fromarray(padded), **MT_SETTINGS["1024px_padded_min100"][1])
        face = int(os.path.splitext(first)[0].rsplit("_", 1)[1])
        lm = lms[face]
        rfw_in = os.path.join(root, "rfw_in")
        os.makedirs(os.path.join(rfw_in, "a"))
        Image.fromarray(padded).save(os.path.join(rfw_in, "a", "p.jpg"),
                                     format="PNG")
        with open(os.path.join(root, "lmk.txt"), "w") as f:
            f.write("a/p.jpg 0 " + " ".join(
                f"{v!r}" for v in np.stack([lm[:5], lm[5:]], 1).ravel()
                .astype(np.float32).tolist()) + "\n")
        rfw_crop_align.main(["--in_dir", rfw_in, "--lmk_file",
                             os.path.join(root, "lmk.txt"), "--out_dir",
                             os.path.join(root, "rfw_out"), "--device",
                             "cuda"])
        pair = [os.path.join(root, "rfw_out", "a", "p.jpg"),
                os.path.join(crops, first)]
        a, b = (np.asarray(Image.open(p), np.int64) for p in pair)
        with open(pair[0], "rb") as fa, open(pair[1], "rb") as fb:
            out["rfw_crop_bytes_equal"] = fa.read() == fb.read()
        lv = out["rfw_crop_mean_levels"] = float(np.abs(a - b).mean())
        if lv > 1.0:
            fail(f"phase 34: rfw_crop_align's crop is {lv} levels from "
                 f"mtcnn_crop_align's on average")
        cfg = dict(json.load(open(STAGE3_CONFIG)), data_root=root,
                   train_subdir="packed", model_root=os.path.join(root, "runs"),
                   name="from_photos", batch_size=S3_BATCH,
                   eval_benchmarks=["rfw_African"])
        with open(os.path.join(root, "cfg.json"), "w") as f:
            json.dump(cfg, f)
        t0 = time.perf_counter()
        train_stage3.main(["--config", os.path.join(root, "cfg.json"),
                           "--packed_dir", packed, "--max_steps", "2",
                           "--device", "cuda"])
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        run = os.path.join(root, "runs", "from_photos")
        ckpts = sorted(f for f in os.listdir(run) if f.startswith("step_"))
        with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        acc = [r["rfw_African_Accuracy"] for r in rows
               if "rfw_African_Accuracy" in r]
        ck = torch.load(os.path.join(run, ckpts[-1]), map_location="cpu",
                        weights_only=True)["backbone"]
        if not ckpts or not acc or not all(
                torch.isfinite(v).all() for v in ck.values()
                if v.is_floating_point()):
            fail(f"phase 34: checkpoints {ckpts}, verification {acc}")
    out.update(photos=PHOTO_IDS * PHOTOS_PER_ID, crops=n, pairs=n_pairs,
               shards=meta["n_shards"], rfw_accuracy=acc,
               launches=check_no_launch("phase 34"))
    log(f"phase 34: {out['photos']} photos -> {n} aligned crops in "
        f"{out['crop_align_s']:.1f} s -> filelist -> {meta['n_shards']} "
        f"shard(s) -> {n_pairs} packed pairs; rfw_crop_align's crop "
        f"{lv:.3f} levels from mtcnn_crop_align's on average (bytes equal: "
        f"{out['rfw_crop_bytes_equal']}); train_stage3 2 steps in "
        f"{out['train_s']:.1f} s, verification accuracy {acc}; launches "
        f"{out['launches']}")
    return out


def loader_rate(make, epochs: int = 1) -> float:
    """images/s of ``make()``'s loader over ``epochs`` epochs (the first
    batch's wait included)."""
    loader = make()
    n = 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        for x, _ in loader:
            n += len(x)
    return n / (time.perf_counter() - t0)


def write_jpegs(root: str, n: int, side: int, seed: int):
    """``n`` seeded JPEGs (quality 95) of ``side``² under 8 identity
    folders: a smooth colour field plus noise, each image its own shift of
    both and its own tint."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:2 * side, 0:2 * side] / side
    base = np.stack([np.sin(4 * xx), np.cos(3 * yy), np.sin(5 * xx * yy)],
                    -1) * 90 + 128
    noise = rng.randint(-20, 21, (2 * side, 2 * side, 3))
    for i in range(n):
        d = os.path.join(root, f"id{i % 8}")
        os.makedirs(d, exist_ok=True)
        oy, ox, ny, nx = rng.randint(0, side, 4)
        arr = base[oy:oy + side, ox:ox + side] \
            + noise[ny:ny + side, nx:nx + side] + rng.randint(-30, 31, 3)
        Image.fromarray(arr.clip(0, 255).astype(np.uint8)).save(
            os.path.join(d, f"{i}.jpg"), quality=95)


def phase_loaders(root: str) -> dict:
    """Phase 35: which C++ loader was built, its batches against the
    Python loader's, and every loader's images/s. Leaves the packed shards
    of the 112² tree at ``root/packed`` for phase 36."""
    reset_launches()
    status = native_loader.status()
    log(f"native_loader: {status}")
    out = {"native_loader": status, "images_per_s": {}}
    rates = out["images_per_s"]
    small, big = os.path.join(root, "jpg112"), os.path.join(root, "jpg512")
    t0 = time.perf_counter()
    write_jpegs(small, LOADER_IMAGES, 112, seed=35)
    write_jpegs(big, LOADER_BIG, 512, seed=36)
    out["write_s"] = time.perf_counter() - t0
    kw = dict(num_workers=LOADER_WORKERS, drop_last=False)
    if status.startswith("built"):
        from PIL import Image
        png = os.path.join(root, "png128")
        rng = np.random.RandomState(37)
        for i in range(64):
            os.makedirs(os.path.join(png, f"id{i % 4}"), exist_ok=True)
            Image.fromarray(rng.randint(0, 256, (128, 128, 3), np.uint8)) \
                .save(os.path.join(png, f"id{i % 4}", f"{i}.png"))
        for path, tol in ((png, 0.0), (small, 1.1 / 255 * 2)):
            ds = FacesDataset(path, 128)
            a, la = next(iter(native_loader.NativeDataLoader(
                ds, len(ds) if path == png else 64, shuffle=False, **kw)))
            b = np.stack([ds.load(i)[0] for i in range(len(a))])
            err = float(np.abs(a - b).max())
            out[f"native_vs_python_{os.path.basename(path)}"] = err
            if err > tol or not np.array_equal(
                    la, [ds.label_of(i) for i in range(len(a))]):
                fail(f"phase 35: native vs Python loader on "
                     f"{os.path.basename(path)}: {err} (tolerance {tol})")
        for name, path, fast in (("native_112_to_128", small, False),
                                 ("native_512_to_128", big, False),
                                 ("native_512_to_128_fast_decode", big,
                                  True)):
            ds = FacesDataset(path, 128)
            rates[name] = loader_rate(lambda: native_loader.NativeDataLoader(
                ds, LOADER_BATCH, fast_decode=fast, **kw))
    else:
        for name in ("native_112_to_128", "native_512_to_128",
                     "native_512_to_128_fast_decode"):
            rates[name] = None
    for name, path in (("python_112_to_128", small),
                       ("python_512_to_128", big)):
        ds = FacesDataset(path, 128)
        rates[name] = loader_rate(lambda: DataLoader(ds, LOADER_BATCH, **kw))
    aug = RandAugment(num_ops=2, seed=35)
    at_112 = FacesDataset(small, 112)
    imgs = [np.rint(at_112.load(i)[0] * 127.5 + 127.5).astype(np.uint8)
            for i in range(RA_IMAGES)]
    t0 = time.perf_counter()
    for im in imgs:
        aug(im)
    rates["randaugment_2ops_one_thread"] = RA_IMAGES / (
        time.perf_counter() - t0)
    ds = FacesDataset(small, 128, transform=aug)
    rates["python_randaugment_112_to_128"] = loader_rate(
        lambda: DataLoader(ds, LOADER_BATCH, **kw))
    packed = os.path.join(root, "packed")
    t0 = time.perf_counter()
    pack_dataset(FacesDataset(small, 128), packed, num_workers=LOADER_WORKERS,
                 progress=False)
    rates["pack_dataset_112_to_128"] = LOADER_IMAGES / (
        time.perf_counter() - t0)
    pds = PackedTrainDataset(packed)
    rates["packed"] = loader_rate(lambda: PackedLoader(pds, LOADER_BATCH),
                                  epochs=3)

    def prefetched():
        n = 0
        for x, _ in device_prefetch(PackedLoader(pds, LOADER_BATCH)):
            n += len(x)
        torch.cuda.synchronize()
        return n

    prefetched()                                          # warm-up
    t0 = time.perf_counter()
    n = sum(prefetched() for _ in range(3))
    rates["packed_device_prefetch"] = n / (time.perf_counter() - t0)
    out["launches"] = check_no_launch("phase 35")
    for k, v in rates.items():
        log(f"phase 35: {k}: " + ("not measured (the C++ loader is "
                                  "unavailable)" if v is None
                                  else f"{v:.1f} images/s"))
    return out


def batch_digest(x: torch.Tensor, y: torch.Tensor) -> str:
    """sha1 of a batch's image and label bytes, read back to the host."""
    h = hashlib.sha1(x.cpu().numpy().tobytes())
    h.update(y.cpu().numpy().astype(np.int32).tobytes())
    return h.hexdigest()


def prefetch_checks(pds) -> dict:
    """Phase 36's checks of device_prefetch at each FEED_DEPTHS depth:
    FEED_STEPS card batches (two epochs of PackedLoader's seed) hash as a
    CPU pass over the same loader does; the pinning runs on the producer
    thread, not the consumer's; an iterator that fails after
    FEED_FAIL_AFTER batches delivers those batches on the card, then
    raises RuntimeError("prefetch producer failed") from its error."""
    want = [batch_digest(torch.from_numpy(x), torch.from_numpy(y))
            for _ in range(FEED_STEPS // FEED_EPOCH)
            for x, y in PackedLoader(pds, LOADER_BATCH)]
    out = {}
    pin = torch.Tensor.pin_memory
    pinned_on = set()

    def pin_recorded(t, *a, **k):
        pinned_on.add(threading.get_ident())
        return pin(t, *a, **k)

    for depth in FEED_DEPTHS:
        def epochs():
            for _ in range(FEED_STEPS // FEED_EPOCH):
                yield from PackedLoader(pds, LOADER_BATCH)

        pinned_on.clear()
        with mock.patch.object(torch.Tensor, "pin_memory", pin_recorded):
            got = [batch_digest(x, y) for x, y in
                   device_prefetch(epochs(), depth=depth)]
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            fail(f"phase 36: depth {depth}: {len(got)} card batches against "
                 f"{len(want)} of the CPU pass, differing at {bad[:5]}")
        if not pinned_on or threading.get_ident() in pinned_on:
            fail(f"phase 36: depth {depth}: pinned on threads {pinned_on}, "
                 f"the consumer is {threading.get_ident()}")

        def failing():
            loader = PackedLoader(pds, LOADER_BATCH)
            yield from itertools.islice(loader, FEED_FAIL_AFTER)
            raise ValueError("injected failure")

        seen, err = [], None
        try:
            for x, y in device_prefetch(failing(), depth=depth):
                if x.device.type != "cuda":
                    fail(f"phase 36: depth {depth}: a batch on {x.device}")
                seen.append(batch_digest(x, y))
        except RuntimeError as e:
            err = e
        if (err is None or str(err) != "prefetch producer failed"
                or not isinstance(err.__cause__, ValueError)
                or seen != want[:FEED_FAIL_AFTER]):
            fail(f"phase 36: depth {depth}: a failure after "
                 f"{FEED_FAIL_AFTER} batches gave {len(seen)} batches "
                 f"(equal: {seen == want[:FEED_FAIL_AFTER]}) and {err!r}")
        out[f"depth{depth}"] = {"batches_equal": len(got),
                                "failure_after": len(seen)}
    log(f"phase 36: device_prefetch at depths {list(FEED_DEPTHS)}: "
        f"{FEED_STEPS} card batches each hash as the CPU pass does, pinned "
        f"on the producer thread; a failure after {FEED_FAIL_AFTER} batches "
        f"delivers them on the card, then RuntimeError('prefetch producer "
        f"failed')")
    return out


def phase_loader_feed(packed: str) -> dict:
    """Phase 36: bf16 batch-256 stage-3 steps fed by PackedLoader +
    device_prefetch at each FEED_DEPTHS depth against the same steps on a
    resident batch, and prefetch_checks. The shards were just written, so
    they sit in the page cache; the timed steps span two epochs and the
    profiled ones one, each with the epoch restarts its share of steps
    brings."""
    reset_launches()
    pds = PackedTrainDataset(packed)
    out = {"checks": prefetch_checks(pds)}

    def batches(depth):
        while True:
            yield from device_prefetch(PackedLoader(pds, LOADER_BATCH),
                                       depth=depth)

    for name in FEED_BACKBONES:
        tr = stage3_trainer("cuda", "bfloat16", backbone=name)
        x, y = (t.cuda() for t in stage3_inputs(LOADER_BATCH, seed=36))
        row = {}
        runs = [("resident", None)] + [(f"loader_fed_depth{d}", d)
                                       for d in FEED_DEPTHS]
        for kind, depth in runs:
            feed = None if depth is None else batches(depth)

            def take():
                return (x, y) if feed is None else next(feed)

            tr.train_step(*take(), 0)                            # warm-up
            torch.cuda.synchronize()
            waits = []          # host seconds spent getting each batch
            t0 = time.perf_counter()
            for i in range(FEED_STEPS):
                tw = time.perf_counter()
                batch = take()
                waits.append(time.perf_counter() - tw)
                m = tr.train_step(*batch, i)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / FEED_STEPS
            if not math.isfinite(m["loss"].item()):
                fail(f"phase 36: {name} {kind}: loss {m['loss'].item()}")
            details = {}

            def steps():
                for i in range(FEED_EPOCH):
                    tr.train_step(*take(), i)

            profile_breakdown(f"phase 36: profile of {FEED_EPOCH} {kind} "
                              f"{name} bf16 batch-{LOADER_BATCH} steps",
                              steps, top=4, details=details)
            row[kind] = {"step_ms": dt * 1e3,
                         "images_per_s": LOADER_BATCH / dt,
                         "host_wait_ms": sum(waits) * 1e3 / FEED_STEPS,
                         # an epoch's first batch waits for a cold pipeline
                         "host_wait_median_ms": float(np.median(waits)) * 1e3,
                         "idle_share": 1 - details["device_ms"]
                         / details["wall_ms"]}
            if feed is not None:
                feed.close()
        out[name] = row
        res = row["resident"]
        log(f"phase 36: {name} bf16 batch {LOADER_BATCH}, {LOADER_IMAGES} "
            f"page-cached images, {FEED_STEPS} steps: resident "
            f"{res['step_ms']:.1f} ms a step (idle {res['idle_share']:.1%})"
            + "".join(
                f"; loader-fed at depth {d} "
                f"{row[f'loader_fed_depth{d}']['step_ms']:.1f} ms (idle "
                f"{row[f'loader_fed_depth{d}']['idle_share']:.1%}, the host "
                f"waited {row[f'loader_fed_depth{d}']['host_wait_ms']:.2f} "
                f"ms a step for its batch, median "
                f"{row[f'loader_fed_depth{d}']['host_wait_median_ms']:.2f})"
                for d in FEED_DEPTHS))
        del tr
        torch.cuda.empty_cache()
    out["launches"] = check_no_launch("phase 36")
    return out


# -- int8 serving and export (phases 37-40) ---------------------------------

SERVE_BATCH, SERVE_CALIB_BATCHES, SERVE_REPS = 256, 4, 5
# exported vs eager: the same operations on the same card; f32 within
# 1e-5 and bf16 within 1e-2 of the output's scale (cuDNN may pick another
# algorithm for a graph than for eager calls)
EXPORT_TOL = {"f32": 1e-5, "bf16": 1e-2}
EXPORT_BATCHES = (8, SERVE_BATCH)
GEN_EXPORT_SIZE, GEN_EXPORT_BATCH = 256, 8


def serving_embedder(seed: int = 37):
    """The recipe's PSpFaceRec (IR-SE-50 at 112, emb 512), seeded weights
    and BatchNorm statistics, eval mode, on the card."""
    model = PSpFaceRec(size=INPUT_SIZE)
    init_weights(model, torch.Generator().manual_seed(seed))
    seeded_batchnorm_(model, seed + 1)
    return model.eval().cuda()


def param_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in
               list(model.parameters()) + list(model.buffers()))


def embed_rate(fn, images: torch.Tensor) -> float:
    """images/s of ``fn`` (a make_embed_fn) on one resident batch: host
    clock around SERVE_REPS calls that end in a synchronize, after a
    warm-up call."""
    fn(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_REPS):
        fn(images)
    torch.cuda.synchronize()
    return SERVE_REPS * images.shape[0] / (time.perf_counter() - t0)


def int8_accumulators_vs_cpu(table, x) -> dict:
    """Card and CPU int32 accumulators of the stem conv (K = 54: the image
    and the average image), a body conv and the output linear on the same
    int8 codes: exactly equal."""
    out = {}
    w = table.entries[0]["w"]
    # the stem's input: the image beside the backbone's average image
    xq, _ = quantize.quantize_act(
        torch.cat([x, torch.zeros_like(x)[:, :w.shape[1] - x.shape[1]]], 1),
        table.entries[0]["x_absmax"])
    card = quantize.int8_conv2d(xq, w, 1, 1)
    cpu = quantize.int8_conv2d(xq.cpu(), w.cpu(), 1, 1)
    if not torch.equal(card.cpu(), cpu):
        fail("phase 37: the stem conv's int32 accumulators differ card vs "
             "CPU")
    out["stem_conv"] = list(card.shape)
    body = next(i for i, (k, e) in enumerate(zip(table.kinds, table.entries))
                if k == "conv2d" and e["w"].shape[1:] == (64, 3, 3))
    g = torch.Generator().manual_seed(38)
    xb = torch.randint(-127, 128, (x.shape[0], 64, 56, 56), generator=g,
                       dtype=torch.int8)
    wb = table.entries[body]["w"]
    card = quantize.int8_conv2d(xb.cuda(), wb, 1, 1)
    if not torch.equal(card.cpu(), quantize.int8_conv2d(xb, wb.cpu(), 1, 1)):
        fail(f"phase 37: conv entry {body}'s int32 accumulators differ card "
             f"vs CPU")
    out[f"conv_entry_{body}"] = list(card.shape)
    lin = table.kinds.index("linear")
    wl = table.entries[lin]["w"]
    xl = torch.randint(-127, 128, (x.shape[0], wl.shape[1]), generator=g,
                       dtype=torch.int8)
    card = quantize.int8_matmul(xl.cuda(), wl.t())
    if not torch.equal(card.cpu(), quantize.int8_matmul(xl, wl.cpu().t())):
        fail("phase 37: the output linear's int32 accumulators differ card "
             "vs CPU")
    out["linear"] = list(card.shape)
    return out


def phase_int8_embed() -> dict:
    """Phase 37: the calibrated int8 embedder. Calibration on
    SERVE_CALIB_BATCHES batches of 8 of phase 14's images, the stripped
    copy's bytes, int8/bf16/f32 embed images/s at SERVE_BATCH through
    make_embed_fn (centre crop, TTA), the cosine of int8 to f32
    embeddings, int32 accumulators card vs CPU, no B1/B1b/B2/B2b
    launch."""
    images, _ = verification_pairs(SERVE_BATCH // 2, seed=37)
    x = torch.from_numpy(images).cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = serving_embedder()
    torch.cuda.synchronize()
    f32_bytes = torch.cuda.memory_allocated() - base
    reset_launches()
    calib = x[:8 * SERVE_CALIB_BATCHES].permute(0, 3, 1, 2)
    t0 = time.perf_counter()
    table = quantize.calibrate_and_quantize(
        model, [calib[i:i + 8] for i in range(0, calib.shape[0], 8)])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    rates, embs = {}, {}
    for dname, cdt in (("f32", "float32"), ("bf16", "bfloat16")):
        fn = make_embed_fn(model, device="cuda", compute_dtype=cdt)
        rates[dname] = embed_rate(fn, x)
        embs[dname] = fn(x).float()
    f32_param_bytes = param_bytes(model)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    lean = quantize.strip_quantized_weights(model, table)
    del model, fn      # fn holds the f32 model too
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    fn8 = make_embed_fn(lean, device="cuda", int8_table=table)
    rates["int8"] = embed_rate(fn8, x)
    embs["int8"] = fn8(x)
    torch.cuda.synchronize()
    launches = check_no_launch("phase 37: int8 embed")
    if not torch.isfinite(embs["int8"]).all():
        fail("phase 37: non-finite int8 embeddings")
    cos = (embs["int8"] * embs["f32"]).sum(1)
    cos_bf16 = (embs["bf16"] * embs["f32"]).sum(1)
    if cos.min().item() < 0.95:
        fail(f"phase 37: int8 to f32 cosine {cos.min().item():.4f} < 0.95")
    acc = int8_accumulators_vs_cpu(table, calib[:8])
    out = {"entries": len(table.entries),
           "kinds": {k: table.kinds.count(k) for k in set(table.kinds)},
           "calibration_s": calib_s,
           "weight_bytes_f32": f32_param_bytes,
           "weight_bytes_int8_table": table.nbytes(),
           "weight_bytes_stripped_model": param_bytes(lean),
           "allocated_bytes_f32_model": f32_bytes,
           "allocated_bytes_freed_by_strip": freed,
           "images_per_s": rates,
           "cos_int8_f32_min": cos.min().item(),
           "cos_int8_f32_mean": cos.mean().item(),
           "cos_bf16_f32_min": cos_bf16.min().item(),
           "accumulators_card_vs_cpu_equal": acc, "launches": launches}
    log(f"phase 37: int8 embedder: {len(table.entries)} entries {out['kinds']}"
        f", calibrated in {calib_s:.2f} s; weights {f32_param_bytes} B f32 -> "
        f"{table.nbytes()} B int8 + {param_bytes(lean)} B kept; the f32 "
        f"model allocated {f32_bytes} B, stripping freed {freed} B; embed "
        f"batch {SERVE_BATCH}: "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
        + f" images/s; cos int8/f32 min {cos.min().item():.5f} mean "
        f"{cos.mean().item():.5f} (bf16/f32 min {cos_bf16.min().item():.5f})"
        f"; int32 accumulators card == CPU at {acc}")
    return out


def phase_int8_inversion() -> dict:
    """Phase 38: int8 ReStyle inversion on phase 3's PSp(256): calibrate
    with calibrate_with over run_on_batch, then the int8 loop at BATCH for
    ITERS iterations; B1/B2 launch as often as in the f32 loop; the image
    error against f32 and the time an iteration takes (host clock around
    the synchronized loop, after a warm-up)."""
    model = build_psp(OUTPUT_SIZE, INPUT_SIZE, seed=0, device="cuda")
    x, avg = (t.cuda() for t in make_inputs(BATCH))
    xc, _ = make_inputs(BATCH, seed=5)
    t0 = time.perf_counter()
    table = quantize.calibrate_with(
        lambda xx, hook: run_on_batch(model, xx, avg, ITERS, quant=hook),
        [xc.cuda()])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    lean = quantize.strip_quantized_weights(model, table)

    def loop(m, quant):
        def run():
            return run_on_batch(m, x, avg, ITERS, quant=None if quant is None
                                else quantize.Int8Apply(table.entries))
        return run

    result = {}
    for name, run in (("f32", loop(model, None)), ("int8", loop(lean, 1))):
        run()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        outs, lats = run()
        torch.cuda.synchronize()
        result[name] = (outs, lats, read_launches(),
                        (time.perf_counter() - t0) * 1e3 / ITERS)
    (fo, fl, fla, fms), (io, il, ila, ims) = result["f32"], result["int8"]
    if ila != fla or fla["bias_act"] != 13 * ITERS or \
            fla["smooth_upsample"] != 12 * ITERS:
        fail(f"phase 38: int8 loop launched {ila}, f32 loop {fla}")
    if not torch.isfinite(io).all():
        fail("phase 38: non-finite int8 inversion")
    err = ((io - fo).abs().amax() / fo.abs().amax()).item()
    mean_err = (io - fo).abs().mean().item()
    lat_err = ((il - fl).abs().amax() / fl.abs().amax()).item()
    kinds = {k: table.kinds.count(k) for k in set(table.kinds)}
    log(f"phase 38: int8 inversion batch {BATCH}, {ITERS} iterations: "
        f"{len(table.entries)} entries {kinds}, calibrated in {calib_s:.2f} "
        f"s; launches {ila} (f32 {fla}); images max err {err:.4f} of the "
        f"range, mean abs {mean_err:.4f}; latents {lat_err:.4f}; ms an "
        f"iteration int8 {ims:.2f}, f32 {fms:.2f}")
    return {"entries": len(table.entries), "kinds": kinds,
            "calibration_s": calib_s, "launches": ila, "launches_f32": fla,
            "image_max_err_rel": err, "image_mean_abs_err": mean_err,
            "latent_max_err_rel": lat_err, "ms_per_iteration_int8": ims,
            "ms_per_iteration_f32": fms}


def phase_export_embedder(root: str) -> dict:
    """Phase 39: the recipe's PSpFaceRec exported in f32 and bf16 with a
    symbolic batch, saved, loaded and run at EXPORT_BATCHES against the
    eager model of the same dtype; no B1/B1b/B2/B2b launch."""
    model = serving_embedder()
    images, _ = verification_pairs(SERVE_BATCH // 2, seed=39)
    x = torch.from_numpy(images).cuda()
    out = {}
    reset_launches()
    for dname, dtype in DTYPES.items():
        path = os.path.join(root, f"embedder_{dname}")
        t0 = time.perf_counter()
        ep = export_utils.export_embedder(model, dtype=dtype, device="cuda")
        export_s = time.perf_counter() - t0
        export_utils.save_exported(ep, path, fn_name="embedder")
        run = export_utils.load_exported(path).module()
        eager = copy.deepcopy(model).to(dtype)
        row = {"export_s": export_s,
               "artifact_bytes": os.path.getsize(
                   os.path.join(path, export_utils.ARTIFACT))}
        with torch.no_grad():
            for b in EXPORT_BATCHES:
                xb = x[:b].to(dtype)
                got = run(xb).float()
                want = eager(xb.permute(0, 3, 1, 2)).float()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                if not (torch.isfinite(got).all()
                        and err <= EXPORT_TOL[dname] * scale):
                    fail(f"phase 39: exported {dname} embedder at batch {b}:"
                         f" max err {err:.3e} > {EXPORT_TOL[dname]} x "
                         f"{scale:.3e}")
                row[f"max_abs_err_batch{b}"] = err
            xb = x.to(dtype)
            row["ms_exported"] = cuda_time_ms(lambda: run(xb), reps=5,
                                              warmup=1)
            row["ms_eager"] = cuda_time_ms(
                lambda: eager(xb.permute(0, 3, 1, 2)), reps=5, warmup=1)
        out[dname] = row
        log(f"phase 39: exported {dname} embedder in {export_s:.2f} s "
            f"({row['artifact_bytes']} B): "
            + ", ".join(f"batch {b} max err {row[f'max_abs_err_batch{b}']:.2e}"
                        for b in EXPORT_BATCHES)
            + f"; batch {SERVE_BATCH} {row['ms_exported']:.2f} ms exported, "
            f"{row['ms_eager']:.2f} ms eager")
        del eager, run, ep
    out["launches"] = check_no_launch("phase 39: exported embedder")
    return out


def phase_export_generator(root: str) -> dict:
    """Phase 40: a seeded StyleGAN2-ADA G (GEN_EXPORT_SIZE², z 512) saved
    as a torch ADA .pt, exported by tools/export_model.py, loaded: the
    graph holds the B1/B2 custom ops, the output equals eager bit for bit
    and B1/B2 launch as often as eager's."""
    g = Generator(z_dim=512, img_resolution=GEN_EXPORT_SIZE)
    init_weights(g, torch.Generator().manual_seed(40))
    pt = os.path.join(root, "g.pt")
    torch.save({"state_dict": {f"G.{k}": v for k, v in
                               g.state_dict().items()}}, pt)
    path = os.path.join(root, "generator")
    t0 = time.perf_counter()
    export_model.main(["--kind", "generator", "--checkpoint", pt, "--out",
                       path, "--img_resolution", str(GEN_EXPORT_SIZE),
                       "--device", "cuda"])
    export_s = time.perf_counter() - t0
    ep = export_utils.load_exported(path)
    nodes = {}
    for n in ep.graph.nodes:
        if n.op == "call_function" and str(n.target).startswith("sgfr."):
            nodes[str(n.target)] = nodes.get(str(n.target), 0) + 1
    if not (nodes.get("sgfr.bias_act.default")
            and nodes.get("sgfr.smooth_upsample.default")):
        fail(f"phase 40: the exported graph lacks the kernels' ops: {nodes}")
    run = ep.module()
    g = g.cuda().eval()
    z = torch.randn((GEN_EXPORT_BATCH, 512),
                    generator=torch.Generator().manual_seed(41)).cuda()
    with torch.no_grad():
        reset_launches()
        want = g(z, noise_mode="const").permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        eager_launches = read_launches()
        reset_launches()
        got = run(z)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != eager_launches or not launches["bias_act"] \
                or not launches["smooth_upsample"]:
            fail(f"phase 40: exported launches {launches}, eager "
                 f"{eager_launches}")
        if not torch.equal(got, want):
            fail(f"phase 40: exported generator differs from eager by "
                 f"{(got - want).abs().max().item():.3e}")
        ms_exported = cuda_time_ms(lambda: run(z), reps=5, warmup=1)
        ms_eager = cuda_time_ms(lambda: g(z, noise_mode="const"), reps=5,
                                warmup=1)
    with open(os.path.join(path, export_utils.SIDECAR)) as f:
        sidecar = json.load(f)
    log(f"phase 40: export_model generator {GEN_EXPORT_SIZE}² in "
        f"{export_s:.2f} s, custom-op nodes {nodes}; bit-equal to eager at "
        f"batch {GEN_EXPORT_BATCH}; launches {launches} (eager "
        f"{eager_launches}); {ms_exported:.2f} ms exported, {ms_eager:.2f} "
        f"ms eager; sidecar {sidecar['in_avals']} -> {sidecar['out_avals']}")
    return {"export_s": export_s, "graph_nodes": nodes, "launches": launches,
            "launches_eager": eager_launches, "bit_equal": True,
            "ms_exported": ms_exported, "ms_eager": ms_eager,
            "sidecar": {k: sidecar[k] for k in ("fn_name", "platforms",
                                                "in_avals", "out_avals")}}


def op_dispatch_us(calls: int = 2000) -> dict:
    """Host µs a call of B1 at a small shape through the custom op
    (``bias_act``: dispatcher, autograd registration, the CUDA
    implementation) and through the CUDA implementation called directly,
    in turns op, direct, direct, op; host clock over ``calls`` calls that
    end in a synchronize. The difference is what registering the kernels
    as ops costs each launch."""
    x = torch.randn((8, 512, 4, 4), device="cuda")
    b = torch.zeros(512, device="cuda")
    runs = {"op": lambda: bias_act(x, b, clamp=256.0),
            "direct": lambda: fused_act._bias_act_cuda(x, b, "lrelu", 1.0,
                                                       256.0)}
    out = {"op": [], "direct": []}
    with torch.no_grad():
        for name in ("op", "direct", "direct", "op"):
            fn = runs[name]
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) * 1e6 / calls)
    return out


def phase_serving() -> dict:
    """Phases 37-40."""
    serving = {"int8_embed": phase_int8_embed(),
               "int8_inversion": phase_int8_inversion()}
    with tempfile.TemporaryDirectory() as root:
        serving["export_embedder"] = phase_export_embedder(root)
        serving["export_generator"] = phase_export_generator(root)
    serving["op_dispatch_us"] = op_dispatch_us()
    log(f"phase 40: host µs a B1 call at (8, 512, 4, 4): custom op "
        f"{serving['op_dispatch_us']['op']}, its CUDA implementation "
        f"called directly {serving['op_dispatch_us']['direct']}")
    return serving

# -- phases 41-44: the convergence run and data parallelism ----------------

# phase 41's steps: the first 50-step mark at which the pass rule held in
# the full 3000-step run of the tool, x 1.5, rounded up to 100 (PERF.md)
CONV_STEPS = 300
DDP_BATCH, DDP_TIMED = 256, 5
# phase 43: stage 3 at (data 2, model 1) and (1, 2) in f32 and at (1, 2)
# in the recipe's bf16 (the class shards round the cosine's operands),
# stage 1's R1 + path-length iteration, one e4e iteration, and phase 44's
# data-2 export, each one step at the recipes' widths; phase 12's
# tolerances
MP_TASKS = ("stage3:2x1", "stage3:1x2", "stage3_bf16:1x2", "stage1:2x1",
            "e4e:2x1", "export:2x1")
MP_LOSS_RTOL, MP_REL = 1e-3, CPU_UPDATE_TOL
MP_ADAM_FLOOR, MP_ADAM_REL = 1e-4, 1e-3      # phase 16's Adam rule
EXPORT_SHARDED_TOL = 1e-5


def phase_convergence() -> dict:
    """Phase 41: the port's convergence tool in-process at its defaults
    (IR-SE-50 at 112, 512 ids x 40 synthesized, bf16 batch 256) for
    CONV_STEPS steps; the tool's pass rule must hold; no launch."""
    reset_launches()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        rc = convergence_run.main(["--steps", str(CONV_STEPS), "--out",
                                   root, "--device", "cuda"])
        seconds = time.perf_counter() - t0
        with open(os.path.join(root, "train.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    summary = rows[-1]["summary"]
    launches = check_no_launch("phase 41: convergence run")
    if rc != 0:
        fail(f"phase 41: the pass rule failed at {CONV_STEPS} steps: "
             f"{summary}")
    log(f"phase 41: {CONV_STEPS} steps in {seconds:.1f} s: loss "
        f"{summary['loss_first50']} -> {summary['loss_last50']}, top-1 "
        f"{summary['top1_last50']} ({summary['top1_last50'] / summary['chance']:.0f}x "
        f"chance), {summary['imgs_per_sec_e2e']} images/s end to end")
    return {"steps": CONV_STEPS, "seconds": seconds, "summary": summary,
            "curve": rows[:-1], "launches": launches}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def max_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in f32 ulps (0: bit-equal)."""
    if torch.equal(a, b):
        return 0
    return int((a.float().view(torch.int32).long()
                - b.float().view(torch.int32).long()).abs().max())


def timed_steps(trainer, x, y, reps: int = DDP_TIMED) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        trainer.train_step(x, y, i + 1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_ddp_world1():
    """Phase 42: initialize_distributed_from_env with torchrun's variables
    set (world 1), then a bf16 batch-256 recipe step of Stage3Trainer with
    make_mesh(1, 1) (NCCL for the CUDA tensors) against the plain trainer
    from the same seed: loss, parameters and BatchNorm statistics equal
    (4 ulps at most); ms a step of each. Returns (numbers, mesh)."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        multi = mesh_lib.initialize_distributed_from_env()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    backend = str(dist.get_backend())
    if multi or dist.get_world_size() != 1 or "nccl" not in backend:
        fail(f"phase 42: init from the torchrun variables gave world "
             f"{dist.get_world_size()}, backend {backend}")
    mesh = mesh_lib.make_mesh(1, 1)
    x, y = (t.cuda() for t in stage3_inputs(DDP_BATCH, seed=42))
    plain = stage3_trainer("cuda", "bfloat16")
    ddp = stage3_trainer("cuda", "bfloat16", mesh=mesh)
    reset_launches()
    lp = plain.train_step(x, y, 0)["loss"]
    ld = ddp.train_step(x, y, 0)["loss"]
    launches = check_no_launch("phase 42: world-1 data-parallel step")
    ulps = {"loss": max_ulps(lp, ld)}
    for (k, a), (_, b) in zip(plain.named_parameters(),
                              ddp.named_parameters()):
        ulps[k] = max_ulps(a.detach(), b.detach())
    for (k, a), (_, b) in zip(plain.backbone.named_buffers(),
                              ddp.backbone.named_buffers()):
        if a.is_floating_point():
            ulps[k] = max_ulps(a, b)
        elif not torch.equal(a, b):
            fail(f"phase 42: buffer {k} differs")
    worst = max(ulps.values())
    if worst > 4:
        fail(f"phase 42: the world-1 step differs from the plain one by "
             f"{worst} ulps at {max(ulps, key=ulps.get)}")
    ms = {"plain": [], "ddp": []}
    for name, tr in (("plain", plain), ("ddp", ddp), ("ddp", ddp),
                     ("plain", plain)):
        ms[name].append(timed_steps(tr, x, y))
    del plain, ddp
    torch.cuda.empty_cache()
    overhead = sum(ms["ddp"]) / sum(ms["plain"]) - 1
    log(f"phase 42: backend {backend}, world 1: loss {float(lp):.6f}, "
        f"{sum(v == 0 for v in ulps.values())} of {len(ulps)} tensors "
        f"bit-equal, worst {worst} ulps; ms a bf16 batch-{DDP_BATCH} step: "
        f"plain {ms['plain']}, data-parallel {ms['ddp']} "
        f"({100 * overhead:+.2f} %)")
    return {"backend": backend, "loss": float(lp), "max_ulps": worst,
            "bit_equal": worst == 0, "ms_plain": ms["plain"],
            "ms_ddp": ms["ddp"], "overhead": overhead,
            "launches": launches}, mesh


def phase_two_ranks(root: str):
    """Phase 43: two worker processes on cuda:0 joined by gloo (NCCL
    takes one rank a device), each stepping its half of the global batch
    at the recipes' widths: MP_TASKS, one step each, held against one
    process stepping the whole batch on the card at phase 12's
    tolerances (rank 0 steps the one process and compares; every rank
    ends bit-equal to rank 0); each rank's B1/B1b/B2/B2b launches as the
    one process's (stage 1: S1_LAUNCHES' R1 D step + path-length G step;
    e4e: E4E_ENC_LAUNCHES; stage 3: 0). Returns (numbers, the ranks'
    results)."""
    t0 = time.perf_counter()
    res = mp_worker.spawn(MP_TASKS, 2, root, device="cuda:0", size="full",
                          backend="gloo", steps=1,
                          tol=(MP_LOSS_RTOL, MP_REL, MP_ADAM_FLOOR,
                               MP_ADAM_REL), timeout=900)
    spawn_s = time.perf_counter() - t0
    with open(os.path.join(root, "rank0.log")) as f:
        head = f.readline().strip()
    if "backend gloo" not in head or "cuda:0" not in head:
        fail(f"phase 43: unexpected worker start: {head}")
    d1, g1 = S1_LAUNCHES[("d_step", True)], S1_LAUNCHES[("g_step", True)]
    expect = {"stage3": dict.fromkeys(KERNELS, 0),
              "stage3_bf16": dict.fromkeys(KERNELS, 0),
              "stage1": [dict(zip(KERNELS, (a + b for a, b in zip(d1, g1))))],
              "e4e": [E4E_ENC_LAUNCHES]}
    out = {"backend": "gloo", "device": "cuda:0", "spawn_s": spawn_s}
    for spec in MP_TASKS[:-1]:
        name = spec.split(":")[0]
        first = res[0][spec]
        if first["bad"]:
            fail(f"phase 43: {spec} rank 0 against one process: "
                 + "; ".join(first["bad"][:5]))
        for rank, r in enumerate(res):
            got = r[spec]
            if got["digest"] != first["digest"]:
                fail(f"phase 43: {spec} rank {rank} ends unlike rank 0")
            if got["launches"] != expect[name] or \
                    got["launches"] != first["launches_one_process"]:
                fail(f"phase 43: {spec} rank {rank} launches "
                     f"{got['launches']}, expected {expect[name]} (one "
                     f"process: {first['launches_one_process']})")
        out[spec] = {"launches_one_process": first["launches_one_process"],
                     "ranks": [{"launches": r[spec]["launches"],
                                "seconds": r[spec]["seconds"]}
                               for r in res]}
        log(f"phase 43: {spec} two ranks on cuda:0 (gloo) equal one process"
            f"; per-rank launches {first['launches']}")
    return out, res


def phase_sharded_export(mesh, ranks) -> dict:
    """Phase 44: export_embedder_sharded at data 1 (phase 42's mesh) and,
    through phase 43's ranks, data 2, against export_embedder on the
    whole batch (IR-SE-50 at 112, seeded BatchNorm statistics, 8 images,
    f32)."""
    model, side = mp_worker.export_backbone("full")
    images = mp_worker.export_images(side).cuda()
    reset_launches()
    with torch.no_grad():
        want = export_utils.export_embedder(
            model, image_size=side, device="cuda").module()(images)
        prog = export_utils.export_embedder_sharded(model, mesh,
                                                    image_size=side,
                                                    device="cuda")
        got = export_utils.run_sharded(prog, images, mesh)
    launches = check_no_launch("phase 44: sharded export")
    scale = float(want.abs().max())
    errs = {"data1": float((got - want).abs().max())}
    for rank, r in enumerate(ranks):
        errs[f"data2_rank{rank}"] = float(
            (r["export:2x1"]["emb"] - want.cpu()).abs().max())
    for k, e in errs.items():
        if not e <= EXPORT_SHARDED_TOL * scale:
            fail(f"phase 44: sharded export {k}: max err {e:.3e} > "
                 f"{EXPORT_SHARDED_TOL} x {scale:.3e}")
    log(f"phase 44: sharded export against export_embedder: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (scale {scale:.3f})")
    return {"max_abs_err": errs, "scale": scale, "launches": launches}


def phase_parallel() -> dict:
    """Phases 41-44."""
    t0 = time.perf_counter()
    out = {"convergence": phase_convergence()}
    out["ddp_world1"], mesh = phase_ddp_world1()
    with tempfile.TemporaryDirectory() as root:
        out["two_ranks"], ranks = phase_two_ranks(root)
    out["sharded_export"] = phase_sharded_export(mesh, ranks)
    dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    log(f"phases 41-44 in {out['seconds']:.1f} s")
    return out


def parallel_launches(par: dict) -> dict:
    """Per kernel: phase 41's and 42's launches (each checked to be 0) and
    one rank's per-step launches of phase 43's stage 1 and e4e."""
    two = par["two_ranks"]
    return {k: {"convergence": par["convergence"]["launches"][k],
                "ddp_stage3": par["ddp_world1"]["launches"][k],
                "two_rank_stage3": two["stage3:2x1"]["ranks"][0][
                    "launches"][k],
                "two_rank_stage1": two["stage1:2x1"]["ranks"][0][
                    "launches"][0][k],
                "two_rank_e4e": two["e4e:2x1"]["ranks"][0]["launches"][0][k]}
            for k in KERNELS}


def parallel_main():
    """``--parallel``: the kernels' build and phases 41-44 alone."""
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    par = phase_parallel()
    print(json.dumps({"parallel": par, "launches": parallel_launches(par)}))
    print(nvidia_smi_line())



# -- phases 45-46: spatially sharded synthesis and the stage-3 sweep --------

# f32: a rank's band within this of the one-process image's largest
# magnitude (cuDNN may take other algorithms on a band's shapes)
SPATIAL_TOL = 1e-4
SPATIAL_TASK = "spatial:2x1"
TUNE_ARGS = ("--batches", "128", "256", "--remat", "0", "1", "--dtypes",
             "bfloat16", "--model", "IR_SE_50", "--device", "cuda")


def phase_spatial(root: str) -> dict:
    """Phase 45: two worker processes on cuda:0 joined by gloo run every
    ``_mp_worker.SPATIAL_RUNS["full"]`` run through make_spatial_synthesis
    over the data axis (each rank half the rows); this process runs each
    whole. A rank's f32 band must equal its rows of the one-process image
    within SPATIAL_TOL of scale (bf16: measured), its B1/B1b/B2/B2b
    launches the one process's, the gathered image its band; each rank's
    ms a call and peak GiB above the weights beside the one process's."""
    t0 = time.perf_counter()
    ranks = mp_worker.spawn([SPATIAL_TASK], 2, root, device="cuda:0",
                            size="full", backend="gloo", timeout=900)
    spawn_s = time.perf_counter() - t0
    with open(os.path.join(root, "rank0.log")) as f:
        head = f.readline().strip()
    if "backend gloo" not in head or "cuda:0" not in head:
        fail(f"phase 45: unexpected worker start: {head}")
    torch.cuda.empty_cache()
    one = mp_worker.run_task("spatial", None, size="full", device="cuda")
    out = {"backend": "gloo", "device": "cuda:0", "spawn_s": spawn_s,
           "runs": {}}
    for name, family, res, batch, dtype, noise, _ in \
            mp_worker.SPATIAL_RUNS["full"]:
        want = one[name]
        scale = float(want["image"].float().abs().max())
        if not math.isfinite(scale) or scale == 0:
            fail(f"phase 45: {name}: one-process image scale {scale}")
        row = {"family": family, "resolution": res, "batch": batch,
               "dtype": dtype, "noise": noise, "scale": scale,
               "launches_one_process": want["launches"],
               "ms_one_process": want["ms"],
               "peak_gib_one_process": want["peak_gib"], "ranks": []}
        if dtype != "float32":
            # how far this dtype's one process is from its f32 one: the
            # scale of the bands' differences
            f32 = one[name.replace("_bf16_", "_f32_")]
            row["one_process_vs_f32_rel_err"] = float(
                (want["image"].float() - f32["image"]).abs().max()) / scale
        if want["launches"]["bias_act"] == 0 or (
                family != "rosinality"
                and want["launches"]["smooth_upsample"] == 0):
            fail(f"phase 45: {name}: the one process launched "
                 f"{want['launches']}")
        for rank, r in enumerate(ranks):
            got = r[SPATIAL_TASK][name]
            lo, hi = got["rows"]
            err = float((got["image"].float()
                         - want["image"][:, :, lo:hi].float()).abs().max())
            row["ranks"].append({"rows": [lo, hi], "max_abs_err": err,
                                 "rel_err": err / scale,
                                 "launches": got["launches"],
                                 "ms": got["ms"],
                                 "peak_gib": got["peak_gib"]})
            if got["launches"] != want["launches"]:
                fail(f"phase 45: {name} rank {rank} launches "
                     f"{got['launches']}, one process {want['launches']}")
            if not got["gather_ok"]:
                fail(f"phase 45: {name} rank {rank}: the gathered image "
                     f"does not hold the rank's band")
            if dtype == "float32" and not err <= SPATIAL_TOL * scale:
                fail(f"phase 45: {name} rank {rank} rows {lo}-{hi}: max "
                     f"err {err:.3e} > {SPATIAL_TOL} x {scale:.3e}")
        out["runs"][name] = row
        log(f"phase 45: {name} ({family} {res}², batch {batch}, {dtype}, "
            f"{noise} noise): rank errors "
            + ", ".join(f"{q['rel_err']:.2e}" for q in row["ranks"])
            + f" of scale; ms one process {want['ms']:.2f}, ranks "
            + ", ".join(f"{q['ms']:.2f}" for q in row["ranks"])
            + f"; peak GiB one process {want['peak_gib']:.3f}, ranks "
            + ", ".join(f"{q['peak_gib']:.3f}" for q in row["ranks"])
            + f"; launches a rank {want['launches']}"
            + (f"; one process against its f32 run "
               f"{row['one_process_vs_f32_rel_err']:.2e} of scale"
               if dtype != "float32" else ""))
    return out


def phase_tune() -> dict:
    """Phase 46: the port's tools/tune_stage3.py on the card, IR_SE_50 at
    bf16, batches 128 and 256, remat off and on: no error row, MFU in (0,
    1], remat slower than no remat at each batch, no B1/B1b/B2/B2b
    launch."""
    reset_launches()
    with tempfile.TemporaryDirectory() as root:
        rows = tune_stage3.main(list(TUNE_ARGS) + [
            "--out", os.path.join(root, "tune.md")])
    launches = check_no_launch("phase 46: stage-3 sweep")
    for r in rows:
        if "error" in r or not 0 < r["mfu"] <= 1:
            fail(f"phase 46: bad row {r}")
    ms = {(r["batch"], r["remat"]): r["step_ms"] for r in rows}
    for b in sorted({r["batch"] for r in rows}):
        if not ms[(b, True)] > ms[(b, False)]:
            fail(f"phase 46: remat at batch {b} took {ms[(b, True)]:.2f} ms "
                 f"against {ms[(b, False)]:.2f} without")
    for r in rows:
        log(f"phase 46: IR_SE_50 bf16 batch {r['batch']} remat "
            f"{int(r['remat'])}: {r['step_ms']:.2f} ms a step, "
            f"{r['imgs_per_sec']:.1f} images/s, {r['tflops_per_step']:.3f} "
            f"TFLOP a step, mfu {r['mfu']:.4f}")
    return {"rows": rows, "launches": launches}


def phase_spatial_tune() -> dict:
    """Phases 45-46."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        out = {"spatial": phase_spatial(root)}
    torch.cuda.empty_cache()
    out["tune"] = phase_tune()
    out["seconds"] = time.perf_counter() - t0
    log(f"phases 45-46 in {out['seconds']:.1f} s")
    return out


def spatial_launches(st: dict) -> dict:
    """Rank 0's launches summed over phase 45's runs, per kernel."""
    runs = st["spatial"]["runs"].values()
    return {k: sum(r["ranks"][0]["launches"][k] for r in runs)
            for k in KERNELS}


def spatial_main():
    """``--spatial``: the kernels' build and phases 45-46 alone."""
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    st = phase_spatial_tune()
    print(json.dumps({"spatial_tune": st, "launches_spatial":
                      spatial_launches(st)}))
    print(nvidia_smi_line())


# -- the last slice (phase 47) ------------------------------------------------

AUG_BATCH, AUG_IMAGES, AUG_SIZE, AUG_CROP = 256, 4096, 128, 112
AUG_FLIP_TOL = 0.05                     # the flip share within 0.5 +- this
MODCONV_SIZES = (4, 8, 16, 32, 64, 128, 256)
MODCONV_BATCH, MODCONV_WIDTH = 8, 512
# the scaled-activation form against the per-sample-weight oracle, f32
# with TF32 off: the same products summed in another order
MODCONV_TOL = 1e-5


def augment_check(dtype) -> dict:
    """device_augment on the card over AUG_IMAGES images of AUG_SIZE² in
    batches of AUG_BATCH: each output equals a window of its own input,
    flipped or not, exactly. A batch runs twice from one generator seed:
    on images whose pixels hold their row and column, which give each
    image's offsets and flip, then on random images, which must equal
    those windows."""
    n, span = AUG_BATCH, AUG_SIZE - AUG_CROP + 1
    idx = torch.arange(AUG_SIZE, device="cuda")
    coded = torch.stack([idx[:, None].expand(AUG_SIZE, AUG_SIZE),
                         idx[None, :].expand(AUG_SIZE, AUG_SIZE),
                         torch.zeros(AUG_SIZE, AUG_SIZE, dtype=idx.dtype,
                                     device="cuda")], -1)
    coded = coded.expand(n, -1, -1, -1).to(dtype).contiguous()
    gen, data_gen = (torch.Generator(device="cuda") for _ in range(2))
    data_gen.manual_seed(470)
    dys, dxs, flips = [], [], []
    win = torch.arange(AUG_CROP, device="cuda")
    rows = torch.arange(n, device="cuda")[:, None, None]
    for b in range(AUG_IMAGES // n):
        gen.manual_seed(4700 + b)
        got = device_augment(coded, gen, AUG_CROP)
        dy = got[:, 0, 0, 0].long()
        left, right = got[:, 0, 0, 1].long(), got[:, 0, -1, 1].long()
        flip = left > right
        dx = torch.minimum(left, right)
        ys = dy[:, None] + win
        xs = dx[:, None] + win
        xs = torch.where(flip[:, None], xs.flip(1), xs)
        if not torch.equal(got, coded[rows, ys[:, :, None], xs[:, None, :]]):
            fail(f"phase 47: device_augment {dtype}: an output is no "
                 f"window of its coded input")
        images = torch.randint(0, 256, (n, AUG_SIZE, AUG_SIZE, 3),
                               generator=data_gen, device="cuda").to(dtype)
        gen.manual_seed(4700 + b)
        got = device_augment(images, gen, AUG_CROP)
        if not torch.equal(got, images[rows, ys[:, :, None],
                                       xs[:, None, :]]):
            fail(f"phase 47: device_augment {dtype}: batch {b} is not the "
                 f"windows its draws give")
        dys.append(dy)
        dxs.append(dx)
        flips.append(flip)
    dy, dx, flip = (torch.cat(t).cpu() for t in (dys, dxs, flips))
    share = flip.float().mean().item()
    seen = (sorted(set(dy.tolist())), sorted(set(dx.tolist())))
    if seen != (list(range(span)), list(range(span))) or \
            abs(share - 0.5) > AUG_FLIP_TOL:
        fail(f"phase 47: device_augment {dtype}: offsets {seen}, flip "
             f"share {share}")
    ms = cuda_time_ms(lambda: device_augment(images, gen, AUG_CROP), reps=20)
    return {"images": len(dy), "offsets_seen": span, "flip_share": share,
            "ms": ms}


def modconv_check() -> dict:
    """modulated_conv2d against modulated_conv2d_grouped at the ADA G's
    widths (MODCONV_WIDTH -> MODCONV_WIDTH, 3x3, demodulated, batch
    MODCONV_BATCH) at each MODCONV_SIZES resolution: f32 (TF32 off)
    within MODCONV_TOL of the oracle's scale, bf16 measured against it."""
    g = torch.Generator(device="cuda").manual_seed(471)
    c = MODCONV_WIDTH
    w = torch.randn(c, c, 3, 3, generator=g, device="cuda")
    out = {}
    for size in MODCONV_SIZES:
        x = torch.randn(MODCONV_BATCH, c, size, size, generator=g,
                        device="cuda")
        styles = torch.rand(MODCONV_BATCH, c, generator=g,
                            device="cuda") * 1.5 + 0.25
        with torch.no_grad():
            want = modulated_conv2d_grouped(x, w, styles, padding=1)
            got = modulated_conv2d(x, w, styles, padding=1)
            got16 = modulated_conv2d(x.bfloat16(), w, styles, padding=1)
        scale = want.abs().max()
        err = ((got - want).abs().max() / scale).item()
        err16 = ((got16.float() - want).abs().max() / scale).item()
        if not err <= MODCONV_TOL:
            fail(f"phase 47: modulated_conv2d at {size}² is {err:.3e} of "
                 f"scale from the grouped oracle (tolerance {MODCONV_TOL})")
        out[size] = {"f32_rel_err": err, "bf16_rel_err": err16}
        del x, want, got, got16
    x = torch.randn(MODCONV_BATCH, c, MODCONV_SIZES[-1], MODCONV_SIZES[-1],
                    generator=g, device="cuda")
    with torch.no_grad():
        out["ms_at_largest"] = {
            "scaled": cuda_time_ms(lambda: modulated_conv2d(
                x, w, styles, padding=1), reps=5, warmup=1),
            "grouped": cuda_time_ms(lambda: modulated_conv2d_grouped(
                x, w, styles, padding=1), reps=5, warmup=1)}
    return out


def export_jittable_check() -> dict:
    """export_jittable of a plain function that calls a seeded 256² ADA G
    (its tensors become the program's constants): bit-equal to eager at
    batch GEN_EXPORT_BATCH, with B1/B2 launched as often as eager's."""
    g = Generator(z_dim=512, img_resolution=GEN_EXPORT_SIZE)
    init_weights(g, torch.Generator().manual_seed(472))
    g = g.cuda().eval()

    def synthesize(z):
        return g(z, noise_mode="const").permute(0, 2, 3, 1)

    z = torch.randn((GEN_EXPORT_BATCH, 512),
                    generator=torch.Generator().manual_seed(473)).cuda()
    t0 = time.perf_counter()
    run = export_utils.export_jittable(synthesize, (z,)).module()
    export_s = time.perf_counter() - t0
    with torch.no_grad():
        reset_launches()
        want = synthesize(z)
        torch.cuda.synchronize()
        eager = read_launches()
        reset_launches()
        got = run(z)
        torch.cuda.synchronize()
        launches = read_launches()
    if launches != eager or not launches["bias_act"] \
            or not launches["smooth_upsample"]:
        fail(f"phase 47: export_jittable launches {launches}, eager {eager}")
    if not torch.equal(got, want):
        fail(f"phase 47: export_jittable's program differs from eager by "
             f"{(got - want).abs().max().item():.3e}")
    return {"export_s": export_s, "launches": launches,
            "launches_eager": eager, "bit_equal": True}


def phase_last_slice() -> dict:
    """Phase 47: device_augment (uint8 and bf16), modulated_conv2d against
    its grouped oracle, export_jittable of the generator, and test_rfw
    on phase 32's run directory, which must give phase 32's result on its
    newest checkpoint file."""
    t0 = time.perf_counter()
    reset_launches()
    out = {"device_augment": {d: augment_check(t) for d, t in
                              (("uint8", torch.uint8),
                               ("bf16", torch.bfloat16))},
           "modconv": modconv_check()}
    check_no_launch("phase 47: device_augment and modconv")
    out["export_jittable"] = export_jittable_check()
    reset_launches()
    rfw = test_rfw.main(["--checkpoint", HANDOFF["run"], "--data_root",
                         HANDOFF["data_root"], "--benchmarks", "rfw_African",
                         "--device", "cuda"])
    check_no_launch("phase 47: test_rfw")
    if rfw != HANDOFF["rfw"]:
        fail(f"phase 47: test_rfw on phase 32's run directory gave {rfw}, "
             f"on its newest checkpoint {HANDOFF['rfw']}")
    out["test_rfw_run_dir"] = rfw
    HANDOFF.pop("tmp").cleanup()
    out["seconds"] = time.perf_counter() - t0
    for d, r in out["device_augment"].items():
        log(f"phase 47: device_augment {d} batch {AUG_BATCH}, {AUG_SIZE}² -> "
            f"{AUG_CROP}: {r['images']} images each a window of its input, "
            f"all {r['offsets_seen']} offsets a side seen, flip share "
            f"{r['flip_share']:.4f}; {r['ms']:.3f} ms a call")
    mc = out["modconv"]
    log(f"phase 47: modulated_conv2d vs the grouped oracle, {MODCONV_WIDTH} "
        f"-> {MODCONV_WIDTH}, batch {MODCONV_BATCH}, of scale: "
        + ", ".join(f"{s}² f32 {mc[s]['f32_rel_err']:.2e} bf16 "
                    f"{mc[s]['bf16_rel_err']:.2e}" for s in MODCONV_SIZES)
        + f"; at {MODCONV_SIZES[-1]}² {mc['ms_at_largest']['scaled']:.2f} ms "
        f"scaled, {mc['ms_at_largest']['grouped']:.2f} ms grouped (f32)")
    ej = out["export_jittable"]
    log(f"phase 47: export_jittable of a function calling the "
        f"{GEN_EXPORT_SIZE}² G in {ej['export_s']:.2f} s, bit-equal to "
        f"eager, launches {ej['launches']}; test_rfw on phase 32's run "
        f"directory {rfw}, as on its checkpoint file; phase 47 in "
        f"{out['seconds']:.1f} s")
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
    host = {"mtcnn": phase_mtcnn(), "clis": phase_data_clis()}
    with tempfile.TemporaryDirectory() as root:
        host["loaders"] = phase_loaders(root)
        host["feed"] = phase_loader_feed(os.path.join(root, "packed"))
    t_serving = time.perf_counter()
    serving = phase_serving()
    log(f"phases 37-40 in {time.perf_counter() - t_serving:.1f} s")
    parallel = phase_parallel()
    par_launches = parallel_launches(parallel)
    spatial_tune = phase_spatial_tune()
    sp_launches = spatial_launches(spatial_tune)
    last = phase_last_slice()
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
            # phases 33-36: each checked to be 0
            "launches_host_data": sum(v["launches"][name]
                                      for v in host.values()),
            # phases 37-40: int8 embed and the exported embedder checked
            # to be 0; int8 inversion and the exported generator equal to
            # their f32 / eager runs
            "launches_int8_embed": serving["int8_embed"]["launches"][name],
            "launches_int8_inversion": serving["int8_inversion"][
                "launches"][name],
            "launches_export_embedder": serving["export_embedder"][
                "launches"][name],
            "launches_export_generator": serving["export_generator"][
                "launches"][name],
            # phases 41-44: the convergence run and the world-1 stage-3
            # step checked to be 0; one rank's launches of a two-rank
            # stage-1 R1 + path-length iteration and e4e encoder step
            "launches_parallel": par_launches[name],
            # phase 45: one rank's launches over its spatial runs, each
            # equal to the one process's; phase 46: checked to be 0
            "launches_spatial": sp_launches[name],
            "launches_tune": spatial_tune["tune"]["launches"][name],
            # phase 47: export_jittable's generator program, equal to
            # eager's; device_augment, modconv and test_rfw checked to be 0
            "launches_last_slice": last["export_jittable"]["launches"][name],
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
    print(json.dumps({"host_data": host}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"spatial_tune": spatial_tune}))
    print(json.dumps({"last_slice": last}))
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
    elif sys.argv[1:] == ["--parallel"]:
        parallel_main()
    elif sys.argv[1:] == ["--spatial"]:
        spatial_main()
    elif sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    else:
        main()
