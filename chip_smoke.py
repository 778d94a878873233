"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from `adaface_tpu_torch/csrc/`;
  3. hold every kernel against its plain PyTorch version at the shapes its
     path gives it: the SD1.5 serving path's (bf16), the fused-LN UNet's
     (LayerNorm, bf16) and the face parser's (train-mode BN + activation at
     batch 16, 448x448, fp32, with the BN Function's gradients); the flash
     kernels at the path's strides (views of [B,S,H*D] storage), at a
     contiguous and at a misaligned layout, and the split-keys combine
     kernel on the partial results of the VAE's attention; the GroupNorm
     kernels on channels-last maps at every shape of the path, each with
     the kernel `gn_plan` gives it, the one-launch kernel and the split pair
     each forced at a shape of the other's regime, an fp32 case, a case with
     mean 100 and deviation 1, and two runs held to the same bits; the
     batch norm statistics at every BN shape of the face parser and the
     LayerNorm at every LN shape of the UNet, each with two runs held to the
     same bits, `bn_stats` also against its own arithmetic in plain PyTorch;
     the instances no path reaches (channels off a 16-byte pack, a pointer
     off 16 bytes, channel tiles, other widths in registers and over several
     warps); `bn_stats` at mean 100 and deviation 1 (its mean bounded, its
     rstd reported against fp64); both captured in one CUDA graph and
     replayed twice to the same bits; an empty kernel's launch as the floor
     of the small shapes; the forward's row statistics, the wgmma kernel's
     and the wide kernel's and `flash_combine`'s (its O with and without
     them, bit for bit; m and 1/l against `flash_stats_tiled`);
     the flash backward's kernels against `flash_bwd_chunked` (dq, dk, dv)
     and, at the UNet's head dims, against `flash_bwd_tiled`, at every
     attention shape of the student UNet at batch 16, the recon's
     face-masked self-attention at batch 4 and the VAE decoder's mid block
     (B 2, H 1, S 4096, D 512: the cluster kernels, against
     `flash_bwd_tiled` at the cluster's head-dim slices), masked and causal
     cases at ragged lengths (D 512 among them), and the GroupNorm backward's
     (`gn_bwd_fused`, or `gn_bwd_reduce` + `gn_bwd_dx`, on the statistics the
     forward kept, themselves held to `gn_stats_plain`) against the
     closed-form VJP (dx, dγ, dβ) at every UNet GroupNorm shape at batch 16
     and every VAE decoder map at batch 2, each twice to the same bits; the flash
     forward at the teacher's 16-token cross-attention and at ToMe's merged
     64x64 self-attentions (S 2048 and 2868: ragged tiles); the int8 kernels
     (`quant_act`, `int8_conv_igemm`) at every int8 layer shape
     of the SD1.5 UNet (convolutions and the `quantize_dense` layers) at CFG
     batch 2 and batch 16, found by a census of one int8 UNet call at each,
     bit for bit against their plain versions (fp64 sums), twice to the same
     bits, a cluster-split reduction against an unsplit one, three kernels and
     no memset a layer (torch.profiler), beside cuDNN's bf16
     convolution and im2col + `torch._int_mm` (yardsticks); print errors,
     median times (single launches, and for GroupNorm, LayerNorm, BatchNorm
     and the backward kernels also 20 launches as a CUDA graph: the device
     alone), each kernel's bound (the larger of bytes / 3.35 TB/s and
     operations / 989 TFLOP/s) and the stock PyTorch op's time (a yardstick
     only: the port never calls it);
  4. one full-width SD1.5 UNet call at CFG batch 2, kernels against plain;
     then the same call in the fused-LN configuration (`fused_ln=True`),
     kernels against plain, with its 48 LayerNorm launches;
  5. the personalized text-to-image path through the port's AdaFaceWrapper:
     a small request, kernels against plain; then 3 requests for 2
     subjects at 512x512, 25 DDIM steps, guidance 6.0, random full-size
     weights from a seeded torch.Generator, with the kernels' launch counts
     and the hits and misses of the flash wrapper's two caches; then one
     such request whose subject photos are files, a 512x512 lossy WebP,
     palette PNG and CMYK JPEG read from a folder by
     `scripts/_common_torch.load_subject_images` (each held to Pillow's
     digest, the ada embeddings equal to those of the pixels handed over
     as arrays), with its launch counts;
  6. the rest of the SD1.5 serving surface, on the same modules: the
     continuous batcher (8 slots = UNet batch 16 with CFG, 25 steps, 512x512,
     12 requests queued up front for three subjects and none, two guidance
     scales and a dual one) with its launch counts, the addresses of its
     state buffers before and after, imgs/sec, and a step's device time
     beside the host's time to enqueue it at 8 and at 16 slots; a small drain
     against the wrapper's one-shot images and against itself on the plain
     versions; one img2img request (a 512x512 uint8 image, strength 0.8: 20
     of 25 steps) with the VAE encoder's launch counts and its moments,
     kernels against plain; one DPM-Solver++ request at 512x512, PNDM and LCM
     at 256x256, each against the DDIM image of the same latents; then the
     joint encoder (`serve_joint`: Arc2Face + ConsistentID, 20 ada tokens;
     CLIP-H/14 vision, ProjPlus, three CLIP-L towers, all fp32 at full
     width) behind RetinaFace + ArcFace on the card, over the same SD1.5
     modules: every photo detected and embedded (candidate boxes and NMS
     time printed), 3 requests at 512x512, 25 steps with their launch
     counts, 4 requests with 20 ada tokens through the 8-slot batcher,
     the card against the same weights on the CPU, fp32, in three parts each
     given the card's input (RetinaFace's outputs, ArcFace on the card's
     crops, the encoders on the card's ID embeddings; relative L2 <= 1e-4
     for the detector, 1e-5 for the others; the detector with TF32
     convolutions is printed beside), and face -> ada host and device ms
     per subject for Arc2Face, ConsistentID and the joint encoder;
  7. face-parser training at its published configuration (BiSeNet-ResNet18,
     batch 16, crop 448, fp32, OHEM, SGD): one train step's loss and
     gradients, kernels against plain, under deterministic cuDNN without
     TF32, beside the envelope of plain with fp64 BN statistics; then 10
     steps of the port's train step and optimizer with the BN launch counts
     (one `bn_stats` and one `bn_norm_act` launch a BN, the BNs counted by
     shape against BN_CASES), steps/sec and the memory peak; then one eval-mode
     forward at 512x512 to a face mask;
  8. Stage-1 UNet distillation at full SD1.5 width through
     `train_torch.build_trainer` and `Trainer.fit` with
     `configs/stage1-distill-arc2face.yaml` (SD1.5 UNet and VAE encoder in
     bf16, CLIP-L text and the Arc2Face encoder in fp32, prodigy, batch 4,
     accumulation 2, the teacher's 2-4 step chain, batches prepared in a
     second thread) on synthetic 512x512 PNGs: one student step's
     SubjBasisGenerator gradients kernels against plain, 6 micro-steps (3
     updates, every teacher bucket) with finite losses, the accumulation in
     the parameters, the backward launches as the autograd graphs hold them,
     the fit's checkpoint reloaded; a micro-step's time split, the device's
     busy share and the peak memory;
  9. full-UNet finetuning at full SD1.5 width through the same entry points
     with `configs/finetune-unet.yaml` (every iteration recon: the UNet's
     fp32 master weights trained in bf16, decodes with gradient, ArcFace
     losses; a detector of one central face injected): one recon step's
     gradients kernels against plain, 12 micro-steps (3 updates; on images
     and on pure noise) with finite losses, the accumulation in the
     parameters, the backward launches as the graphs hold them (the D 512
     flash backward and the GroupNorm backward at the decoder's maps), the
     checkpoint with `unet_fp16.safetensors` reloaded; a micro-step's split,
     the busy share, the peak memory, and the adversarial ArcFace gradient;
 10. Stage-2 compositional distillation at full SD1.5 width through the same
     entry points with `configs/stage2-comp-distill.yaml` (comp-distill every
     4th micro-step, recon and unet-distill between; the joint encoder's two
     SubjBasisGenerators, with the UNet's attention and FFN adapters at rank
     192 added as trainables; a detector of one central face injected): the
     backward kernels at the new shapes (flash at UNet batch 12, D 512 at
     batch 3, GroupNorm at every UNet map at 12 and decoder map at 3) against plain; the
     masked D 40 forward's plan and device time at batches 2 and 4; one comp
     step's gradients kernels against plain at batch 1, the adapters' unused
     parts exactly 0; 8 micro-steps (comp at 4 and 3 priming steps, recon,
     unet-distill) with finite losses and the parameters moved at each update
     with a learning rate, the backward launches per micro-step as the graphs
     hold them against the fit's counts, the checkpoint with
     `unet_lora_modules` reloaded; a comp micro-step's split, its busy share,
     the peak memory, seconds per optimizer step, and a profiled recon
     micro-step's flash forward launches by shape and mask;
 11. the Stage-2 training recipes (`train_stage2_recipes`): the same
     configuration through `train_torch.build_trainer` warm-started from an
     unextended checkpoint of the joint encoder's two SubjBasisGenerators with
     `--extend_mkv_multiplier 2`, `comp_distill.use_face_flow=true` (a random
     GMA), `trainer.optimizer=adam8bit`, and a comp UNet from a second seeded
     draw (`Trainer.set_comp_unet`): 4 micro-steps (comp, then recon) with
     finite losses, the parameters moved at the update whose learning rate is
     not 0 (the warmup's first is), the UNet's checksum holding the comp
     weights inside the comp step and the base ones after it, the backward
     launches as the graphs hold them, the peak memory; a comp micro-step's
     split with the flow on its own line and its busy share with and without
     the flow; the latent flow on the fit's captured layer-22 inputs, card
     against CPU (fp32 without TF32, relative L2 <= 1e-4; the TF32 time
     beside); adamw, nadam, muon, adam8bit and cautious(adamw) card against
     CPU (<= 1e-5 a tensor); and the fit's MKV checkpoint served
     (`serve_mkv`: ada embeddings card against CPU <= 1e-5, launches equal to
     an unextended request's).
Between phases 6 and 7, `serve_speed_modes` runs the pipeline's three speed
modes on the phase-5 modules: one int8 UNet call kernels against plain and
against the bf16 call (relative L2, correlation); a small request of each
mode kernels against plain (ToMe with the kernel run's merges handed to the
plain run, the merges that differ unhanded counted); 2 requests at 512x512,
25 steps, guidance 6.0 of the default path, DeepCache at intervals 3 and 5,
ToMe 0.5, int8, int8 + DeepCache 3 and 5, each with its launches by kernel (held
to the counts its UNet calls give), device time and operations, host time
and pixel distance from the default image of the same seed, and a request
run again (ToMe's held to the same bits: its merged sums are taken in a
fixed order); the 8-slot
batcher serving the int8 UNet: a drain and one step captured in a CUDA graph
and replayed twice to the eager step's bits. After it, `serve_sdxl` and
`serve_sd3` run the SDXL and SD3 pipelines at full width on random weights of
their own seeds, behind the phase-5 encoder: one SDXL UNet call (CFG batch 2,
a 128x128 latent) and one MMDiT call (4096 + 333 tokens) kernels against
plain (relative L2 <= 5e-2), then one 1024x1024 request of each of two
subjects through `AdaFaceWrapper("sdxl")` (25 Euler steps, guidance 5.0) and
`AdaFaceWrapper("sd3")` (28 steps, guidance 7.0), each held to the launches
its UNet / MMDiT calls and decodes predict (the D 64 attentions all on the
wgmma kernel: the wide kernel launches once a decode, for the VAE), with the
latency, and one more request's device time and operations by kind; phase 3
holds the D 64 instance at their five attention shapes, and GroupNorm and
the D 512 flash at the 1024x1024 shapes. Between `serve_speed_modes` and
`serve_sdxl`, `serve_video` runs the text-to-video path on the phase-5 SD1.5
modules with the full MM_SD15_V2 motion modules (random, seeded): the
zero-`proj_out` video UNet call equal to the image UNet's bit for bit, then
with `proj_out` drawn off 0: one motion module at its 64x64 and 8x8 shapes
(batch 32) against its fp32 plain computation, one video UNet call at one
video of 16 frames kernels against plain, and one 16-frame, 512x512, 25-step
clip (guidance 6.0, after a 2-step warm-up clip) through
`AdaFaceWrapper("text2video")`, held to the launches its 25 UNet calls at
batch 32 and two batch-8 decodes predict, with its latency, peak memory, the
frames' range and the distance between consecutive frames, the GIF's size,
one more clip's device time and operations by kind, and the motion modules'
share of it; phase 3 holds the flash and GroupNorm kernels at the clip's
shapes (the UNet at batch 32, the decode at batch 8). After `serve_sd3`,
`check_sd15_bits` holds one SD1.5 request of a fresh server to the bits
recorded from the parent tree (where torch, CUDA and the card are the
recorded ones; whether it compared stands under "checks" in the kernels
line), and `run_tools` runs `scripts/flow_tool_torch.py` and
`scripts/ckpt_tool_torch.py check` once on the card. Before `serve_speed_modes`,
`serve_trained` serves what the port's trainers
write, on the same SD1.5 modules: the UNet's attention and FFN adapters at
rank 192 (B and the magnitudes drawn off their start) written by
`save_adaface_ckpt` as the trainer writes them and loaded by
`AdaFaceWrapper.load_unet_lora_weights`: a small request kernels against
plain, 2 requests at 512x512, 25 steps with an unadapted request's launch
counts and images apart from the unadapted ones, a drain of 4 requests
through the 8-slot batcher with its counts and the small drain held to the
one-shot pipeline; a UNet ensemble of the base UNet and one loaded from a
trainer's `unet_fp16.safetensors` (at weights (1, 0) equal to the single
UNet bit for bit, at (0.5, 0.5) the UNet's launches twice a request's);
`export_unet_to_diffusers` -> `convert_unet` -> a fresh UNet equal in one
call bit for bit; an SD1.5 single file in the LDM layout (fp16, the
`model_ema` shadows, the schedule buffers) written from the towers, loaded
by `load_sd_towers` and served, its leaves and pixels held to the source;
request latency and device time with and without the adapters and under
the ensemble, the adapters' own device time, the drain's imgs/sec and the
peak memory, beside the card's name and power limit.
After `run_tools`, the host data path without PIL and data parallelism:
`decode_images` decodes every committed fixture of
`tests/data/images/` (JPEG baseline, extended and progressive at 4:4:4,
4:2:2, 4:2:0, 4:4:0, grey, restarts, odd sizes; BMP 24-, 32-bit and 8-bit
paletted, bottom-up and top-down; PNG labels) and holds each to the SHA-256
of Pillow's pixels recorded beside it (PNG of every colour type and depth,
Adam7; WebP lossy, lossless, with alpha, animated; CMYK, YCCK and RGB JPEGs,
sampling past 2; RLE, bit-field, 16-, 4- and 1-bit BMPs), its host ms of a
512x512 WebP, palette PNG and CMYK JPEG beside a JPEG's,
and the item pipeline native against numpy at 512x512, bit for bit;
`train_face_parser_folder` trains the face parser at its published
configuration (batch 16, crop 448, fp32) for 3 steps from the JPEG fixtures
and their PNG labels through `FaceMaskDataset.batches`; after phase 8,
`train_dp` runs the Stage-1 fit on a folder of JPEG, BMP and PNG photos in
four processes on the card at once: without a process group, as two gloo
ranks (`trainer.dp=2`) and as one NCCL rank (`trainer.dp=1`), the ranks
equal bit for bit, the 2-rank fit within its bounds of the plain one and the
NCCL fit equal to it bit for bit; before their fit, while the other two
wait, the gloo ranks run sync-BN, which `check_sync_bn` then holds:
`fused_bn_act(group=)` over the 2 ranks (half the batch each) against the
whole batch on one rank at the first seven BN shapes, forward and backward,
and `bn_stats`' sums mode against its plain version, with its device time.
Before phase 4, `flash_attention` and `group_norm_silu` are held to record
their autograd Functions on inputs that require grad, with the backward
kernels' launches and gradients (`check_autograd_functions`).
Each path runs with the launch counts set to 0 just before it and checked
just after. The line before the last holds the per-kernel JSON record; the
last line is {"ok": true, "device": {...}}.

After `serve_video`, `evaluate_and_tools` runs the evaluation harness and the
tools on the SD1.5 wrapper: one UNet call at the eval batch (8) kernels
against plain; `scripts/txt2img_eval_torch.py`'s generation of 2 dreambench
prompts x 4 samples at 512x512, 25 steps (UNet batch 8 with CFG), held to its
launches, the PNGs read back; CLIP-T / CLIP-I (ViT-B/32), DINO (ViT-S/16) and
face similarity (RetinaFace + ArcFace) against the subject's photos, random
weights from their seeds, with the CSV written; the same evaluators copied to
the CPU scoring the same PNGs, each cosine score within 1e-4;
`gen_face_masks_torch.py` on a folder of JPEG and PNG photos; BiSeNet parsing
and the makeup recolour (pixels off the recoloured parts equal to the input);
`app_torch.py`'s server on a free port in a thread answering GET / and a POST
of two photos with 512x512 PNGs; the seconds of each part.

After `serve_speed_modes`, `quality_gate` compares the default path's and
int8 + DeepCache 5's images of the same seeds through
`scripts/bench_quality_torch.compare` (ArcFace cosine of a random seeded
resnet_face18, pixel MAE and correlation), on the card and on the CPU;
`profile_stages` runs `scripts/profile_pipeline_torch.profile_stages` at
batch 8 (text encode, one UNet call at CFG batch 16, the 25-step loop and
the decode, CUDA events and device time, the UNet's MFU over 989 TFLOP/s),
then one request at that batch held to its launches by kernel;
`teacher_sanity` runs `scripts/test_img_prompt_model_torch.teacher_images`
on the SD1.5 modules (a small run kernels against plain, then 2 images at
512x512, 8 teacher steps from the random-ID path, held to their launches).
After `decode_images`, `toy_dataset` writes `scripts/make_toy_dataset_torch.py`'s
2 x 2 folder at 512x512 and reads an item of it through `PersonalizedBase`.
In `train_dp`'s processes, after their fits, the process without a group
and then the two gloo ranks run one recon iteration with the adversarial
branch (`adv_bs` 3: the attacked rows span both ranks) on a global batch of
4 at full width (the Stage-1 SubjBasisGenerator from before the fit, a
random VAE decoder and ArcFace, a host detector of fixed boxes), and the
attacked noise alone. The ranks' loss is held to the single process's
within DP_ADV_LOSS_REL, their noise to the single process's attack with the
adversarial gradient taken in the ranks' row groups (their decode batches)
within DP_ADV_NOISE_REL of the attack's size, and to the single process's
own within DP_ADV_WHOLE_REL (the bf16 decode rounds differently at each
batch size), with each process's device time.

After `train_stage2_recipes`, `train_tp` runs tensor parallelism
(`parallel/mesh.py`: `make_mesh(dp, tp)`, `shard_params` with JAX's rules)
at full SD1.5 width (256x256 images) in four gloo processes on the card
(NCCL refuses two ranks a card): the Stage-1 unet-distill micro-step at dp 2
x tp 2 and at tp 2, the finetuning configuration's recon micro-step (its UNet
frozen and cut)
and the Stage-2 comp micro-step with the rank-192 adapters at tp 2, each
with the towers' projection biases drawn off 0, in bf16 through the kernels
and in fp32 plain with TF32 off, against the same micro-step in one
process: the tp ranks' losses and gradients equal bit for bit, fp32 within
TP_FP32_REL, bf16 within TP_BF16_LOSS_REL and TP_BF16_GRAD_REL_L2 (their
readings and two planted faults': `chip_compare.py --tp-faults`). Phase 3
(`check_flash_tp`) holds the flash forward and backward at the ranks'
4-head shapes, and `train_tp` that the ranks ran no other.

The script imports only torch, numpy, the port (`adaface_tpu_torch`), the
checkpoint writers of `tests/torch_sd_layout.py`, the port's CLI twins in
`scripts/` and `app_torch.py` (and `chip_compare.tp_fault` where
`chip_compare.py --tp-faults` runs `tp_process`), and reads the image
fixtures of `tests/data/images/`.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from adaface_tpu_torch.utils.profiling import device_events, device_operations

SEED = 0
BF16_TOL = 1e-2  # bf16 keeps 8 significant bits: ~0.4% per rounding
FP32_TOL = 1e-4
FP32_SUM_TOL = 1e-5  # a few fp32 roundings of a short sum, and ex2.approx (2^-22)
UNET_REL_TOL = 5e-2  # bf16 through ~70 layers of random weights
IMAGE_TOL = 5e-2  # [0, 1] pixels after a short bf16 sampling loop

# (label, B, H, Sq, Sk, D): every attention the serving path sends to the
# flash kernel (UNet at CFG batch 2, 8 heads; VAE mid-block, one head)
FLASH_CASES = [
    ("unet 64x64 self", 2, 8, 4096, 4096, 40),
    ("unet 64x64 cross", 2, 8, 4096, 77, 40),
    ("unet 32x32 self", 2, 8, 1024, 1024, 80),
    ("unet 32x32 cross", 2, 8, 1024, 77, 80),
    ("unet 16x16 self", 2, 8, 256, 256, 160),
    ("unet 16x16 cross", 2, 8, 256, 77, 160),
    ("vae mid self", 1, 1, 4096, 4096, 512),
]
# the UNet's six at CFG batch 16: a step of the continuous batcher with 8 slots
FLASH_CASES_B16 = [(f"{label} batch 16", 16, *dims) for label, _, *dims in FLASH_CASES[:-1]]
FLASH_PER_UNET_CALL = 5  # launches of each of the UNet's six shapes in one call
# layouts off the path, at the 32x32 self-attention shape: one contiguous
# [B,H,S,D], and one whose head offset (D = 36: 72 bytes) is not a multiple
# of 16 bytes, which takes the wide kernel and its element-copy staging
FLASH_EXTRA_CASES = [
    ("contiguous 32x32 self", 2, 8, 1024, 1024, 80),
    ("misaligned D36 self", 2, 8, 1024, 1024, 36),
]
# the 64x64 self-attention on ToMe's merged tokens (`ops/tome.py`): at ratio
# 0.5 4096 - 2048 tokens, at 0.3 4096 - 1228 = 2868 (ragged query and key
# tiles past 77 keys: no other path sends such a shape)
FLASH_TOME_CASES = [("tome 0.5 64x64 self", 2, 8, 2048, 2048, 40),
                    ("tome 0.3 64x64 self", 2, 8, 2868, 2868, 40)]
# the teacher's cross-attention over the 16 Arc2Face image-prompt tokens
# (forward only, batch 4): a key count no serving path sends
FLASH_TEACHER_CASES = [(f"unet {hw} cross Sk16 teacher", 4, 8, s, 16, d)
                       for hw, s, d in (("64x64", 4096, 40), ("32x32", 1024, 80),
                                        ("16x16", 256, 160))]
# the joint encoder's teacher (`configs/stage1-distill-joint.yaml`) reads its
# 20 image-prompt tokens (16 Arc2Face + 4 ConsistentID) at batch 4; under
# its CFG (p 0.5) the UNet's batch doubles while the context keeps 4 rows,
# which the cross-attention's reshape turns into 8 rows of 10 keys, as the
# JAX UNet does (ROADMAP §3): key counts no other path sends
FLASH_JOINT_TEACHER_CASES = [(f"unet {hw} cross Sk{sk} joint teacher", b, 8, s, sk, d)
                             for b, sk in ((4, 20), (8, 10))
                             for hw, s, d in (("64x64", 4096, 40), ("32x32", 1024, 80),
                                              ("16x16", 256, 160))]
# the SDXL and SD3 pipelines' kernel attentions at 1024x1024, CFG batch 2:
# SDXL's UNet at its 64x64 and 32x32 levels (head dim 64, 10 and 20 heads;
# the 32x32 level also in the mid block), SD3's joint attention over 4096
# latent + 77 + 256 context tokens (ragged last tiles), all on the wgmma
# kernel's D 64 instance; the VAE decoder's mid block at a 128x128 latent
# (the wide kernel, D 512, 16384 tokens: 256 query tiles, so no key split)
FLASH_XL_CASES = [
    ("sdxl 64x64 self", 2, 10, 4096, 4096, 64),
    ("sdxl 64x64 cross", 2, 10, 4096, 77, 64),
    ("sdxl 32x32 self", 2, 20, 1024, 1024, 64),
    ("sdxl 32x32 cross", 2, 20, 1024, 77, 64),
    ("sd3 joint", 2, 24, 4429, 4429, 64),
    ("vae mid 1024 self", 1, 1, 16384, 16384, 512),
]
# launches of each SDXL shape in one UNet call (transformer blocks: 2 + 2 x 3
# at 64x64, 2 x 10 + 10 + 3 x 10 at 32x32) and of the joint attention in one
# MMDiT call (24 blocks)
# the text-to-video clip's kernel attentions: the UNet's six at CFG batch 32
# (one video of 16 frames, with its unconditional twin) and the VAE's mid
# block over a decode chunk of 8 frames
VIDEO_FRAMES = 16
VIDEO_DECODE_CHUNK = 8
FLASH_VIDEO_CASES = ([(f"{label} video", 2 * VIDEO_FRAMES, *dims)
                      for label, _, *dims in FLASH_CASES[:-1]]
                     + [("vae mid self video", VIDEO_DECODE_CHUNK, 1, 4096, 4096, 512)])
PLAIN_ATTENTION_BATCH = 16  # the plain version's fp32 logits at S 4096: 8.6 GB a chunk
SDXL_FLASH_PER_CALL = {"sdxl 64x64 self": 10, "sdxl 64x64 cross": 10,
                       "sdxl 32x32 self": 60, "sdxl 32x32 cross": 60}
SD3_FLASH_PER_CALL = 24
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12
RUN_LAUNCHES = 20  # launches between one pair of events, for launch-bound shapes
# every GroupNorm of the UNet at 512x512: (label, C, H = W, eps, SiLU (resnet
# norms with, transformer norms without), launches per UNet call)
UNET_GN = [
    ("resnet 64x64 320", 320, 64, 1e-5, True, 8),
    ("transformer 64x64 320", 320, 64, 1e-6, False, 5),
    ("resnet 64x64 640", 640, 64, 1e-5, True, 2),
    ("resnet 64x64 960", 960, 64, 1e-5, True, 1),
    ("resnet 32x32 320", 320, 32, 1e-5, True, 1),
    ("resnet 32x32 640", 640, 32, 1e-5, True, 6),
    ("transformer 32x32 640", 640, 32, 1e-6, False, 5),
    ("resnet 32x32 960", 960, 32, 1e-5, True, 1),
    ("resnet 32x32 1280", 1280, 32, 1e-5, True, 1),
    ("resnet 32x32 1920", 1920, 32, 1e-5, True, 1),
    ("resnet 16x16 640", 640, 16, 1e-5, True, 1),
    ("resnet 16x16 1280", 1280, 16, 1e-5, True, 6),
    ("transformer 16x16 1280", 1280, 16, 1e-6, False, 5),
    ("resnet 16x16 1920", 1920, 16, 1e-5, True, 1),
    ("resnet 16x16 2560", 2560, 16, 1e-5, True, 2),
    ("resnet 8x8 1280", 1280, 8, 1e-5, True, 11),
    ("transformer 8x8 1280", 1280, 8, 1e-6, False, 1),
    ("resnet 8x8 2560", 2560, 8, 1e-5, True, 3),
]
# every GroupNorm of the VAE at 512x512, batch 1: (label, C, H = W, SiLU,
# launches per decode, per encode)
VAE_GN = [
    ("resnet 64x64 512", 512, 64, True, 10, 9),
    ("attention 64x64 512", 512, 64, False, 1, 1),
    ("resnet 128x128 512", 512, 128, True, 6, 3),
    ("resnet 128x128 256", 256, 128, True, 0, 1),
    ("resnet 256x256 512", 512, 256, True, 1, 0),
    ("resnet 256x256 256", 256, 256, True, 5, 3),
    ("resnet 256x256 128", 128, 256, True, 0, 1),
    ("resnet 512x512 256", 256, 512, True, 1, 0),
    ("resnet 512x512 128", 128, 512, True, 6, 4),
]
# every GroupNorm of SDXL's UNet at 1024x1024 (a 128x128 latent), as UNET_GN;
# 46 a call: its 128x128 maps are larger than a cluster holds
SDXL_GN = [
    ("resnet 128x128 320", 320, 128, 1e-5, True, 8),
    ("resnet 128x128 640", 640, 128, 1e-5, True, 2),
    ("resnet 128x128 960", 960, 128, 1e-5, True, 1),
    ("resnet 64x64 320", 320, 64, 1e-5, True, 1),
    ("resnet 64x64 640", 640, 64, 1e-5, True, 6),
    ("transformer 64x64 640", 640, 64, 1e-6, False, 5),
    ("resnet 64x64 960", 960, 64, 1e-5, True, 1),
    ("resnet 64x64 1280", 1280, 64, 1e-5, True, 1),
    ("resnet 64x64 1920", 1920, 64, 1e-5, True, 1),
    ("resnet 32x32 640", 640, 32, 1e-5, True, 1),
    ("resnet 32x32 1280", 1280, 32, 1e-5, True, 10),
    ("transformer 32x32 1280", 1280, 32, 1e-6, False, 6),
    ("resnet 32x32 1920", 1920, 32, 1e-5, True, 1),
    ("resnet 32x32 2560", 2560, 32, 1e-5, True, 2),
]
# every GroupNorm of a VAE decode at 1024x1024 (SDXL's, and SD3's 16-channel
# VAE, whose GroupNorms are the same), batch 1, as VAE_GN: 30 a decode
VAE1024_GN = [
    ("resnet 128x128 512", 512, 128, True, 10),
    ("attention 128x128 512", 512, 128, False, 1),
    ("resnet 256x256 512", 512, 256, True, 6),
    ("resnet 512x512 512", 512, 512, True, 1),
    ("resnet 512x512 256", 256, 512, True, 5),
    ("resnet 1024x1024 256", 256, 1024, True, 1),
    ("resnet 1024x1024 128", 128, 1024, True, 6),
]
# the motion modules' GroupNorms (eps 1e-6, no SiLU: the key of the UNet's
# transformer norms) at 512x512: (C, H = W) → modules per video UNet call
MOTION_GN = {(320, 64): 5, (640, 32): 5, (1280, 16): 5, (1280, 8): 6}


def video_gn(c: int, hw: int, eps: float, silu: bool, n: int) -> int:
    """GroupNorms of one shape in a video UNet call: the UNet's `n`, and the
    motion modules' where the key is theirs."""
    return n + (MOTION_GN.get((c, hw), 0) if eps == 1e-6 and not silu else 0)


# (label, shape, groups, eps, silu, launches by path): the paths are one UNet
# call at CFG batch 2 ("unet": a request's step) or 16 ("unet16": a step of the
# batcher with 8 slots), one VAE decode and one VAE encode, one SDXL UNet call
# at CFG batch 2 ("sdxl") and one 1024x1024 decode ("decode1024"), one video
# UNet call with its motion modules at 16 frames ("video16") or at CFG batch 32
# ("video") and one decode chunk of 8 frames ("decode8"); `check_unet`,
# `serve` and the phases after it count the shapes the modules really see
# against this table
GN_CASES = (
    [(f"unet {label}", (2, c, hw, hw), 32, eps, silu, {"unet": n})
     for label, c, hw, eps, silu, n in UNET_GN]
    + [(f"vae {label}", (1, c, hw, hw), 32, 1e-6, silu, {"decode": dec, "encode": enc})
       for label, c, hw, silu, dec, enc in VAE_GN]
    + [(f"unet {label} batch 16", (16, c, hw, hw), 32, eps, silu,
        {"unet16": n, "video16": video_gn(c, hw, eps, silu, n)})
       for label, c, hw, eps, silu, n in UNET_GN]
    + [(f"sdxl {label}", (2, c, hw, hw), 32, eps, silu, {"sdxl": n})
       for label, c, hw, eps, silu, n in SDXL_GN]
    + [(f"vae 1024 {label}", (1, c, hw, hw), 32, 1e-6, silu, {"decode1024": n})
       for label, c, hw, silu, n in VAE1024_GN]
    + [(f"unet {label} video", (2 * VIDEO_FRAMES, c, hw, hw), 32, eps, silu,
        {"video": video_gn(c, hw, eps, silu, n)})
       for label, c, hw, eps, silu, n in UNET_GN]
    + [(f"vae {label} batch {VIDEO_DECODE_CHUNK}", (VIDEO_DECODE_CHUNK, c, hw, hw), 32, 1e-6,
        silu, {"decode8": dec}) for label, c, hw, silu, dec, _ in VAE_GN if dec])
UNET_CALLS = 25  # per request: DDIM steps, one CFG batch-2 call each
# each kernel forced at a shape of the other's regime, where it can run
GN_FORCED = [("vae resnet 128x128 512", "fused"), ("unet resnet 64x64 320", "split"),
             ("unet resnet 8x8 1280", "split")]
RSTD_REL_TOL = 1e-3  # statistics of a map with mean 100 and deviation 1, against fp64
# (label, R, C, slope, dtype, BNs per train step): the train-mode BNs of
# BiSeNet at batch 16, 448x448 as [R = N*H*W, C]
# (`adaface_tpu/models/bisenet.py:148-198`); slope 0 is ReLU, 1 no activation
# (a shape's BNs are counted together, whatever their slope);
# `train_face_parser` counts the shapes the model really sees against this table
BN_CASES = [
    ("stem 224x224", 802816, 64, 0.0, torch.float32, 1),
    ("layer1 112x112", 200704, 64, 1.0, torch.float32, 4),
    ("layer2 56x56", 50176, 128, 0.0, torch.float32, 6),
    ("layer3 28x28", 12544, 256, 0.0, torch.float32, 5),
    ("layer4 14x14", 3136, 512, 1.0, torch.float32, 5),
    ("ffm 56x56", 50176, 256, 0.0, torch.float32, 2),
    ("arm attention 1x1", 16, 128, 1.0, torch.float32, 3),
    ("head 56x56", 50176, 64, 0.0, torch.float32, 1),
    ("arm 28x28", 12544, 128, 0.0, torch.float32, 2),
    ("head 28x28", 12544, 64, 0.0, torch.float32, 1),
    ("arm 14x14", 3136, 128, 0.0, torch.float32, 1),
    ("layer1 112x112 bf16", 200704, 64, 0.0, torch.bfloat16, 0),
]
BN_EPS = 1e-5
# (label, rows, C, dtype, launches per fused-LN UNet call): the UNet's
# LayerNorms at CFG batch 2 (three in each of its 16 transformer blocks);
# `check_unet` counts the shapes the modules really see against this table
LN_CASES = [
    ("unet 64x64", 8192, 320, torch.bfloat16, 15),
    ("unet 32x32", 2048, 640, torch.bfloat16, 15),
    ("unet 16x16", 512, 1280, torch.bfloat16, 15),
    ("unet 8x8", 128, 1280, torch.bfloat16, 3),
    ("unet 64x64 fp32", 8192, 320, torch.float32, 0),
]
# off the path, for the instances no path reaches: (label, rows, C, dtype,
# elements the pointer of x is moved off its 16-byte alignment)
BN_SCALAR_CASES = [
    ("odd C", 12545, 65, torch.float32, 0),
    ("odd C bf16", 12545, 65, torch.bfloat16, 0),
    ("pointer off 16 bytes", 50176, 128, torch.float32, 1),
    ("pointer off 16 bytes bf16", 50176, 128, torch.bfloat16, 1),
    ("C over a block", 1000, 1100, torch.float32, 0),  # channel tiles, the fold's channel loop
]
LN_OFF_PATH_CASES = [
    ("odd C looped", 1000, 77, torch.bfloat16, 0),
    ("pointer off 16 bytes looped", 2048, 640, torch.bfloat16, 1),
    ("packs off the lanes looped", 512, 1288, torch.float32, 0),  # 322 packs: no lane count fits
    ("768 in registers", 1101, 768, torch.bfloat16, 0),  # 16 lanes x 6 packs, a ragged last block
    ("64 in registers", 77, 64, torch.float32, 0),  # 8 lanes x 2 packs
    ("1024 over 4 warps", 77, 1024, torch.bfloat16, 0),
    ("256 fp32 over 2 warps", 300, 256, torch.float32, 0),
    ("1280 in registers", 2048, 1280, torch.bfloat16, 0),  # too many rows to split
]
LOSS_REL_TOL = 1e-4  # one fp32 train step, kernels against plain
GRAD_REL_TOL = 1e-3  # the BN Function's gradients, kernel residuals against plain
# A whole train step's gradients move by ~2.5e-3 (relative L2) when only the
# BN statistics' last bit changes (fp32 E[x^2] - mean^2 against the same in
# fp64): a ReLU or max-pool input that lands on the other side of its kink
# moves one unit's gradient, and the BN parameters' gradients are sums over
# 10^5-10^6 units that mostly cancel. Kernels against plain are held to twice
# that envelope, measured in the same run, and never to less than GRAD_REL_TOL.
ENVELOPE = 2.0
TRAIN_STEPS = 10
BISENET_BNS = sum(case[5] for case in BN_CASES)  # train-mode BNs per BiSeNet forward: 31
# shapes whose times go into the JSON record: the heaviest of each kernel
# that the UNet, which runs 25 times per image, gives it, and the face
# parser's stem
JSON_FLASH_T = "unet 64x64 self"
JSON_FLASH_STD = "unet 16x16 self"
JSON_FLASH_WIDE = "vae mid self"
JSON_GN = "unet resnet 64x64 320"  # the one-launch kernel
JSON_GN_SPLIT = "vae resnet 512x512 128"  # the split pair
JSON_BN = "stem 224x224"
JSON_LN = "unet 64x64"
JSON_FLASH_BWD = "unet 64x64 self batch 16"
JSON_GN_BWD = "resnet 64x64 320 batch 16"  # gn_bwd_fused
JSON_GN_BWD_SPLIT = "vae resnet 512x512 256 batch 2"  # gn_bwd_reduce + gn_bwd_dx


LOG_T0 = time.perf_counter()


def log(*a):
    """A line of the run's log, after the seconds since the script started
    (where a phase's time goes)."""
    print(f"[{time.perf_counter() - LOG_T0:6.1f} s]", *a, flush=True)


def require_cuda() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)  # the line as nvidia-smi gives it, without the log's seconds
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def build_kernels() -> float:
    """The CUDA kernels' library, and beside it on a thread the host
    library (`g++`: the image decoders and the item pipeline)."""
    from concurrent.futures import ThreadPoolExecutor

    from adaface_tpu_torch import native
    from adaface_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.load_library)
        _build.load_library()
        secs = time.perf_counter() - t0
        host.result()
    log(f"build: {secs:.1f} s -> {_build.library_path()}; host library "
        f"{native.library_path().name} by {time.perf_counter() - t0:.1f} s")
    log_path = _build.library_path().with_suffix(".log")
    if log_path.exists():
        text = log_path.read_text()
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", text))
        log(f"ptxas: {len(regs)} kernel instances, registers {min(regs)}..{max(regs)}, "
            f"spill stores {spills} bytes")
    return secs


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(fn, launches: int = RUN_LAUNCHES, reps: int = 5) -> float:
    """Per-launch time of `launches` back-to-back launches between one pair of
    events (median of `reps` such runs): the host's enqueue of one launch
    hides behind the device's work on the one before."""
    def run():
        for _ in range(launches):
            fn()
    return median_ms(run, reps=reps, warmup=1) / launches


def graph_ms(fn, launches: int = RUN_LAUNCHES, reps: int = 5) -> float:
    """Per-launch device time: `launches` launches captured in a CUDA graph
    and replayed, so that the host's work per launch (the wrapper's checks,
    the allocator, the enqueue) is left out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return median_ms(graph.replay, reps=reps, warmup=2) / launches


def host_us(fn, calls: int = 50) -> float:
    """Host time of one call, in microseconds: `calls` calls on the host's
    clock with no synchronisation between them (the device drains after).
    At a device-bound shape the loop waits on the launch queue and reads the
    device's time; 50 calls keep that wait short."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def bound(n_bytes: float, flops: float = 0.0) -> tuple[float, str]:
    """(the least ms the card could take, what bounds it): every input read
    once and every output written once at the card's memory rate, or the
    operations at its bf16 tensor-core peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, max(1, max |ref|)) in fp32."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    return (out - ref).abs().max().item(), max(1.0, ref.abs().max().item())


def flash_inputs(gen, label, b, h, sq, sk, d, dtype=torch.bfloat16):
    """q, k, v [B,H,S,D] laid out as the path lays them out: the UNet's are
    views of [B,S,H*D] projections (cross-attention's k and v the two halves
    of one [B,77,2*H*D] projection), the VAE's [B,1,S,D] is contiguous."""
    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if label.startswith("contiguous"):
        return mk(b, h, sq, d), mk(b, h, sk, d), mk(b, h, sk, d)
    split = lambda t: t.reshape(b, -1, h, d).transpose(1, 2)
    q = split(mk(b, sq, h * d))
    if "cross" in label:
        k, v = (split(t) for t in mk(b, sk, 2 * h * d).split(h * d, dim=-1))
    else:
        k, v = split(mk(b, sk, h * d)), split(mk(b, sk, h * d))
    return q, k, v


def plain_attention(q, k, v):
    """The plain version, over chunks of PLAIN_ATTENTION_BATCH of the batch
    where it is larger: the same function, without 17 GB of fp32 logits at
    batch 32, S 4096."""
    from adaface_tpu_torch.ops import attention as A

    if q.shape[0] <= PLAIN_ATTENTION_BATCH:
        return A.scaled_dot_product_attention(q, k, v)
    return torch.cat([A.scaled_dot_product_attention(*(t[i:i + PLAIN_ATTENTION_BATCH]
                                                       for t in (q, k, v)))
                      for i in range(0, q.shape[0], PLAIN_ATTENTION_BATCH)])


def check_flash(gen) -> dict:
    from adaface_tpu_torch.ops import attention as A

    results = {}
    for label, b, h, sq, sk, d in (FLASH_CASES + FLASH_CASES_B16 + FLASH_EXTRA_CASES
                                   + FLASH_TEACHER_CASES + FLASH_JOINT_TEACHER_CASES
                                   + FLASH_TOME_CASES + FLASH_XL_CASES + FLASH_VIDEO_CASES):
        q, k, v = flash_inputs(gen, label, b, h, sq, sk, d)
        scale = 1.0 / math.sqrt(d)
        out = A._flash_cuda(q, k, v, None, False, scale)
        plain = lambda: plain_attention(q, k, v)
        ref = plain()
        torch.cuda.synchronize()
        err, mag = max_err(out, ref)
        kernel = lambda: A._flash_cuda(q, k, v, None, False, scale)
        stock = lambda: F.scaled_dot_product_attention(q, k, v)
        # in turns: kernel, plain, stock, stock, plain, kernel (the plain
        # version, just run for the reference, two runs a turn)
        turns = [median_ms(f, reps=2, warmup=0) if f is plain else median_ms(f)
                 for f in (kernel, plain, stock, stock, plain, kernel)]
        ms, plain_ms, stock_ms = (min(turns[0], turns[5]), min(turns[1], turns[4]),
                                  min(turns[2], turns[3]))
        run, stock_run = run_ms(kernel), run_ms(stock)
        dev, stock_dev = graph_ms(kernel), graph_ms(stock)
        host, stock_host = host_us(kernel), host_us(stock)
        bound_ms, bound_by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                                   4.0 * b * h * sq * sk * d)
        plan = A.plan_for(q, k, v)
        log(f"flash {label:22s} B{b} H{h} Sq{sq} Sk{sk} D{d} strides q{tuple(q.stride())} "
            f"k{tuple(k.stride())} {plan.variant} rows {plan.block_rows} splits {plan.nsplit}: "
            f"max_abs_err {err:.3e} (bound {BF16_TOL * mag:.3e}) | single launches: kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms stock sdpa {stock_ms:.4f} ms | run of "
            f"{RUN_LAUNCHES}: kernel {run:.4f} ms stock {stock_run:.4f} ms | the same run as a "
            f"CUDA graph (device alone): kernel {dev:.4f} ms stock {stock_dev:.4f} ms | host per "
            f"call: kernel {host:.1f} us stock {stock_host:.1f} us | least "
            f"{bound_ms:.4f} ms by {bound_by}, reached {bound_ms / dev:.1%}")
        if err > BF16_TOL * mag:
            raise AssertionError(f"flash {label}: error {err} above bound")
        if (label.startswith(("tome", "sdxl", "sd3")) or (label.endswith("video") and d < 512)) \
                and plan.variant != "wg":
            raise AssertionError(f"flash {label}: the plan leaves the wgmma kernel")
        results[label] = dict(variant=plan.variant, err=err, ms=ms, plain_ms=plain_ms,
                              stock_ms=stock_ms, run_ms=run,
                              stock_run_ms=stock_run, graph_ms=dev, stock_graph_ms=stock_dev,
                              host_us=host, stock_host_us=stock_host,
                              bound_ms=bound_ms, bound_by=bound_by)
        # the plain version's fp32 logits are 8.6 GB at batch 16, S 4096
        del q, k, v, out, ref, kernel, plain, stock
        torch.cuda.empty_cache()
    for name, cases in (("2", FLASH_CASES[:-1]), ("16", FLASH_CASES_B16),
                        (f"{2 * VIDEO_FRAMES} (a video clip's step)", FLASH_VIDEO_CASES[:-1])):
        dev = sum(FLASH_PER_UNET_CALL * results[case[0]]["graph_ms"] for case in cases)
        lib = sum(FLASH_PER_UNET_CALL * results[case[0]]["stock_graph_ms"] for case in cases)
        log(f"flash per UNet call at batch {name} ({FLASH_PER_UNET_CALL * len(cases)} launches): "
            f"kernels {dev:.3f} ms of device time, stock sdpa {lib:.3f} ms")
    for name, per_call in (("SDXL UNet", SDXL_FLASH_PER_CALL),
                           ("SD3 MMDiT", {"sd3 joint": SD3_FLASH_PER_CALL})):
        dev, lib, bnd = (sum(n * results[label][key] for label, n in per_call.items())
                         for key in ("graph_ms", "stock_graph_ms", "bound_ms"))
        log(f"flash per {name} call at CFG batch 2, 1024x1024 ({sum(per_call.values())} "
            f"launches, D 64): kernels {dev:.3f} ms of device time, stock sdpa {lib:.3f} ms, "
            f"least {bnd:.3f} ms")

    # masked + causal at ragged lengths (Sq 200, Sk 177: the causal offset
    # Sk - Sq = -23 leaves rows 0..22 only masked keys; batch 1 also masks
    # keys 0..15), on every kernel: bf16 D 40 and D 64 (wgmma, three tiles by
    # TMA; at Sk 100 two tiles by cp.async), bf16 D 96 and D 200 (the wide
    # kernel, 32-key tiles, 6 key splits and the combine kernel) and fp32 D 64
    # (CUDA cores)
    for dtype, d, sk, tol in ((torch.bfloat16, 64, 177, BF16_TOL),
                              (torch.bfloat16, 64, 100, BF16_TOL),
                              (torch.bfloat16, 96, 177, BF16_TOL),
                              (torch.bfloat16, 40, 177, BF16_TOL),
                              (torch.bfloat16, 40, 100, BF16_TOL),
                              (torch.bfloat16, 200, 177, BF16_TOL),
                              (torch.float32, 64, 177, FP32_TOL)):
        q, k, v = flash_inputs(gen, "self", 2, 2, 200, sk, d, dtype)
        mask = torch.ones((2, sk), device="cuda")
        mask[1, :16] = 0.0
        mask[0, sk - 27:] = 0.0
        out = A._flash_cuda(q, k, v, mask, True, 1.0 / math.sqrt(d))
        ref = A.scaled_dot_product_attention(q, k, v, kv_mask=mask, causal=True)
        err, mag = max_err(out, ref)
        plan = A.plan_for(q, k, v)
        log(f"flash masked+causal Sq200 Sk{sk} D{d} {dtype} {plan.variant} splits "
            f"{plan.nsplit}: max_abs_err {err:.3e} (bound {tol * mag:.3e})")
        if err > tol * mag:
            raise AssertionError(f"flash masked+causal Sk{sk} D{d} {dtype}: error {err} "
                                 "above bound")
        results[f"masked causal Sk{sk} D{d} {dtype}"] = dict(variant=plan.variant, err=err)
    return results


def check_flash_combine(gen) -> dict:
    """The combine kernel against its plain version, on the partial results
    of the VAE's attention in two shares of its keys (unnormalized O, row
    maxima in log2 units, row sums: `flash_partials_tiled`, the wide
    kernel's arithmetic in plain PyTorch). The kernel adds the shares in the
    plain version's order in fp32, so its fp32 output is held to FP32_SUM_TOL
    of each element and its bf16 output to one bf16 rounding of each
    element (2^-8 relative covers a reference that sits on a rounding
    boundary); both with an absolute floor of FP32_SUM_TOL of the largest
    element, for elements that cancel to nearly nothing."""
    from adaface_tpu_torch.ops import attention as A

    label, b, h, sq, sk, d = FLASH_CASES[-1]  # the VAE's
    nsplit = 2
    q, k, v = flash_inputs(gen, label, b, h, sq, sk, d)
    o_part, m_part, l_part = A.flash_partials_tiled(q, k, v, key_tile=32, d_slices=4,
                                                    nsplit=nsplit)
    ref = A.combine_partials(o_part, m_part, l_part)
    out32 = A.flash_combine(o_part, m_part, l_part, torch.float32)
    out = A.flash_combine(o_part, m_part, l_part, torch.bfloat16)
    torch.cuda.synchronize()
    err, _ = max_err(out, ref)
    floor = FP32_SUM_TOL * ref.abs().max().item()
    over32 = ((out32 - ref).abs() - FP32_SUM_TOL * ref.abs()).max().item()
    over = ((out.float() - ref).abs() - 2.0 ** -8 * ref.abs()).max().item()
    rel_l2 = ((out.float() - ref).norm() / ref.norm()).item()
    ms = median_ms(lambda: A.flash_combine(o_part, m_part, l_part, torch.bfloat16))
    plain_ms = median_ms(lambda: A.combine_partials(o_part, m_part, l_part).to(torch.bfloat16))
    bound_ms, bound_by = bound(4 * (o_part.numel() + 2 * m_part.numel()) + 2 * b * h * sq * d)
    log(f"flash combine {nsplit} shares [{b},{h},{sq},{d}]: l_part {l_part.min().item():.2f}.."
        f"{l_part.max().item():.2f}, |ref| max {ref.abs().max().item():.3e} median "
        f"{ref.abs().median().item():.3e}; max_abs_err {err:.3e}, relative L2 {rel_l2:.3e}; "
        f"largest per-element excess, fp32 output: |out - ref| - {FP32_SUM_TOL:g} |ref| = "
        f"{over32:.3e}, bf16 output: |out - ref| - 2^-8 |ref| = {over:.3e} (bound for both "
        f"{floor:.3e}) | kernel {ms:.4f} ms plain {plain_ms:.4f} ms | least {bound_ms:.4f} ms "
        f"by {bound_by}")
    if not (torch.isfinite(out32).all() and over32 <= floor and over <= floor):
        raise AssertionError("flash combine: an element is off by more than its rounding")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def gn_inputs(gen, shape, dtype=torch.bfloat16, mean=0.5, std=2.0):
    """x [B, C, H, W] in channels-last memory, as the UNet and the VAE keep
    their maps, with scale and bias [C]."""
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)
    scale = (torch.randn((c,), generator=gen, device="cuda") + 1.0).to(dtype)
    bias = (torch.randn((c,), generator=gen, device="cuda") * 0.1).to(dtype)
    return x.contiguous(memory_format=torch.channels_last), scale, bias


def gn_launches(by_path: dict, **calls) -> int:
    """Launches of a GroupNorm case over `calls` of each path (`unet=25,
    decode=1` is one 512x512, 25-step request)."""
    return sum(n * calls.get(path, 0) for path, n in by_path.items())


def check_gn_case(G, x, scale, bias, groups, eps, silu, plan, tol) -> dict:
    """One GroupNorm on the kernel(s) of `plan` against the plain version:
    the output, two runs to the same bits, and for the split pair its
    statistics (the partials folded by `gn_finalize_plain`) and its
    normalize pass on them."""
    def run():
        if plan.kernel == "fused":
            return G.gn_fused(x, scale, bias, groups, eps, silu, plan)
        return G.gn_norm(x, G.gn_stats(x, groups, plan), scale, bias, groups, eps, silu, plan)

    out = run()
    err, mag = max_err(out, G.gn_silu_plain(x, scale, bias, groups, eps, silu))
    same_bits = torch.equal(out, run())
    res = dict(err=err, mag=mag, run=run, stats_err=0.0, norm_err=0.0)
    if plan.kernel == "split":
        rows, cpg = x[0, 0].numel(), x.shape[1] // groups
        part = G.gn_stats(x, groups, plan)
        stats = G.gn_finalize_plain(part, rows, cpg, -(-rows // plan.chunks), eps)
        res["stats_err"] = (stats - G.gn_stats_plain(x, groups, eps)).abs().max().item()
        res["norm_err"], _ = max_err(G.gn_norm(x, part, scale, bias, groups, eps, silu, plan),
                                     G.gn_norm_plain(x, stats, scale, bias, groups, silu))
        res["part"] = part
    if not same_bits:
        raise AssertionError(f"gn {tuple(x.shape)} {plan}: two runs differ")
    if err > tol * mag or res["stats_err"] > FP32_TOL or res["norm_err"] > tol * mag:
        raise AssertionError(f"gn {tuple(x.shape)} {plan}: error above bound: {res}")
    return res


def rstd_from_output(y, x, groups: int, eps: float):
    """rstd per (sample, group) that a GroupNorm output y (scale 1, bias 0, no
    SiLU) implies, and the fp64 value: the least-squares slope of y on
    x - mean in fp64, divided by the same slope of the exact output rounded
    to y's dtype. A bf16 map around 100 holds a dozen distinct values, so
    the output's rounding does not average out of one slope; it cancels
    between the two."""
    b = x.shape[0]
    xd = x.double().reshape(b, groups, x.shape[1] // groups, -1)
    dx = xd - xd.mean(dim=(2, 3), keepdim=True)
    want = torch.rsqrt((dx * dx).mean(dim=(2, 3), keepdim=True) + eps)
    slope = lambda out: (out.double().reshape(xd.shape) * dx).sum(dim=(2, 3)) / (
        dx * dx).sum(dim=(2, 3))
    exact = (dx * want).to(y.dtype)
    want = want.reshape(-1)
    return want * (slope(y) / slope(exact)).reshape(-1), want


def check_gn_adversarial(G, gen) -> float:
    """Mean 100, deviation 1 (mean^2 / variance = 1e4): rstd of each kernel
    within RSTD_REL_TOL of the fp64 value, bf16 and fp32, both regimes."""
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for shape, kernel in (((2, 320, 64, 64), "fused"), ((2, 320, 64, 64), "split"),
                              ((1, 128, 256, 256), "split")):
            x, _, _ = gn_inputs(gen, shape, dtype, mean=100.0, std=1.0)
            one, zero = torch.ones_like(x[0, :, 0, 0]), torch.zeros_like(x[0, :, 0, 0])
            plan = G.plan_for(x, 32, kernel)
            if kernel == "fused":
                got, want = rstd_from_output(
                    G.gn_fused(x, one, zero, 32, 1e-5, False, plan), x, 32, 1e-5)
            else:
                rows = shape[2] * shape[3]
                part = G.gn_stats(x, 32, plan)
                # what gn_norm's own fold of the partials makes of them, and
                # the partials folded in plain PyTorch
                folded, want = rstd_from_output(
                    G.gn_norm(x, part, one, zero, 32, 1e-5, False, plan), x, 32, 1e-5)
                got = torch.stack([folded, G.gn_finalize_plain(
                    part, rows, shape[1] // 32, -(-rows // plan.chunks), 1e-5)[:, 1].double()])
            rel = ((got - want).abs() / want).max().item()
            log(f"gn mean 100 deviation 1 {shape} {dtype} {kernel}: rstd rel_err {rel:.3e} "
                f"(bound {RSTD_REL_TOL:g})")
            if not rel <= RSTD_REL_TOL:
                raise AssertionError(f"gn adversarial {shape} {dtype} {kernel}: rstd off by {rel}")
            worst = max(worst, rel)
    return worst


def check_gn(gen) -> dict:
    from adaface_tpu_torch.ops import fused_gn as G

    results = {}
    for label, shape, groups, eps, silu, by_path in GN_CASES:
        c = shape[1]
        x, scale, bias = gn_inputs(gen, shape)
        plan = G.plan_for(x, groups)
        r = check_gn_case(G, x, scale, bias, groups, eps, silu, plan, BF16_TOL)
        full_err, _ = max_err(G.group_norm_silu(x, scale, bias, groups, eps, silu),
                              G.gn_silu_plain(x, scale, bias, groups, eps, silu))
        torch.cuda.synchronize()
        kernel = lambda: G.group_norm_silu(x, scale, bias, groups, eps, silu)
        plain = lambda: G.gn_silu_plain(x, scale, bias, groups, eps, silu)
        act = F.silu if silu else (lambda t: t)
        stock = lambda: act(F.group_norm(x, groups, scale, bias, eps))  # same memory format
        # one library call for the statistics' function, on the same memory
        grouped = x.permute(0, 2, 3, 1).reshape(shape[0], -1, groups, c // groups)
        stock_stats_fn = lambda: torch.var_mean(grouped, dim=(1, 3), correction=0)
        # the plain version (a yardstick, run for the reference above): two runs
        ms, plain_ms, stock_ms = (median_ms(kernel), median_ms(plain, reps=2, warmup=0),
                                  median_ms(stock))
        dev, stock_dev = graph_ms(kernel), graph_ms(stock)
        host, stock_host = host_us(kernel), host_us(stock)
        x_bytes = x.numel() * x.element_size()
        bound_fn, _ = bound(2 * x_bytes + 2 * c * x.element_size())
        res = dict(kernel=plan.kernel, plan=dataclasses.asdict(plan), err=max(r["err"], full_err),
                   stats_err=r["stats_err"], norm_err=r["norm_err"], ms=ms, plain_ms=plain_ms,
                   stock_ms=stock_ms, graph_ms=dev, stock_graph_ms=stock_dev, host_us=host,
                   stock_host_us=stock_host, bound_fn=bound_fn, bound_moved=bound_fn,
                   launches=gn_launches(by_path, unet=UNET_CALLS, decode=1),
                   by_path=by_path)
        detail = ""
        if plan.kernel == "split":
            part = r["part"]
            stats = G.gn_stats_plain(x, groups, eps)
            stats_fn = lambda: G.gn_stats(x, groups, plan)
            norm_fn = lambda: G.gn_norm(x, part, scale, bias, groups, eps, silu, plan)
            part_bytes = part.numel() * 4
            res.update(
                ms_stats=median_ms(stats_fn), graph_stats=graph_ms(stats_fn),
                plain_stats=median_ms(lambda: G.gn_stats_plain(x, groups, eps), reps=2),
                stock_stats=median_ms(stock_stats_fn), stock_graph_stats=graph_ms(stock_stats_fn),
                ms_norm=median_ms(norm_fn), graph_norm=graph_ms(norm_fn),
                plain_norm=median_ms(lambda: G.gn_norm_plain(x, stats, scale, bias, groups, silu),
                                     reps=2),
                bound_stats=bound(x_bytes + part_bytes)[0],
                bound_norm=bound(2 * x_bytes + part_bytes + 2 * c * x.element_size())[0])
            res["bound_moved"] = res["bound_stats"] + res["bound_norm"]
            detail = (f" | stats max_abs_err {r['stats_err']:.3e} norm max_abs_err "
                      f"{r['norm_err']:.3e}; gn_stats {res['ms_stats']:.4f} ms single "
                      f"{res['graph_stats']:.4f} device (plain {res['plain_stats']:.4f}, "
                      f"torch.var_mean {res['stock_stats']:.4f} single "
                      f"{res['stock_graph_stats']:.4f} device), gn_norm {res['ms_norm']:.4f} ms "
                      f"single {res['graph_norm']:.4f} device (plain {res['plain_norm']:.4f})")
        log(f"gn {label:28s} {shape} eps {eps:g} silu {silu} {plan.kernel} slab {plan.slab} "
            f"chunks {plan.chunks} threads {plan.threads}: max_abs_err {res['err']:.3e} (bound "
            f"{BF16_TOL * r['mag']:.3e}) | single launches: kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms F.group_norm{'+silu' if silu else ''} {stock_ms:.4f} ms | "
            f"20 launches as a CUDA graph (device alone): kernel {dev:.4f} ms library "
            f"{stock_dev:.4f} ms | host per call: kernel {host:.1f} us library "
            f"{stock_host:.1f} us | least by bytes: the function {bound_fn:.4f} ms, what the "
            f"kernels move {res['bound_moved']:.4f} ms | {res['launches']} launches a request"
            f"{detail}")
        results[label] = res

    # each kernel at a shape of the other's regime
    cases = {case[0]: case for case in GN_CASES}
    for label, forced in GN_FORCED:
        _, shape, groups, eps, silu, _ = cases[label]
        x, scale, bias = gn_inputs(gen, shape)
        plan = G.plan_for(x, groups, forced)
        r = check_gn_case(G, x, scale, bias, groups, eps, silu, plan, BF16_TOL)
        dev = graph_ms(r["run"])
        log(f"gn forced {forced} at {label} {shape} slab {plan.slab} chunks {plan.chunks} threads "
            f"{plan.threads}: max_abs_err {r['err']:.3e} stats max_abs_err {r['stats_err']:.3e} "
            f"| device {dev:.4f} ms against {results[label]['graph_ms']:.4f} ms of the "
            f"{results[label]['kernel']} kernel the plan takes")
        results[f"forced {forced} {label}"] = dict(kernel=forced, err=r["err"],
                                                   stats_err=r["stats_err"],
                                                   norm_err=r["norm_err"], graph_ms=dev)

    # fp32, both kernels
    for kernel_name in ("fused", "split"):
        x, scale, bias = gn_inputs(gen, (2, 320, 64, 64), torch.float32)
        plan = G.plan_for(x, 32, kernel_name)
        r = check_gn_case(G, x, scale, bias, 32, 1e-5, True, plan, FP32_TOL)
        log(f"gn fp32 (2, 320, 64, 64) {kernel_name} slab {plan.slab} chunks {plan.chunks}: "
            f"max_abs_err {r['err']:.3e} (bound {FP32_TOL * r['mag']:.3e}) stats max_abs_err "
            f"{r['stats_err']:.3e}")
        results[f"fp32 {kernel_name}"] = dict(kernel=kernel_name, err=r["err"],
                                              stats_err=r["stats_err"], norm_err=r["norm_err"])
    results["adversarial rstd rel_err"] = check_gn_adversarial(G, gen)

    # a map past 2^31 bytes (a batch-32 decode's 32x128x512x512, 2.1 GB): its
    # first and last samples against the plain version of each alone
    x, scale, bias = gn_inputs(gen, (32, 128, 512, 512))
    out = G.group_norm_silu(x, scale, bias, 32, 1e-6, True)
    errs = [max_err(out[i:i + 1], G.gn_silu_plain(x[i:i + 1], scale, bias, 32, 1e-6, True))
            for i in (0, 31)]
    plan = G.plan_for(x, 32)
    log(f"gn 2.1 GB map (32, 128, 512, 512) {plan.kernel} chunks {plan.chunks}: max_abs_err of "
        f"the first and last sample {errs[0][0]:.3e}, {errs[1][0]:.3e} (bound "
        f"{BF16_TOL * errs[0][1]:.3e})")
    if any(err > BF16_TOL * mag for err, mag in errs):
        raise AssertionError(f"gn 2.1 GB map: error above bound: {errs}")
    worst = max(err for err, _ in errs)
    results["2.1 GB map"] = dict(kernel=plan.kernel, err=worst, stats_err=0.0, norm_err=worst)
    del x, out
    torch.cuda.empty_cache()

    path = [results[case[0]] for case in GN_CASES]
    sums = {k: sum(r["launches"] * r[k] for r in path)
            for k in ("graph_ms", "stock_graph_ms", "bound_fn", "bound_moved")}
    launches = sum(r["launches"] * (1 if r["kernel"] == "fused" else 2) for r in path)
    log(f"gn per 512x512 25-step request ({sum(r['launches'] for r in path)} GroupNorms, "
        f"{launches} launches): kernels {sums['graph_ms']:.3f} ms of device time, "
        f"F.group_norm(+silu) in the same memory format {sums['stock_graph_ms']:.3f} ms; least "
        f"by bytes: the function {sums['bound_fn']:.3f} ms, what the kernels move "
        f"{sums['bound_moved']:.3f} ms")
    results["per request"] = dict(launches=launches, **sums)
    for what, calls in (("batcher step at 8 slots (UNet batch 16)", {"unet16": 1}),
                        ("VAE encode", {"encode": 1}), ("VAE decode", {"decode": 1}),
                        ("SDXL UNet call (CFG batch 2, 128x128)", {"sdxl": 1}),
                        ("1024x1024 VAE decode", {"decode1024": 1}),
                        ("video UNet call (CFG batch 32, with its motion modules)", {"video": 1}),
                        (f"VAE decode of {VIDEO_DECODE_CHUNK} frames", {"decode8": 1})):
        n = {case[0]: gn_launches(case[5], **calls) for case in GN_CASES}
        log(f"gn per {what}: {sum(n.values())} GroupNorms, kernels "
            f"{sum(k * results[label]['graph_ms'] for label, k in n.items()):.3f} ms of device "
            f"time, F.group_norm(+silu) "
            f"{sum(k * results[label]['stock_graph_ms'] for label, k in n.items()):.3f} ms, least "
            f"by bytes {sum(k * results[label]['bound_fn'] for label, k in n.items()):.3f} ms")
    return results


def rel_max_err(out, ref) -> float:
    """max |out - ref| / max |ref| in fp32."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    return ((out - ref).abs().max() / ref.abs().max()).item()


def off_alignment(t, off: int):
    """A contiguous copy of t whose first element lies `off` elements past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    out = flat[off:].view(t.shape)
    out.copy_(t)
    return out


def launch_floor_ms() -> float:
    """Device time of an empty kernel's launch, as `graph_ms` times the
    kernels: 20 launches in a CUDA graph."""
    from adaface_tpu_torch.ops import _build

    return graph_ms(lambda: _build.launch_floor(torch.cuda.current_stream().cuda_stream))


def graph_replays_same_bits(fn) -> bool:
    """Capture one call of `fn` (→ a tuple of tensors) in a CUDA graph, replay
    it twice, and compare both replays' outputs with an eager call's, bit for
    bit."""
    eager = [t.clone() for t in fn()]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    replays = []
    for _ in range(2):
        for t in out:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in out])
    return all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(eager, replays[0], replays[1]))


def check_bn(gen) -> dict:
    from adaface_tpu_torch.ops import fused_norm as N

    results = {}
    floor = launch_floor_ms()
    log(f"launch floor: an empty kernel takes {floor * 1e3:.2f} us of device time a launch "
        f"(20 launches in a CUDA graph)")
    for label, r, c, slope, dtype, per_step in BN_CASES:
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        x = (torch.randn((r, c), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
        scale = torch.randn((c,), generator=gen, device="cuda") + 1.0
        bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
        plan = N.plan_for(x)
        mean, rstd = N.bn_stats(x, BN_EPS)
        mean_p, rstd_p = N.bn_stats_plain(x, BN_EPS)
        stats_err = max(rel_max_err(mean, mean_p), rel_max_err(rstd, rstd_p))
        stats_abs = max(max_err(mean, mean_p)[0], max_err(rstd, rstd_p)[0])
        # two runs, and the kernel's arithmetic in plain PyTorch
        again = N.bn_stats(x, BN_EPS)
        same_bits = torch.equal(mean, again[0]) and torch.equal(rstd, again[1])
        mean_c, rstd_c = N.bn_stats_chunked(x, BN_EPS, plan)
        mirror_err = max(rel_max_err(mean, mean_c), rel_max_err(rstd, rstd_c))
        mirror_bits = torch.equal(mean, mean_c) and torch.equal(rstd, rstd_c)
        # the normalize pass on the same statistics, then the pair
        norm_err, mag = max_err(N.bn_norm_act(x, mean_p, rstd_p, scale, bias, slope),
                                N.bn_norm_act_plain(x, mean_p, rstd_p, scale, bias, slope))
        err, mag_full = max_err(N.fused_bn_act(x, scale, bias, slope, BN_EPS),
                                N.fused_bn_act_plain(x, scale, bias, slope, BN_EPS))
        torch.cuda.synchronize()
        ms_stats = median_ms(lambda: N.bn_stats(x, BN_EPS))
        plain_stats = median_ms(lambda: N.bn_stats_plain(x, BN_EPS))
        ms_norm = median_ms(lambda: N.bn_norm_act(x, mean, rstd, scale, bias, slope))
        plain_norm = median_ms(lambda: N.bn_norm_act_plain(x, mean, rstd, scale, bias, slope))
        ms = median_ms(lambda: N.fused_bn_act(x, scale, bias, slope, BN_EPS))
        plain_ms = median_ms(lambda: N.fused_bn_act_plain(x, scale, bias, slope, BN_EPS))
        x4 = x.t()[None, :, :, None]  # [1, C, R, 1], channels-last strides
        stock_ms = median_ms(lambda: F.leaky_relu(
            F.batch_norm(x4, None, None, scale, bias, training=True, eps=BN_EPS), slope))
        # one library call that computes bn_stats' function (mean, 1/std)
        stock_stats = median_ms(lambda: torch.batch_norm_stats(x, BN_EPS))
        # the same as 20 launches in a CUDA graph: the device alone
        dev_stats = graph_ms(lambda: N.bn_stats(x, BN_EPS))
        dev_norm = graph_ms(lambda: N.bn_norm_act(x, mean, rstd, scale, bias, slope))
        dev = graph_ms(lambda: N.fused_bn_act(x, scale, bias, slope, BN_EPS))
        stock_dev_stats = graph_ms(lambda: torch.batch_norm_stats(x, BN_EPS))
        stock_dev = graph_ms(lambda: F.leaky_relu(
            F.batch_norm(x4, None, None, scale, bias, training=True, eps=BN_EPS), slope))
        host, stock_host = (host_us(lambda: N.bn_stats(x, BN_EPS)),
                            host_us(lambda: torch.batch_norm_stats(x, BN_EPS)))
        x_bytes = x.numel() * x.element_size()
        bound_stats, _ = bound(x_bytes + 2 * c * 4)
        bound_norm, _ = bound(2 * x_bytes + 4 * c * 4)
        log(f"bn {label:20s} R{r} C{c} slope {slope:g} {dtype} x{per_step} a step, plan vec "
            f"{plan.vec} threads {plan.threads} lanes {plan.lanes} chunks {plan.chunks}: stats "
            f"rel_err {stats_err:.3e} (bound {FP32_TOL:g}), against its arithmetic in plain "
            f"PyTorch {mirror_err:.3e} (same bits: {mirror_bits}), two runs same bits: "
            f"{same_bits}; norm max_abs_err {norm_err:.3e} (bound {tol * mag:.3e}) "
            f"full max_abs_err {err:.3e} | stats {ms_stats:.3f} ms (plain {plain_stats:.3f}, "
            f"torch.batch_norm_stats {stock_stats:.3f}) "
            f"norm {ms_norm:.3f} ms (plain {plain_norm:.3f}) full {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms stock {stock_ms:.3f} ms | device alone (CUDA graph): stats "
            f"{dev_stats:.4f} ms (torch.batch_norm_stats {stock_dev_stats:.4f}) norm "
            f"{dev_norm:.4f} ms full {dev:.4f} ms (stock {stock_dev:.4f}) | host per call: "
            f"stats {host:.1f} us torch.batch_norm_stats {stock_host:.1f} us | least, by bytes: "
            f"stats {bound_stats:.4f} ms norm {bound_norm:.4f} ms")
        if not same_bits:
            raise AssertionError(f"bn {label}: two runs of bn_stats differ")
        if (stats_err > FP32_TOL or mirror_err > FP32_SUM_TOL or norm_err > tol * mag
                or err > tol * mag_full):
            raise AssertionError(f"bn {label}: error above bound")
        results[label] = dict(stats_err=stats_err, stats_abs=stats_abs, norm_err=norm_err,
                              mirror_err=mirror_err, mirror_bits=mirror_bits,
                              err=err, ms_stats=ms_stats, plain_stats=plain_stats,
                              ms_norm=ms_norm, plain_norm=plain_norm, ms=ms, plain_ms=plain_ms,
                              stock_ms=stock_ms, stock_stats=stock_stats,
                              graph_stats=dev_stats, graph_norm=dev_norm, graph_ms=dev,
                              stock_graph_stats=stock_dev_stats, stock_graph_ms=stock_dev,
                              host_us=host, stock_host_us=stock_host,
                              bound_stats=bound_stats, bound_norm=bound_norm,
                              launches=per_step, plan=dataclasses.asdict(plan))

    sums = {k: sum(r["launches"] * r[k] for r in results.values())
            for k in ("graph_stats", "stock_graph_stats", "bound_stats", "graph_norm",
                      "bound_norm", "graph_ms", "stock_graph_ms")}
    log(f"bn per train step ({BISENET_BNS} BNs): bn_stats {sums['graph_stats']:.4f} ms of "
        f"device time (torch.batch_norm_stats {sums['stock_graph_stats']:.4f}, least "
        f"{sums['bound_stats']:.4f}), bn_norm_act {sums['graph_norm']:.4f} ms (least "
        f"{sums['bound_norm']:.4f}), the pair {sums['graph_ms']:.4f} ms (F.batch_norm + "
        f"F.leaky_relu {sums['stock_graph_ms']:.4f})")

    # the instances no path reaches: single channels (C off a pack, a pointer
    # off 16 bytes) and channel tiles (C over a block's lanes)
    for label, r, c, dtype, off in BN_SCALAR_CASES:
        x = off_alignment((torch.randn((r, c), generator=gen, device="cuda") * 2.0 + 0.5)
                          .to(dtype), off)
        plan = N.plan_for(x)
        mean, rstd = N.bn_stats(x, BN_EPS)
        again = N.bn_stats(x, BN_EPS)
        mean_p, rstd_p = N.bn_stats_plain(x, BN_EPS)
        stats_err = max(rel_max_err(mean, mean_p), rel_max_err(rstd, rstd_p))
        same_bits = torch.equal(mean, again[0]) and torch.equal(rstd, again[1])
        dev = graph_ms(lambda: N.bn_stats(x, BN_EPS))
        log(f"bn off the path, {label}: R{r} C{c} {dtype} pointer % 16 = {x.data_ptr() % 16}, "
            f"plan vec {plan.vec} threads {plan.threads} lanes {plan.lanes} chunks "
            f"{plan.chunks} x {plan.grid(c)[1]} channel tiles: stats rel_err {stats_err:.3e} "
            f"(bound {FP32_TOL:g}), two runs same bits: {same_bits}, device {dev:.4f} ms")
        if (plan.vec != 1 and off) or stats_err > FP32_TOL or not same_bits:
            raise AssertionError(f"bn off the path, {label}: wrong instance, error above bound "
                                 "or two runs differ")
        results[f"off path: {label}"] = dict(stats_err=stats_err, graph_stats=dev)

    # mean 100, deviation 1: E[x^2] - mean^2 in fp32 loses digits of rstd by
    # design (the TPU kernel's formula), so rstd is reported against fp64
    # beside the plain version's, and only the mean is bounded
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((50176, 128), generator=gen, device="cuda") + 100.0).to(dtype)
        mean, rstd = N.bn_stats(x, BN_EPS)
        _, rstd_p = N.bn_stats_plain(x, BN_EPS)
        xd = x.double()
        want_mean = xd.mean(0)
        want_rstd = torch.rsqrt(xd.var(0, unbiased=False) + BN_EPS)
        mean_rel = ((mean - want_mean).abs() / want_mean.abs()).max().item()
        rstd_rel = ((rstd - want_rstd).abs() / want_rstd).max().item()
        plain_rel = ((rstd_p - want_rstd).abs() / want_rstd).max().item()
        log(f"bn mean 100 deviation 1 R50176 C128 {dtype}: mean rel_err {mean_rel:.3e} against "
            f"fp64 (bound {FP32_TOL:g}); rstd rel_err {rstd_rel:.3e} against fp64, not bounded "
            f"(the plain version's: {plain_rel:.3e})")
        if not mean_rel <= FP32_TOL or not torch.isfinite(rstd).all():
            raise AssertionError(f"bn adversarial {dtype}: mean off by {mean_rel}")
        results[f"adversarial {dtype}"] = dict(mean_rel=mean_rel, rstd_rel=rstd_rel,
                                               plain_rstd_rel=plain_rel)
    results["per step"] = sums
    results["launch floor"] = floor
    return results


def check_ln(gen) -> dict:
    from adaface_tpu_torch.ops import fused_ln as L

    results = {}
    floor = launch_floor_ms()

    def inputs(rows, c, dtype, off=0):
        x = (torch.randn((rows, c), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
        w = (torch.randn((c,), generator=gen, device="cuda") + 1.0).to(dtype)
        b = (torch.randn((c,), generator=gen, device="cuda") * 0.1).to(dtype)
        return off_alignment(x, off), w, b

    for label, rows, c, dtype, per_call in LN_CASES:
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        x, w, b = inputs(rows, c, dtype)
        plan = L.ln_plan(rows, c, dtype,
                         torch.cuda.get_device_properties(0).multi_processor_count)
        out = L.layer_norm(x, w, b, 1e-5)
        err, mag = max_err(out, L.layer_norm_plain(x, w, b, 1e-5))
        same_bits = torch.equal(out, L.layer_norm(x, w, b, 1e-5))
        torch.cuda.synchronize()
        kernel = lambda: L.layer_norm(x, w, b, 1e-5)
        stock = lambda: F.layer_norm(x, (c,), w, b, 1e-5)
        ms = median_ms(kernel)
        plain_ms = median_ms(lambda: L.layer_norm_plain(x, w, b, 1e-5))
        stock_ms = median_ms(stock)
        dev, stock_dev = graph_ms(kernel), graph_ms(stock)
        host, stock_host = host_us(kernel), host_us(stock)
        bound_ms, _ = bound((2 * x.numel() + 2 * c) * x.element_size())
        launches = UNET_CALLS * per_call
        log(f"ln {label:16s} [{rows}, {c}] {dtype} x{launches} a fused-LN request, plan "
            f"{plan.warps} warps x {plan.lanes} lanes x {plan.packs} packs a row, "
            f"{plan.threads} threads, {plan.blocks(rows)} blocks: max_abs_err {err:.3e} "
            f"(bound {tol * mag:.3e}), two runs same bits: {same_bits}; kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms "
            f"stock {stock_ms:.3f} ms | device alone (CUDA graph): kernel {dev:.4f} ms stock "
            f"{stock_dev:.4f} ms | host per call: kernel {host:.1f} us stock {stock_host:.1f} "
            f"us | least, by bytes: {bound_ms:.4f} ms; an empty kernel's launch: {floor:.4f} ms")
        if err > tol * mag or not same_bits or plan.packs == 0:
            raise AssertionError(f"ln {label}: error {err} above bound, two runs differ, or "
                                 "the row is not held in registers")
        results[label] = dict(err=err, ms=ms, plain_ms=plain_ms, stock_ms=stock_ms,
                              graph_ms=dev, stock_graph_ms=stock_dev, bound_ms=bound_ms,
                              host_us=host, stock_host_us=stock_host, launches=launches,
                              plan=dataclasses.asdict(plan))

    sums = {k: sum(r["launches"] * r[k] for r in results.values())
            for k in ("graph_ms", "stock_graph_ms", "bound_ms")}
    n = sum(r["launches"] for r in results.values())
    log(f"ln per fused-LN 512x512 25-step request ({n} launches): kernel "
        f"{sums['graph_ms']:.3f} ms of device time, F.layer_norm {sums['stock_graph_ms']:.3f} "
        f"ms, least by bytes {sums['bound_ms']:.3f} ms, {n} empty launches {n * floor:.3f} ms")

    # off the path: the looped kernel (single channels and 16-byte packs) and
    # register instances of other widths
    for label, rows, c, dtype, off in LN_OFF_PATH_CASES:
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        x, w, b = inputs(rows, c, dtype, off)
        plan = L.ln_plan(rows, c, dtype, 132, x.data_ptr() % 16 == 0)
        out = L.layer_norm(x, w, b, 1e-5)
        err, mag = max_err(out, L.layer_norm_plain(x, w, b, 1e-5))
        same_bits = torch.equal(out, L.layer_norm(x, w, b, 1e-5))
        dev = graph_ms(lambda: L.layer_norm(x, w, b, 1e-5))
        log(f"ln off the path, {label}: [{rows}, {c}] {dtype} pointer % 16 = "
            f"{x.data_ptr() % 16}, plan {plan.warps} warps x {plan.lanes} lanes x {plan.packs} "
            f"packs a row: max_abs_err "
            f"{err:.3e} (bound {tol * mag:.3e}), two runs same bits: {same_bits}, device "
            f"{dev:.4f} ms")
        if err > tol * mag or not same_bits or (plan.packs == 0) != ("looped" in label):
            raise AssertionError(f"ln off the path, {label}: error above bound, two runs "
                                 "differ, or the wrong kernel")
        results[f"off path: {label}"] = dict(err=err, graph_ms=dev)
    results["per request"] = dict(launches=n, **sums)
    results["launch floor"] = floor
    return results


def check_graph_capture(gen) -> None:
    """`bn_stats` and `layer_norm` captured in one CUDA graph and replayed
    twice: the same bits as an eager call, at a path shape of each."""
    from adaface_tpu_torch.ops import fused_ln as L
    from adaface_tpu_torch.ops import fused_norm as N

    _, r, c, _, _, _ = BN_CASES[2]
    xb = torch.randn((r, c), generator=gen, device="cuda") * 2.0 + 0.5
    _, rows, cl, dtype, _ = LN_CASES[0]
    xl = (torch.randn((rows, cl), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
    w = (torch.randn((cl,), generator=gen, device="cuda") + 1.0).to(dtype)
    b = (torch.randn((cl,), generator=gen, device="cuda") * 0.1).to(dtype)

    def both():
        mean, rstd = N.bn_stats(xb, BN_EPS)
        mean2, rstd2 = N.bn_stats(xb, BN_EPS)  # the ticket is back at 0 for the second
        return mean, rstd, mean2, rstd2, L.layer_norm(xl, w, b, 1e-5)

    same = graph_replays_same_bits(both)
    log(f"CUDA graph: bn_stats (R{r} C{c}, twice) and layer_norm ([{rows}, {cl}]) captured and "
        f"replayed twice, same bits as eager: {same}")
    if not same:
        raise AssertionError("a replayed CUDA graph of bn_stats and layer_norm differs from "
                             "the eager call")


def check_bn_backward(gen) -> dict:
    """The BN Function's gradients (x, scale, bias) on the kernels' residuals
    against the plain versions', for one upstream gradient, at the fp32 path
    shapes."""
    from adaface_tpu_torch.ops import fused_norm as N

    results = {}
    for label, r, c, slope, dtype, _ in BN_CASES:
        if dtype != torch.float32:
            continue
        x = torch.randn((r, c), generator=gen, device="cuda") * 2.0 + 0.5
        scale = torch.randn((c,), generator=gen, device="cuda") + 1.0
        bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
        g = torch.randn((r, c), generator=gen, device="cuda")

        def grads():
            leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
            N.fused_bn_act(*leaves, slope, BN_EPS).backward(g)
            return [t.grad for t in leaves]

        kernel = grads()
        with plain_versions():
            plain = grads()
        rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(kernel, plain))
        log(f"bn backward {label:20s} R{r} C{c} slope {slope:g}: gradients rel L2 max "
            f"{rel:.3e} (bound {GRAD_REL_TOL:g})")
        if not rel <= GRAD_REL_TOL:
            raise AssertionError(f"bn backward {label}: rel L2 {rel} above bound")
        results[label] = rel
    return results


def check_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        flash = check_flash(gen)
        flash["combine"] = check_flash_combine(gen)
        gn, bn, ln = check_gn(gen), check_bn(gen), check_ln(gen)
        check_graph_capture(gen)
        flash["stats"] = check_flash_stats(gen)
    # the library's backward, the yardstick of these two, needs grad mode
    flash_bwd, gn_bwd = check_flash_bwd(gen), check_gn_bwd(gen)
    check_bn_backward(gen)
    return flash, gn, bn, ln, flash_bwd, gn_bwd


@contextmanager
def plain_versions():
    """Route the port's kernel wrappers to their plain versions on CUDA
    tensors, for the kernel-against-plain comparisons of whole modules."""
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import fused_gn as G
    from adaface_tpu_torch.ops import fused_ln as L
    from adaface_tpu_torch.ops import fused_norm as N
    from adaface_tpu_torch.ops import quant as Q

    def flash_plain(q, k, v, kv_mask=None, causal=False, scale=None):
        return A.scaled_dot_product_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                                              scale=scale)

    with mock.patch.object(A, "flash_attention", flash_plain), \
            mock.patch.object(G, "group_norm_silu", G.gn_silu_plain), \
            mock.patch.object(L, "layer_norm", L.layer_norm_plain), \
            mock.patch.object(N, "bn_stats", N.bn_stats_plain), \
            mock.patch.object(N, "bn_norm_act", N.bn_norm_act_plain), \
            mock.patch.object(Q, "int8_conv2d", Q.int8_conv2d_plain), \
            mock.patch.object(Q, "int8_dense", Q.int8_dense_plain):
        yield


def launch_counts() -> dict:
    from adaface_tpu_torch.ops import _build

    return dict(_build.LAUNCHES)


def gn_expected(**calls) -> dict:
    """Launches of each GroupNorm kernel that `gn_plan` predicts on this card
    for `calls` of each path of GN_CASES (`unet`, `unet16`, `decode`,
    `encode`): one `gn_fused` launch for a map the plan gives the one-launch
    kernel, one `gn_stats` and one `gn_norm` for each of the rest."""
    from adaface_tpu_torch.ops.fused_gn import GN_FUSED, GN_NORM, GN_STATS, gn_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = {GN_FUSED: 0, GN_STATS: 0, GN_NORM: 0}
    for _, (b, c, h, w), groups, _, _, by_path in GN_CASES:
        n = gn_launches(by_path, **calls)
        if gn_plan(torch.bfloat16, b, c, h * w, groups, sms).kernel == "fused":
            want[GN_FUSED] += n
        else:
            want[GN_STATS] += n
            want[GN_NORM] += n
    return want


def expect_counts(counts: dict, unet_calls: int = 0, decodes: int = 0,
                  fused_ln_calls: int = 0, bisenet_forwards: int = 0,
                  unet16_calls: int = 0, encodes: int = 0):
    """30 launches of the wgmma flash kernel per UNet call, at CFG batch 2
    (`unet_calls`) and at batch 16 (`unet16_calls`) alike (20 at head dim
    40/80, 10 at 160), and 1 of the wide-head kernel per VAE decode or encode
    (D 512), the latter followed by one launch of the combine kernel where
    this card's SM count makes the wrapper split the keys (132 SMs: 2
    splits); no launch of a flash kernel under another key (the wide kernel
    in the UNet, the fp32 kernel anywhere); 61 GroupNorms per UNet call, 30
    per decode, 22 per encode, each under the key of the kernel `gn_plan`
    gives its shape (132 SMs: every one of the UNet's and the VAE's 64x64
    maps in one `gn_fused` launch, its larger maps as `gn_stats` + `gn_norm`);
    48 LayerNorm launches per UNet call in the fused-LN configuration (16
    transformer blocks x 3), 0 in the default one; one bn_stats and one
    bn_norm_act launch for each of the 31 train-mode BNs of a BiSeNet
    forward. No other launch."""
    from adaface_tpu_torch.ops.attention import (FLASH_COMBINE, FLASH_STD, FLASH_T, FLASH_WIDE,
                                                 flash_plan)
    from adaface_tpu_torch.ops.fused_ln import LAYER_NORM
    from adaface_tpu_torch.ops.fused_norm import BN_NORM_ACT, BN_STATS

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    vae_plan = flash_plan(torch.bfloat16, *FLASH_CASES[-1][1:], sms)
    for case in FLASH_CASES[:-1] + FLASH_CASES_B16:
        if flash_plan(torch.bfloat16, *case[1:], sms).variant != "wg":
            raise AssertionError(f"flash {case[0]}: the plan leaves the wgmma kernel")
    all_unet = unet_calls + unet16_calls
    want = {FLASH_T: 20 * all_unet, FLASH_STD: 10 * all_unet, FLASH_WIDE: decodes + encodes,
            FLASH_COMBINE: (decodes + encodes) * (vae_plan.nsplit > 1),
            **gn_expected(unet=unet_calls, unet16=unet16_calls, decode=decodes, encode=encodes),
            LAYER_NORM: 48 * fused_ln_calls,
            BN_STATS: BISENET_BNS * bisenet_forwards,
            BN_NORM_ACT: BISENET_BNS * bisenet_forwards}
    want = {k: v for k, v in want.items() if v}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")


@contextmanager
def census(module, cls, key):
    """Count `key(submodule, args, kwargs)` over every forward call of a
    submodule of class `cls` inside `module` while the block runs (None is
    not counted); yields the counter."""
    import collections

    seen: collections.Counter = collections.Counter()

    def hook(mod, args, kwargs):
        k = key(mod, args, kwargs)
        if k is not None:
            seen[k] += 1

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in module.modules() if isinstance(m, cls)]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def gn_census(module):
    """The (shape, eps, SiLU) of every GroupNorm call inside `module`."""
    from adaface_tpu_torch.ops.fused_gn import GroupNorm

    return census(module, GroupNorm, lambda mod, args, kwargs: (
        tuple(args[0].shape), mod.eps, bool(kwargs.get("silu", False))))


def ln_census(module):
    """The (rows, C) of every kernel LayerNorm call inside `module`."""
    from adaface_tpu_torch.ops.fused_ln import LayerNorm

    return census(module, LayerNorm, lambda mod, args, kwargs: (
        args[0].numel() // args[0].shape[-1], args[0].shape[-1]))


def bn_census(module):
    """The (R, C) of every train-mode BN input inside `module`."""
    from adaface_tpu_torch.models.bisenet import BatchNormAct

    return census(module, BatchNormAct, lambda mod, args, kwargs: (
        (args[0].numel() // args[0].shape[1], args[0].shape[1]) if mod.training else None))


def expect_census(seen: dict, unet_calls: int = 0, decodes: int = 0, unet16_calls: int = 0,
                  encodes: int = 0, **calls):
    """The GroupNorms a module really ran against GN_CASES, the table the
    per-request sums are taken over; `calls`: those of the other paths
    (`sdxl`, `decode1024`)."""
    want = collections.Counter()
    for _, shape, _, eps, silu, by_path in GN_CASES:  # SDXL's paths repeat some shapes
        want[(shape, eps, silu)] += gn_launches(by_path, unet=unet_calls, unet16=unet16_calls,
                                                decode=decodes, encode=encodes, **calls)
    want = {k: v for k, v in want.items() if v}
    if dict(seen) != want:
        raise AssertionError(f"GroupNorm calls {dict(seen)}, expected {want}")


def expect_bn_census(seen: dict, forwards: int):
    """The BNs a BiSeNet really ran against BN_CASES, the table the per-step
    sums are taken over."""
    want = {(r, c): per_step * forwards for _, r, c, _, _, per_step in BN_CASES if per_step}
    if dict(seen) != want:
        raise AssertionError(f"BN calls {dict(seen)}, expected {want}")


def check_unet(gen) -> dict:
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.models.unet import (SD15_UNET, UNet2DConditionModel,
                                               init_unet_weights_)
    from adaface_tpu_torch.ops import _build

    unet = build(lambda: UNet2DConditionModel(dataclasses.replace(SD15_UNET, fused_ln=False)),
                 "cuda", torch.bfloat16, init_unet_weights_, gen)
    x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.full((2,), 501, dtype=torch.long, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        _build.reset_launch_counts()
        with gn_census(unet) as seen:
            eps = unet(x, t, ctx).float()
        torch.cuda.synchronize()
        expect_counts(launch_counts(), unet_calls=1, decodes=0)
        expect_census(seen, unet_calls=1)
        with plain_versions():
            ref = unet(x, t, ctx).float()
            plain_ms = median_ms(lambda: unet(x, t, ctx), reps=5)
        ms = median_ms(lambda: unet(x, t, ctx), reps=5)
        cats = device_operations(lambda: unet(x, t, ctx), r"CatArray")
    if not torch.isfinite(eps).all():
        raise AssertionError("UNet output is not finite")
    # one for the timestep embedding, one a skip connection: none of weights
    skip_cats = sum(len(blk.resnets) for blk in unet.up_blocks)
    log(f"unet SD1.5 CFG batch 2 64x64: {cats[0]} concatenations a call, {cats[1]:.4f} ms of "
        f"device time (1 timestep embedding + {skip_cats} skip connections; none of weights)")
    if cats[0] != 1 + skip_cats:
        raise AssertionError(f"UNet call: {cats[0]} concatenations, expected {1 + skip_cats}")
    rel = ((eps - ref).norm() / ref.norm()).item()
    log(f"unet SD1.5 CFG batch 2 64x64: rel_err {rel:.3e} (bound {UNET_REL_TOL:g}) "
        f"kernels {ms:.1f} ms plain {plain_ms:.1f} ms")
    if rel > UNET_REL_TOL:
        raise AssertionError(f"UNet kernels against plain: rel_err {rel} above bound")

    # the fused-LN configuration, same weights
    state = unet.state_dict()
    unet_ln = build(lambda: UNet2DConditionModel(dataclasses.replace(SD15_UNET, fused_ln=True)),
                    "cuda", torch.bfloat16, lambda m, _: m.load_state_dict(state), gen)
    with torch.inference_mode():
        _build.reset_launch_counts()
        with ln_census(unet_ln) as seen_ln:
            eps_ln = unet_ln(x, t, ctx).float()
        torch.cuda.synchronize()
        ln_counts = launch_counts()
        expect_counts(ln_counts, unet_calls=1, fused_ln_calls=1)
        want_ln = {(rows, c): n for _, rows, c, _, n in LN_CASES if n}
        if dict(seen_ln) != want_ln:
            raise AssertionError(f"LayerNorm calls {dict(seen_ln)}, expected {want_ln}")
        with plain_versions():
            ref_ln = unet_ln(x, t, ctx).float()
        # in turns: default, fused LN, fused LN, default
        ms_turns = [median_ms(lambda: m(x, t, ctx), reps=5)
                    for m in (unet, unet_ln, unet_ln, unet)]
    if not torch.isfinite(eps_ln).all():
        raise AssertionError("fused-LN UNet output is not finite")
    rel_ln = ((eps_ln - ref_ln).norm() / ref_ln.norm()).item()
    log(f"unet SD1.5 fused-LN CFG batch 2 64x64: rel_err {rel_ln:.3e} (bound {UNET_REL_TOL:g}); "
        f"call with the LN kernel {ms_turns[1]:.1f}, {ms_turns[2]:.1f} ms, without it "
        f"{ms_turns[0]:.1f}, {ms_turns[3]:.1f} ms; launches {ln_counts}")
    if rel_ln > UNET_REL_TOL:
        raise AssertionError(f"fused-LN UNet kernels against plain: rel_err {rel_ln} above bound")
    del unet, unet_ln, state
    torch.cuda.empty_cache()
    return dict(rel=rel, ms=ms, plain_ms=plain_ms, rel_ln=rel_ln, ms_turns=ms_turns,
                ln_counts=ln_counts)


def check_autograd_functions() -> None:
    """On CUDA bf16 tensors that require grad, `flash_attention` and
    `group_norm_silu` record their Functions, whose backward launches the
    backward kernels (no dq where q needs none; GroupNorm's from the
    statistics its forward kept, one map a cluster holds and one it does not,
    no `gn_stats`) and gives finite gradients equal to the backward kernels'
    called directly; an fp32 flash input that
    requires grad raises at the forward, naming the missing fp32 backward;
    under `torch.no_grad()` both launch only their forward kernels."""
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import fused_gn as G

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q0, k0, v0 = flash_inputs(gen, "self", 1, 8, 256, 256, 40)
    with torch.enable_grad():
        for q_grad in (True, False):
            q, k, v = q0.detach().requires_grad_(q_grad), k0.detach().requires_grad_(), v0
            _build.reset_launch_counts()
            out = A.flash_attention(q, k, v)
            if type(out.grad_fn).__name__ != "_FlashAttentionBackward":
                raise AssertionError(f"flash_attention records {out.grad_fn}")
            g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
            out.backward(g)
            torch.cuda.synchronize()
            seen = {n: c for n, c in launch_counts().items() if c}
            # without the forward's statistics: the same bits, a forward launch more
            dq, dk, _ = A.flash_bwd(q0, k0, v0, None, out.detach(), g, False,
                                    1.0 / math.sqrt(40))
            want = {A.FLASH_T: 1, A.FLASH_BWD_DELTA: 1, A.FLASH_BWD_DKDV_WG: 1}
            if q_grad:
                want[A.FLASH_BWD_DQ_WG] = 1
            if (seen != want or not torch.equal(k.grad, dk)
                    or (q.grad is not None) != q_grad
                    or (q_grad and not torch.equal(q.grad, dq))):
                raise AssertionError(f"flash backward: launches {seen}, want {want}")
        # the forward keeps its statistics; the backward reads them, launching
        # what `gn_bwd_plan` names (one map each way) and no `gn_stats`
        for shape in ((2, 320, 8, 8), (1, 128, 128, 128)):
            x0, scale, bias = gn_inputs(gen, shape)
            x = x0.detach().requires_grad_()
            _build.reset_launch_counts()
            y = G.group_norm_silu(x, scale, bias, 32, 1e-5)
            if type(y.grad_fn).__name__ != "_GroupNormSiLUBackward":
                raise AssertionError(f"group_norm_silu records {y.grad_fn}")
            g = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
            g = g.contiguous(memory_format=torch.channels_last)
            y.backward(g)
            torch.cuda.synchronize()
            seen = {n: c for n, c in launch_counts().items() if c}
            _, stats = G._gn_forward(x0, scale, bias, 32, 1e-5, True, with_stats=True)
            dx = G.gn_silu_bwd(x0, scale, bias, g, 32, stats, True, need=(False, False))[0]
            fwd = ({G.GN_FUSED: 1} if G.plan_for(x0, 32).kernel == "fused"
                   else {G.GN_STATS: 1, G.GN_NORM: 1})
            bwd = ({G.GN_BWD_FUSED: 1} if y.grad_fn.bwd_kernel == "fused"
                   else {G.GN_BWD_REDUCE: 1, G.GN_BWD_DX: 1})
            want = dict(fwd, **bwd)
            if seen != want or not torch.equal(x.grad, dx) or not torch.isfinite(dx).all() \
                    or y.grad_fn.bwd_kernel != G.bwd_plan_for(x0, 32).kernel:
                raise AssertionError(f"group norm backward {shape}: launches {seen}, want {want}")
            log(f"autograd: group_norm_silu {shape}: launches {seen} (backward "
                f"{y.grad_fn.bwd_kernel})")
        q32 = q0.float().requires_grad_()
        try:
            A.flash_attention(q32, q32, q32)
        except RuntimeError as e:
            if "fp32 flash backward" not in str(e):
                raise
        else:
            raise AssertionError("flash_attention: no error on an fp32 input that requires grad")
        # head dim 64 (SDXL, SD3) has a forward instance and no backward one
        q64 = torch.randn((1, 2, 256, 64), generator=gen, device="cuda").to(
            torch.bfloat16).requires_grad_()
        try:
            A.flash_attention(q64, q64, q64)
        except RuntimeError as e:
            if "head dim 64" not in str(e):
                raise
        else:
            raise AssertionError("flash_attention: no error on a D 64 input that requires grad")
    _build.reset_launch_counts()
    with torch.no_grad():
        A.flash_attention(q0.detach().requires_grad_(), k0, v0)
        G.group_norm_silu(x0.detach().requires_grad_(), scale, bias, 32, 1e-5)
    torch.cuda.synchronize()
    if sum(launch_counts().values()) != 1 + sum(fwd.values()):
        raise AssertionError(f"no_grad: launches {launch_counts()}")
    log("autograd: flash_attention and group_norm_silu record their Functions on inputs that "
        "require grad; backward launches as expected (no dq without q's grad), gradients equal "
        "to the backward kernels'; fp32 and D 64 flash refused at the forward; forward only "
        "under no_grad")


REQUESTS = [  # (subject, prompt)
    ("a", "a photo of a person walking on the beach"),
    ("b", "a portrait of a person in a garden, oil painting"),
    ("a", "a person reading a book in a cafe"),
]


def build_server(gen):
    """→ (AdaFaceWrapper with random full-size bf16 weights on the card,
    {subject: face images})."""
    from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt
    from adaface_tpu_torch.inference.pipeline import PipelineModules
    from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
    from adaface_tpu_torch.text.tokenizer import default_tokenizer

    t0 = time.perf_counter()
    tok = default_tokenizer()
    modules = PipelineModules.random_init(gen, "cuda", torch.bfloat16, tokenizer=tok)
    enc = Arc2FaceID2AdaPrompt.random_init(gen, tok, "cuda",
                                           face_backend=DeterministicBackend())
    wrapper = AdaFaceWrapper("text2img", modules, enc, guidance_scale=6.0,
                             num_inference_steps=25)
    torch.cuda.synchronize()
    log(f"serve: random full-size weights on the card in {time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(SEED)
    faces = {"a": [rs.randint(0, 256, (512, 512, 3), np.uint8) for _ in range(2)],
             "b": [rs.randint(0, 256, (512, 512, 3), np.uint8)],
             "c": [rs.randint(0, 256, (512, 512, 3), np.uint8)]}
    return wrapper, faces


def serve(wrapper, faces) -> dict:
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A

    # a small request, kernels against plain versions on the same inputs
    wrapper.prepare_adaface_embeddings(images=faces["a"])
    small = dict(num_inference_steps=3, height=256, width=256)
    img_k = wrapper(REQUESTS[0][1], generator=torch.Generator("cuda").manual_seed(1), **small)
    with plain_versions():
        img_p = wrapper(REQUESTS[0][1], generator=torch.Generator("cuda").manual_seed(1),
                        **small)
    err = (img_k - img_p).abs().max().item()
    log(f"serve: 256x256 3-step request, kernels against plain: image max_abs_err "
        f"{err:.3e} (bound {IMAGE_TOL:g})")
    if err > IMAGE_TOL:
        raise AssertionError(f"request kernels against plain: error {err} above bound")

    _build.reset_launch_counts()
    A.cache_lookups(reset=True)
    latencies, images = [], []
    t_all = time.perf_counter()
    for i, (subject, prompt) in enumerate(REQUESTS):
        t0 = time.perf_counter()
        ada = wrapper.prepare_adaface_embeddings(images=faces[subject])
        with gn_census(wrapper.pipeline.m.vae) as seen:
            img = wrapper(prompt, generator=torch.Generator("cuda").manual_seed(100 + i))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        expect_census(seen, decodes=1)
        if ada is None or tuple(ada.shape) != (16, 768):
            raise AssertionError(f"request {i}: ada embeddings {None if ada is None else ada.shape}")
        if tuple(img.shape) != (1, 3, 512, 512) or not torch.isfinite(img).all():
            raise AssertionError(f"request {i}: image {tuple(img.shape)} not finite or misshaped")
        if img.min() < 0.0 or img.max() > 1.0 or img.std() == 0.0:
            raise AssertionError(f"request {i}: image outside [0, 1] or constant")
        images.append(img)
        log(f"serve: request {i} subject {subject} 512x512 25 steps: "
            f"{latencies[-1] * 1e3:.1f} ms")
    total = time.perf_counter() - t_all
    counts = launch_counts()
    lookups = A.cache_lookups()
    expect_counts(counts, unet_calls=25 * len(REQUESTS), decodes=len(REQUESTS))
    if torch.equal(images[0], images[1]):
        raise AssertionError("two subjects gave the same image")
    log(f"serve: {len(REQUESTS)} requests in {total:.2f} s: {len(REQUESTS) / total:.3f} imgs/sec, "
        f"latency per request {', '.join(f'{x * 1e3:.1f}' for x in latencies)} ms "
        f"(first includes warm-up); launches {counts}; flash cache lookups {lookups}")
    return dict(counts=counts, latencies=latencies, total=total, small_err=err,
                lookups=lookups)


# the subject photos of the request from files: fixtures of kinds the JAX
# package opens through Pillow
SERVE_FILES = ("timing_512_q80.webp", "timing_512_palette.png", "timing_512_cmyk.jpg")


def serve_from_files(wrapper) -> dict:
    """A 512x512, 25-step request whose subject photos are files: a lossy
    WebP, a palette PNG and a CMYK JPEG (fixtures of `tests/data/images/`)
    in a folder, read by `scripts/_common_torch.load_subject_images`. Each
    photo is held to the SHA-256 of Pillow's pixels, the ada embeddings from
    the folder to those from the same pixels handed over as arrays (equal),
    the request's launches to the path's counts."""
    import shutil
    import tempfile

    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.utils.image import read_image, to_rgb

    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from _common_torch import load_subject_images
    finally:
        sys.path.remove(str(REPO / "scripts"))
    digests = json.loads((FIXTURES / "digests.json").read_text())
    arrays = []
    for name in SERVE_FILES:
        px = to_rgb(read_image(FIXTURES / name))
        if list(px.shape) != digests[name]["shape"] or sha256_of(px) != digests[name]["sha256"]:
            raise AssertionError(f"serve from files: {name} differs from Pillow's pixels")
        arrays.append(px)
    ada_arrays = wrapper.prepare_adaface_embeddings(images=arrays, update_text_encoder=False)
    with tempfile.TemporaryDirectory() as folder:
        for i, name in enumerate(SERVE_FILES):
            shutil.copy(FIXTURES / name, os.path.join(folder, f"{i}_{name}"))
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        photos = load_subject_images(folder)
        load_ms = (time.perf_counter() - t0) * 1e3
        ada = wrapper.prepare_adaface_embeddings(images=photos)
        img = wrapper(REQUESTS[0][1], generator=torch.Generator("cuda").manual_seed(200))
        torch.cuda.synchronize()
        request_s = time.perf_counter() - t0
    counts = launch_counts()
    expect_counts(counts, unet_calls=25, decodes=1)
    if len(photos) != len(arrays) or not all(np.array_equal(a, b) for a, b in zip(photos, arrays)):
        raise AssertionError("serve from files: the loader's photos differ from the files' pixels")
    if ada is None or tuple(ada.shape) != (16, 768) or not torch.equal(ada, ada_arrays):
        raise AssertionError("serve from files: ada embeddings from the folder differ from those "
                             "of the same pixels handed over")
    check_images(img, 1, 512, "serve from files")
    log(f"serve from files: {', '.join(SERVE_FILES)} read by load_subject_images in "
        f"{load_ms:.1f} ms of host time, equal to Pillow's pixels; ada embeddings equal to the "
        f"arrays'; 512x512 25-step request {request_s * 1e3:.1f} ms with the read; launches "
        f"{counts}")
    return dict(counts=counts, load_ms=load_ms, request_s=request_s)


def check_images(images, n: int, hw: int, what: str) -> None:
    """`n` finite [3, hw, hw] images in [0, 1], none constant."""
    if len(images) != n:
        raise AssertionError(f"{what}: {len(images)} images, expected {n}")
    for i, img in enumerate(images):
        if tuple(img.shape) != (3, hw, hw) or not torch.isfinite(img).all():
            raise AssertionError(f"{what}: image {i} {tuple(img.shape)} not finite or misshaped")
        if img.min() < 0.0 or img.max() > 1.0 or img.std() == 0.0:
            raise AssertionError(f"{what}: image {i} outside [0, 1] or constant")


def subject_embeddings(wrapper, faces) -> dict:
    """{subject: ada embeddings [16, 768]}, the token table left as it is."""
    return {name: wrapper.prepare_adaface_embeddings(images=imgs, update_text_encoder=False)
            for name, imgs in faces.items()}


BATCH_SLOTS = 8
BATCH_REQUESTS = 12
BATCH_PROMPTS = ["a photo of a person at the beach",
                 "a portrait of a person in a library, cinematic lighting",
                 "a person riding a bike in paris",
                 "a watercolor painting of a person"]


def batch_requests(wrapper, adas: dict, hw: int, n: int):
    """`n` requests: subjects a, b, c and none in turn, guidance 6.0 and 4.0
    in turn, every third with a dual scale down to 1.5, latents from seeds;
    the first two share prompt and latents and differ in subject only. The
    request without a subject is a plain prompt, with no placeholder tokens."""
    from adaface_tpu_torch.inference.serving import Request

    s = wrapper.pipeline.m.vae.cfg.spatial_scale
    reqs = []
    for i in range(n):
        subject = ("a", "b", "c", None)[i % 4]
        shared = i < 2
        kw = dict(guidance_scale=(6.0, 4.0)[i % 2], guidance_scale_min=None if i % 3 else 1.5,
                  latents=torch.randn((4, hw // s, hw // s), device="cuda",
                                      generator=torch.Generator("cuda").manual_seed(
                                          200 if shared else 200 + i)))
        prompt = BATCH_PROMPTS[0 if shared else i % len(BATCH_PROMPTS)]
        reqs.append(Request(prompt=prompt, **kw) if subject is None else
                    wrapper.make_request(prompt, ada_embs=adas[subject], **kw))
    return reqs


def step_times(batcher, reps: int = 10) -> dict:
    """One step of a batcher whose slots are all active: the host's time to
    enqueue it (no synchronisation inside), the time between CUDA events
    around it with the device idle before (what the step takes when nothing
    overlaps), and the device's busy time and operation count by
    torch.profiler."""
    for _ in range(3):
        batcher._step()
    host, events = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        batcher._step()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        events.append(start.elapsed_time(end))
    ops, busy = device_operations(batcher._step)
    return dict(host_ms=statistics.median(host), event_ms=statistics.median(events),
                device_busy_ms=busy, device_operations=ops)


def step_replays_same_bits(batcher, replays: int = 1) -> tuple[bool, float]:
    """Capture one step of `batcher` in a CUDA graph as it is, and replay it
    `replays` times, each from the state an eager step started from →
    (whether every replay leaves every state buffer with the eager step's
    bits, ms of a replay: the step with no host in the way). The port itself
    does not capture its step; this shows that nothing in it stands in the
    way."""
    state = batcher._state.tensors()
    start = [t.clone() for t in state]
    batcher._step()
    eager = [t.clone() for t in state]
    for t, saved in zip(state, start):
        t.copy_(saved)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        batcher._step()
    same = True
    for _ in range(replays):
        for t, saved in zip(state, start):
            t.copy_(saved)
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(t, want) for t, want in zip(state, eager))
    return same, median_ms(graph.replay, reps=5)


def serve_batched(wrapper, faces) -> dict:
    """The continuous batcher at 8 slots: 12 requests for three subjects and
    none through one device batch."""
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A

    m = wrapper.pipeline.m
    adas = subject_embeddings(wrapper, faces)
    # warm-up on a batcher of its own: cuDNN and cuBLAS choose their algorithms
    # for batch 16, the flash wrapper learns the layouts
    wrapper.make_batcher(num_slots=BATCH_SLOTS, num_inference_steps=2).generate_all(
        batch_requests(wrapper, adas, 512, BATCH_SLOTS))
    torch.cuda.synchronize()

    batcher = wrapper.make_batcher(num_slots=BATCH_SLOTS)
    steps = batcher.steps
    reqs = batch_requests(wrapper, adas, 512, BATCH_REQUESTS)
    ptrs = [t.data_ptr() for t in batcher._state.tensors()]
    _build.reset_launch_counts()
    A.cache_lookups(reset=True)
    for r in reqs:
        batcher.submit(r)
    done, images = [], {}
    t0 = time.perf_counter()
    with gn_census(m.unet) as seen_unet, gn_census(m.vae) as seen_vae:
        for rid, img in batcher.run():
            images[rid] = img
            done.append(time.perf_counter() - t0)  # enqueued; the device may lag
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts, lookups = launch_counts(), A.cache_lookups()
    # 12 requests through 8 slots: two waves of `steps` steps, every step at UNet batch 16
    unet_calls = steps * -(-BATCH_REQUESTS // BATCH_SLOTS)
    expect_counts(counts, unet16_calls=unet_calls, decodes=BATCH_REQUESTS)
    expect_census(seen_unet, unet16_calls=unet_calls)
    expect_census(seen_vae, decodes=BATCH_REQUESTS)
    check_images([images[i] for i in range(BATCH_REQUESTS)], BATCH_REQUESTS, 512, "batcher")
    if (images[0] - images[1]).abs().max() <= 1e-3:
        raise AssertionError("batcher: two subjects, same prompt and latents, gave one image")
    if [t.data_ptr() for t in batcher._state.tensors()] != ptrs:
        raise AssertionError("batcher: a state buffer moved during the drain")
    log(f"batcher: {BATCH_REQUESTS} requests (subjects a, b, c and none) through "
        f"{BATCH_SLOTS} slots, 512x512, {steps} steps: {total:.2f} s, "
        f"{BATCH_REQUESTS / total:.3f} imgs/sec; {unet_calls} UNet calls at batch "
        f"{2 * BATCH_SLOTS}; state buffers kept their addresses; launches {counts}; flash cache "
        f"lookups {lookups}")

    # a step with every slot active, at 8 and at 16 slots
    times = {}
    for slots in (BATCH_SLOTS, 2 * BATCH_SLOTS):
        b = wrapper.make_batcher(num_slots=slots)
        for slot, r in enumerate(batch_requests(wrapper, adas, 512, slots)):
            b._admit(slot, r)
        times[slots] = t = step_times(b)
        t["graph_same_bits"], t["graph_ms"] = step_replays_same_bits(b)
        log(f"batcher step at {slots} slots (UNet batch {2 * slots}): host enqueues it in "
            f"{t['host_ms']:.2f} ms; {t['event_ms']:.2f} ms between CUDA events around it; "
            f"device busy {t['device_busy_ms']:.2f} ms in {t['device_operations']} operations "
            f"(torch.profiler); captured in a CUDA graph as it is, a replay takes "
            f"{t['graph_ms']:.2f} ms and leaves the state with an eager step's bits: "
            f"{t['graph_same_bits']}")
        if not t["graph_same_bits"]:
            raise AssertionError(f"batcher step at {slots} slots: a replayed CUDA graph of the "
                                 "step differs from the eager step")
        del b
    return dict(counts=counts, total=total, imgs_per_sec=BATCH_REQUESTS / total,
                lookups=lookups, step_times=times)


def batcher_against_pipeline(wrapper, faces) -> dict:
    """A small drain (2 slots, 3 steps, 256x256, 4 requests with their
    latents handed in): every image against the wrapper's one-shot image for
    the same prompt, subject and latents, and against the same drain on the
    plain versions."""
    adas = subject_embeddings(wrapper, faces)

    def drain():
        batcher = wrapper.make_batcher(num_slots=2, num_inference_steps=3, height=256,
                                       width=256)
        return batcher.generate_all(batch_requests(wrapper, adas, 256, 4))

    images = drain()
    with plain_versions():
        plain = drain()
    reqs = batch_requests(wrapper, adas, 256, 4)
    errs, plain_errs = [], []
    for i, r in enumerate(reqs):
        if r.ada_embs is not None:
            wrapper.update_text_encoder_subj_embeddings(r.ada_embs)
        one_shot = wrapper.pipeline(
            [r.prompt], negative_prompt=r.negative_prompt, num_inference_steps=3,
            guidance_scale=r.guidance_scale, guidance_scale_min=r.guidance_scale_min,
            height=256, width=256, latents=r.latents[None].to(wrapper.dtype))[0]
        errs.append((images[i] - one_shot).abs().max().item())
        plain_errs.append((images[i] - plain[i]).abs().max().item())
    check_images([images[i] for i in range(4)], 4, 256, "small drain")
    log(f"batcher against the pipeline: 4 requests through 2 slots, 256x256, 3 steps: image "
        f"max_abs_err against the one-shot image {', '.join(f'{e:.3e}' for e in errs)}; "
        f"kernels against plain {', '.join(f'{e:.3e}' for e in plain_errs)} "
        f"(bound {IMAGE_TOL:g})")
    if max(errs + plain_errs) > IMAGE_TOL:
        raise AssertionError("batcher against the pipeline or the plain versions: error above "
                             "bound")
    return dict(errs=errs, plain_errs=plain_errs)


def serve_img2img(wrapper, faces) -> dict:
    """One img2img request through `AdaFaceWrapper("img2img", ...)` on the
    same modules: encode, 20 of 25 steps, decode."""
    from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
    from adaface_tpu_torch.ops import _build

    m = wrapper.pipeline.m
    w2 = AdaFaceWrapper("img2img", m, wrapper.id2ada_prompt_encoder, guidance_scale=6.0,
                        num_inference_steps=25)
    init = np.random.RandomState(SEED + 1).randint(0, 256, (512, 512, 3), np.uint8)
    x = (torch.from_numpy(init).to("cuda").permute(2, 0, 1)[None].float() / 127.5 - 1.0).to(
        torch.bfloat16)
    with torch.inference_mode():
        moments = m.vae_encoder(x).float()
        with plain_versions():
            ref = m.vae_encoder(x).float()
    rel = ((moments - ref).norm() / ref.norm()).item()
    if tuple(moments.shape) != (1, 8, 64, 64) or not torch.isfinite(moments).all():
        raise AssertionError(f"img2img: moments {tuple(moments.shape)} not finite or misshaped")

    w2.prepare_adaface_embeddings(images=faces["a"])
    w2(REQUESTS[0][1], init_image=init, generator=torch.Generator("cuda").manual_seed(7))
    torch.cuda.synchronize()  # warmed up: the encoder's convolutions chose their algorithms
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    w2.prepare_adaface_embeddings(images=faces["a"])
    with gn_census(m.vae_encoder) as seen_enc, gn_census(m.vae) as seen_dec:
        img = w2(REQUESTS[0][1], init_image=init, strength=0.8,
                 generator=torch.Generator("cuda").manual_seed(7))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    expect_counts(counts, unet_calls=20, decodes=1, encodes=1)
    expect_census(seen_enc, encodes=1)
    expect_census(seen_dec, decodes=1)
    check_images(list(img), 1, 512, "img2img")
    log(f"img2img: 512x512 uint8 image, strength 0.8, 20 of 25 steps: {ms:.1f} ms; encoder "
        f"moments kernels against plain rel_err {rel:.3e} (bound {UNET_REL_TOL:g}); launches "
        f"{counts}")
    if rel > UNET_REL_TOL:
        raise AssertionError(f"VAE encoder kernels against plain: rel_err {rel} above bound")
    return dict(counts=counts, ms=ms, rel=rel)


def serve_samplers(wrapper, faces) -> dict:
    """The other schedulers through the wrapper: DPM-Solver++ at 512x512, 25
    steps; PNDM (8 steps) and LCM (4 steps) at 256x256; each against the DDIM
    image from the same generator seed, and so the same initial latents."""
    from adaface_tpu_torch.ops import _build

    wrapper.prepare_adaface_embeddings(images=faces["b"])
    out = {}
    for scheduler, hw, steps in (("dpm++", 512, 25), ("pndm", 256, 8), ("lcm", 256, 4)):
        kw = dict(num_inference_steps=steps, height=hw, width=hw)
        ddim = wrapper(REQUESTS[1][1], generator=torch.Generator("cuda").manual_seed(11), **kw)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        img = wrapper(REQUESTS[1][1], generator=torch.Generator("cuda").manual_seed(11),
                      scheduler=scheduler, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        if hw == 512:
            expect_counts(counts, unet_calls=steps, decodes=1)
        elif not counts:
            raise AssertionError(f"{scheduler}: no kernel launched")
        check_images(list(img), 1, hw, scheduler)
        diff = (img - ddim).abs().max().item()
        if diff <= 1e-3:
            raise AssertionError(f"{scheduler}: the image equals DDIM's")
        log(f"sampler {scheduler}: {hw}x{hw}, {steps} steps: {ms:.1f} ms; max |image - DDIM's| "
            f"{diff:.3f}; launches {counts}")
        out[scheduler] = dict(counts=counts, ms=ms)
    return out


JOINT_BATCH = 4  # 20-token requests (subjects a, b, c and none) through the 8-slot batcher
# the joint encoder's one-shot requests: 2 of REQUESTS (cut from all 3 to keep
# the whole run under 750 s)
JOINT_REQUESTS = REQUESTS[:2]
# the face path on the card against the CPU, fp32, each part on the card's
# input: ArcFace and the encoders read ~1e-6 in sound fp32 and the ada
# embeddings ~4e-4 under TF32 convolutions; the random detector (statistics
# fitted to the photos) reads up to 1.2e-5 in fp32 on its box offsets
CARD_CPU_REL_L2 = 1e-5
DETECTOR_REL_L2 = 1e-4


def rel_l2_of(out, ref) -> float:
    """‖out − ref‖ / ‖ref‖ of two tensors or arrays, on the CPU in fp32."""
    out, ref = (torch.as_tensor(v).detach().float().cpu() for v in (out, ref))
    return ((out - ref).norm() / ref.norm()).item()


def build_joint_encoder(gen):
    """The joint encoder at full width on the card, float32: Arc2Face's
    CLIP-L text tower and its generator's, ConsistentID's CLIP-H/14 vision
    tower, ProjPlus (depth 4 at 768, 12 heads) and its generator's CLIP-L,
    behind RetinaFace (mobilenet0.25) + ArcFace (resnet_face18)."""
    from adaface_tpu_torch.id2ada.face_backends import RetinaFaceArcFaceBackend
    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import JointFaceID2AdaPrompt
    from adaface_tpu_torch.text.tokenizer import default_tokenizer

    backend = RetinaFaceArcFaceBackend.random_init(gen, "cuda")
    return JointFaceID2AdaPrompt.random_init(gen, default_tokenizer(), "cuda",
                                             face_backend=backend)


def calibrate_batch_norms(model, x) -> None:
    """Set every inference BatchNorm's statistics to those of its input in
    one forward pass of `x`, layer by layer. The random detector's 0/1
    statistics leave raw-pixel activations unnormalised: its box offsets
    then overflow the decode's exp and every box is degenerate (no random
    512x512 photo gets a face), where trained statistics fit their data."""
    from adaface_tpu_torch.models.arcface import InferenceBatchNorm

    def fit(module, args):
        t = args[0]
        dims = [0] + list(range(2, t.dim()))
        module.running_mean.copy_(t.mean(dims))
        module.running_var.copy_(t.var(dims, unbiased=False))

    hooks = [m.register_forward_pre_hook(fit) for m in model.modules()
             if isinstance(m, InferenceBatchNorm)]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()


def on_cpu(module):
    """A CPU copy of `module`: the same weights."""
    return copy.deepcopy(module).to("cpu")


class HandedBackend:
    """A face backend that hands out given ID embeddings in turn."""

    def __init__(self, embeddings):
        self._embeddings = iter(embeddings)

    def detect_and_embed(self, image_np):
        return next(self._embeddings)


def joint_on_cpu(joint, backend):
    """The joint encoder's towers and generators copied to the CPU, behind
    `backend`."""
    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import (Arc2FaceID2AdaPrompt,
                                                                ConsistentIDID2AdaPrompt,
                                                                JointFaceID2AdaPrompt)
    from adaface_tpu_torch.text.tokenizer import default_tokenizer

    arc, cid = joint.encoders
    return JointFaceID2AdaPrompt([
        Arc2FaceID2AdaPrompt(on_cpu(arc.text_encoder), on_cpu(arc.subj_basis_generator),
                             default_tokenizer(), face_backend=backend,
                             out_id_embs_cfg_scale=arc.out_id_embs_cfg_scale),
        ConsistentIDID2AdaPrompt(on_cpu(cid.clip_vision), on_cpu(cid.image_proj),
                                 on_cpu(cid.subj_basis_generator), face_backend=backend,
                                 out_id_embs_cfg_scale=cid.out_id_embs_cfg_scale)])


@contextmanager
def timed_nms(record: list):
    """Record (candidate boxes, kept, host ms) of every NMS call in the block."""
    from adaface_tpu_torch.models import retinaface as R

    nms = R.nms

    def timed(boxes, scores, thres=0.4):
        t0 = time.perf_counter()
        keep = nms(boxes, scores, thres)
        record.append((len(boxes), len(keep), (time.perf_counter() - t0) * 1e3))
        return keep

    with mock.patch.object(R, "nms", timed):
        yield


def face_to_ada_ms(encoder, images) -> dict:
    """images → ada embeddings: host ms of one call ending in a
    synchronisation, and the device's busy ms in a second, profiled call
    (torch.profiler). The encoder is warm: the joint encoder has already
    run both halves on each subject's photos."""
    host = []

    def run():
        t0 = time.perf_counter()
        encoder.generate_adaface_embeddings(images=images)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)

    ops, busy = device_operations(run)  # host[0] is its unprofiled first call
    return dict(host_ms=host[0], device_ms=busy, device_operations=ops)


def serve_joint(wrapper, faces, gen) -> dict:
    """The joint encoder (Arc2Face + ConsistentID, 20 ada tokens) behind
    RetinaFace + ArcFace, over the same SD1.5 modules: every photo's
    detection and embedding, 3 requests at 512x512, 25 steps, a drain of
    20-token requests through the 8-slot batcher, face → ada on the card
    against the CPU, and face → ada times per subject."""
    from adaface_tpu_torch.id2ada.face_backends import ArcFaceBackend
    from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
    from adaface_tpu_torch.models.retinaface import prior_boxes
    from adaface_tpu_torch.ops import _build

    m = wrapper.pipeline.m
    t0 = time.perf_counter()
    joint = build_joint_encoder(gen)
    torch.cuda.synchronize()
    arc, cid = joint.encoders
    backend = arc.face_backend
    photos = [im for imgs in faces.values() for im in imgs]
    bgr = np.stack([im[..., ::-1].astype(np.float32) - backend.client.BGR_MEAN for im in photos])
    calibrate_batch_norms(backend.client.model, torch.from_numpy(
        np.ascontiguousarray(bgr.transpose(0, 3, 1, 2))).to("cuda"))
    n_params = {name: sum(p.numel() for p in mod.parameters()) for name, mod in (
        ("arc2face text", arc.text_encoder), ("arc2face generator", arc.subj_basis_generator),
        ("clip-h vision", cid.clip_vision), ("projplus", cid.image_proj),
        ("consistentid generator", cid.subj_basis_generator),
        ("retinaface", backend.client.model), ("arcface", backend.arc.arcface))}
    log(f"joint: random full-width fp32 encoder on the card in {time.perf_counter() - t0:.1f} s "
        f"(RetinaFace's BN statistics fitted to the {len(photos)} photos); parameters {n_params}")

    # every photo gives an embedding; detection, NMS and ArcFace apart
    nms_calls, embs = [], {}
    with timed_nms(nms_calls):
        for subject, imgs in faces.items():
            for i, im in enumerate(imgs):
                e = backend.detect_and_embed(im)
                if e is None or e.shape != (512,) or not np.isfinite(e).all():
                    raise AssertionError(f"joint: photo {i} of subject {subject}: no embedding")
                embs[subject, i] = e
    photo = faces["a"][0]
    bgr = photo[..., ::-1].astype(np.float32) - backend.client.BGR_MEAN
    x = torch.from_numpy(np.ascontiguousarray(bgr.transpose(2, 0, 1)[None])).to("cuda")
    gray = torch.zeros((1, 1, 128, 128), device="cuda")
    px = torch.zeros((4, 3, 224, 224), device="cuda")  # fg and bg of 2 photos
    mask = torch.ones((4, 1, 224, 224), device="cuda")
    with torch.inference_mode():
        det_ms = median_ms(lambda: backend.client.model(x))
        arc_ms = median_ms(lambda: backend.arc.arcface(gray))
        vit_ms = median_ms(lambda: cid.clip_vision(px, image_mask=mask))
    boxes = [c[0] for c in nms_calls]
    nms_ms = [c[2] for c in nms_calls]
    log(f"joint: {len(embs)} photos {photo.shape[1]}x{photo.shape[0]}, every one embedded; "
        f"RetinaFace forward {det_ms:.3f} ms (CUDA events), NMS over {min(boxes)}..{max(boxes)} "
        f"candidate boxes of {len(prior_boxes(photo.shape[:2]))} anchors: {min(nms_ms):.2f}.."
        f"{max(nms_ms):.2f} ms on the host, kept {[c[1] for c in nms_calls]}; ArcFace "
        f"{arc_ms:.3f} ms; CLIP-H/14 fg+bg pass of 2 photos (batch 4) {vit_ms:.3f} ms")

    jw = AdaFaceWrapper("text2img", m, joint, guidance_scale=6.0, num_inference_steps=25)
    jw.prepare_adaface_embeddings(images=faces["a"])
    jw(REQUESTS[0][1], num_inference_steps=3, height=256, width=256,
       generator=torch.Generator("cuda").manual_seed(1))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    latencies, images = [], []
    for i, (subject, prompt) in enumerate(JOINT_REQUESTS):
        t1 = time.perf_counter()
        ada = jw.prepare_adaface_embeddings(images=faces[subject])
        img = jw(prompt, generator=torch.Generator("cuda").manual_seed(100 + i))
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t1) * 1e3)
        if ada is None or tuple(ada.shape) != (20, 768) or not torch.isfinite(ada).all():
            raise AssertionError(f"joint request {i}: ada embeddings "
                                 f"{None if ada is None else tuple(ada.shape)}")
        images.append(img[0])
    counts = launch_counts()
    expect_counts(counts, unet_calls=25 * len(JOINT_REQUESTS), decodes=len(JOINT_REQUESTS))
    check_images(images, len(JOINT_REQUESTS), 512, "joint requests")
    log(f"joint: {len(JOINT_REQUESTS)} requests 512x512, 25 steps, 20 ada tokens: "
        f"{', '.join(f'{x:.1f}' for x in latencies)} ms (face -> ada included); launches {counts}")

    adas = {s: jw.prepare_adaface_embeddings(images=imgs, update_text_encoder=False)
            for s, imgs in faces.items()}
    batcher = jw.make_batcher(num_slots=BATCH_SLOTS)
    reqs = batch_requests(jw, adas, 512, JOINT_BATCH)
    _build.reset_launch_counts()
    t1 = time.perf_counter()
    drained = batcher.generate_all(reqs)
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t1
    batch_counts = launch_counts()
    expect_counts(batch_counts, unet16_calls=batcher.steps, decodes=JOINT_BATCH)
    check_images([drained[i] for i in range(JOINT_BATCH)], JOINT_BATCH, 512, "joint batcher")
    log(f"joint batcher: {JOINT_BATCH} requests (subjects a, b, c with 20 ada tokens, and none) "
        f"through {BATCH_SLOTS} slots, 512x512, {batcher.steps} steps: {drain_s:.2f} s; launches "
        f"{batch_counts}")

    # face -> ada on the card against the same weights on the CPU, as served
    # (fp32, the face models' convolutions without TF32), in three parts,
    # each given the card's input: RetinaFace's outputs on one photo, ArcFace
    # on the card's crops, and the encoders on the card's ID embeddings. A
    # box edge that a rounding moves across a pixel changes the crop, so the
    # whole chain compared at once would fail by chance and pass a TF32 fault.
    crops, card_ids = [], []
    card_embed = backend.arc.detect_and_embed

    def recording(crop):
        crops.append(crop)
        card_ids.append(card_embed(crop))
        return card_ids[-1]

    with mock.patch.object(backend.arc, "detect_and_embed", recording):
        ada_card, prompts_card, _ = joint.generate_adaface_embeddings(images=faces["b"])
    detector = backend.client.model
    with torch.inference_mode():
        det_card = detector(x)
        det_rel = [rel_l2_of(p, q) for p, q in zip(det_card, on_cpu(detector)(x.cpu()))]
        # what the bound is to catch: the forward with TF32 convolutions
        # (its fp32_convolutions undone), against the card's fp32
        saved, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, True
        try:
            det_tf32 = type(detector).forward.__wrapped__(detector, x)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        tf32_rel = [rel_l2_of(p, q) for p, q in zip(det_tf32, det_card)]
    cpu_arc = ArcFaceBackend(on_cpu(backend.arc.arcface))
    arc_rel = [rel_l2_of(cpu_arc.detect_and_embed(c), e) for c, e in zip(crops, card_ids)]
    cpu_joint = joint_on_cpu(joint, HandedBackend(card_ids))
    t1 = time.perf_counter()
    ada_cpu, prompts_cpu, _ = cpu_joint.generate_adaface_embeddings(images=faces["b"])
    cpu_s = time.perf_counter() - t1
    rel = rel_l2_of(ada_card, ada_cpu)
    rel_prompts = [rel_l2_of(p, q) for p, q in zip(prompts_card, prompts_cpu)]
    log(f"joint: card against the CPU, fp32, full depth, rel L2: RetinaFace loc, conf, landmarks "
        f"on photo a0 {', '.join(f'{r:.3e}' for r in det_rel)} (bound {DETECTOR_REL_L2:g}; "
        f"TF32 convolutions on the card against fp32 {', '.join(f'{r:.3e}' for r in tf32_rel)}); "
        f"bound {CARD_CPU_REL_L2:g}: ArcFace on the card's {len(crops)} crops of "
        f"subject b {', '.join(f'{r:.3e}' for r in arc_rel)}; face -> ada of subject b on the "
        f"card's ID embeddings {rel:.3e} (image prompts "
        f"{', '.join(f'{r:.3e}' for r in rel_prompts)}; the CPU encoders {cpu_s:.1f} s)")
    if not max(det_rel) <= DETECTOR_REL_L2 or not max(arc_rel + [rel]) <= CARD_CPU_REL_L2:
        raise AssertionError(f"joint, card against CPU: rel L2 {det_rel}, {arc_rel}, {rel} "
                             f"above its bound")
    del cpu_joint, cpu_arc

    times = {}
    for subject in ("a", "b"):
        for name, enc in (("arc2face", arc), ("consistentID", cid), ("joint", joint)):
            times[f"{name} {subject}"] = t = face_to_ada_ms(enc, faces[subject])
            log(f"face -> ada, {name}, subject {subject} ({len(faces[subject])} photos): host "
                f"{t['host_ms']:.1f} ms, device busy {t['device_ms']:.2f} ms in "
                f"{t['device_operations']} operations")
    return dict(counts=counts, batch_counts=batch_counts, latencies=latencies, rel=rel,
                det_rel=det_rel, tf32_rel=tf32_rel, arc_rel=arc_rel, times=times, nms=nms_calls, det_ms=det_ms,
                arc_ms=arc_ms, vit_ms=vit_ms)


# ---------------------------------------------------------------------------
# Serving what the trainers write: adapters, an ensemble, converted weights
# ---------------------------------------------------------------------------

TRAINED_RANK = 192  # the adapters' rank, as `configs/stage2-comp-distill.yaml` trains them
TRAINED_REQUESTS = 2  # 512x512, 25-step requests with the adapters
TRAINED_DRAIN = 4  # requests of the adapted drain through BATCH_SLOTS slots
# an adapted UNet call's distance from the plain one, and an adapted image's,
# at the least. Random weights keep conv_out at std 1e-4, so the prediction is
# small and an image moves little with any change of the UNet (the adapters:
# 4.6e-3 relative L2 on an H100);
# the same seed without adapters gives the same bits, so any distance shows them
ADAPTED_EPS_REL_L2 = 1e-2
ADAPTED_REL_L2 = 1e-3
FP16_MIN_NORMAL = 2.0 ** -14  # below it fp16 keeps fewer bits than bf16


def trained_adapters(cfg, gen) -> dict:
    """Attention and FFN adapters at rank 192 (fp32, on the card) with every
    part live: A at the initialisers' scale, B drawn at a third of it (it
    starts at 0 in training, and a zero B would hide a path that never
    applies it), magnitudes 1 + 0.2·N, scale factors 0.8 + 0.1·N."""
    from adaface_tpu_torch.core.params import build, normal_
    from adaface_tpu_torch.models.unet import (AttnLoRA, AttnLoRALayer, DoRAConv, DoRALinear,
                                               FFNLoRA, init_lora_weights_)

    cfg = dataclasses.replace(cfg, lora_rank=TRAINED_RANK)
    out = {"attn_lora": build(lambda: AttnLoRA(cfg), "cuda", torch.float32, init_lora_weights_,
                              gen),
           "ffn_lora": build(lambda: FFNLoRA(cfg), "cuda", torch.float32, init_lora_weights_,
                             gen)}
    with torch.no_grad():
        for module in out.values():
            for m in module.modules():
                if isinstance(m, (DoRALinear, DoRAConv)):
                    normal_(m.lora_b, 0.3 * m.lora_b[0].numel() ** -0.5, gen)
                    normal_(m.magnitude, 0.2, gen)
                    m.magnitude.add_(1.0)
                elif isinstance(m, AttnLoRALayer):
                    normal_(m.scale_factor, 0.1, gen)
                    m.scale_factor.add_(0.8)
    return out


@contextmanager
def swapped_modules(wrapper, **changes):
    """The wrapper's pipeline modules with `changes` for the block."""
    m = wrapper.pipeline.m
    wrapper.pipeline.m = dataclasses.replace(m, **changes)
    try:
        yield wrapper.pipeline.m
    finally:
        wrapper.pipeline.m = m


def profiled_ms(fn, host_runs: int = 3) -> tuple[float, float, int]:
    """(the median host ms of `host_runs` calls with the device synchronized,
    device ms and operations by torch.profiler of one more call) of `fn`."""
    from torch.profiler import ProfilerActivity, profile

    host = statistics.median(sync_ms(fn)[1] for _ in range(host_runs))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e.us for e in device_events(prof) if e.name != "Memset (Device)"]
    return host, sum(kernels) / 1e3, len(kernels)


def adapter_call_ms(m) -> dict:
    """The adapters' own device time in one UNet call at CFG batch 2 (512x512):
    the 7 adapted layers' DoRA forwards (the merge and the product) against
    the plain layers' products, on inputs of the path's shapes, each as the
    sum of its kernels' device times by torch.profiler."""
    unet, scale = m.unets[0], m.unets[0].cfg.lora_scale
    up = unet.up_blocks[-1]
    c = unet.cfg.block_channels[0]
    x_attn = torch.randn(2, 64 * 64, c, device="cuda", dtype=torch.bfloat16)
    x_conv = {name: torch.randn(2, cin, 64, 64, device="cuda", dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last) for name, cin in (("conv1", 2 * c), ("conv2", c))}
    cases = [(m.attn_lora[str(22 + i)].out, up.attentions[i].block.attn2.o, x_attn)
             for i in range(3)]
    ffn = m.ffn_lora[m.ffn_adapter]
    for ri in ("1", "2"):
        for conv in ("conv1", "conv2"):
            cases.append((ffn[ri][conv], getattr(up.resnets[int(ri)], conv), x_conv[conv]))
    with torch.inference_mode():
        _, adapted, n_adapted = profiled_ms(lambda: [a(b, x, scale) for a, b, x in cases])
        _, plain, n_plain = profiled_ms(lambda: [b(x) for _, b, x in cases])
    return dict(adapted_ms=adapted, plain_ms=plain, adapted_ops=n_adapted, plain_ops=n_plain,
                layers=len(cases))


def serve_trained(wrapper, faces, card: str) -> dict:
    """Serving what the port's trainers write, at full SD1.5 width on the
    card: the UNet's adapters from a checkpoint through
    `load_unet_lora_weights` (requests, a drain, launch counts, times), a
    UNet ensemble with a UNet from a trainer's `unet_fp16.safetensors`, and
    weights converted without JAX (the diffusers round trip, and an SD1.5
    single file in the LDM layout served)."""
    import tempfile

    from adaface_tpu_torch.core import bridge
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
    from adaface_tpu_torch.models.clip import CLIP_L_TEXT
    from adaface_tpu_torch.models.unet import UNet2DConditionModel, init_unet_weights_
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.tools import convert_sd
    from adaface_tpu_torch.tools.ckpt_lib import (cast_fp16, load_state_dict, save_state_dict,
                                                  unflatten_tree)
    from adaface_tpu_torch.train.checkpoint import save_adaface_ckpt
    from adaface_tpu_torch.train.train_step import lora_state_dicts
    from tests import torch_sd_layout as layout

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(SEED + 11)  # the later phases' draws unchanged
    m = wrapper.pipeline.m
    base_unet = m.unet
    out: dict = {"card": card}
    tmp = tempfile.TemporaryDirectory()

    # 1. adapters written as the trainer writes them, loaded as a user loads them
    lora = trained_adapters(base_unet.cfg, gen)
    ckpt = save_adaface_ckpt(os.path.join(tmp.name, "embeddings_gs-1"), 1, {"joint": {}},
                             unet_lora_params=lora_state_dicts(lora))
    wrapper.load_unet_lora_weights(ckpt)
    if m.attn_lora is None or m.ffn_lora is None or m.ffn_adapter != "comp_distill":
        raise AssertionError("serve_trained: the adapters did not load")
    for name, module in (("attn_lora", m.attn_lora), ("ffn_lora", m.ffn_lora)):
        sd, ref = module.state_dict(), lora[name].state_dict()
        if any(not torch.equal(sd[k], ref[k]) or sd[k].dtype != torch.float32 for k in ref):
            raise AssertionError(f"serve_trained: {name} loaded other values or dtype")
    wrapper.prepare_adaface_embeddings(images=faces["a"])
    small = dict(num_inference_steps=3, height=256, width=256)
    img_k = wrapper(REQUESTS[0][1], generator=torch.Generator("cuda").manual_seed(1), **small)
    with plain_versions():
        img_p = wrapper(REQUESTS[0][1], generator=torch.Generator("cuda").manual_seed(1), **small)
    out["small_err"] = err = (img_k - img_p).abs().max().item()
    log(f"serve_trained: 256x256 3-step request with the adapters, kernels against plain: image "
        f"max_abs_err {err:.3e} (bound {IMAGE_TOL:g})")
    if err > IMAGE_TOL:
        raise AssertionError("serve_trained: adapted request kernels against plain above bound")

    def request(i, subject="a"):
        wrapper.prepare_adaface_embeddings(images=faces[subject])
        return wrapper(REQUESTS[i][1], generator=torch.Generator("cuda").manual_seed(300 + i))

    request(0)  # warm-up of the adapted shapes
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    adapted = [request(i) for i in range(TRAINED_REQUESTS)]
    torch.cuda.synchronize()
    out["counts"] = counts = launch_counts()
    expect_counts(counts, unet_calls=25 * TRAINED_REQUESTS, decodes=TRAINED_REQUESTS)
    check_images([a[0] for a in adapted], TRAINED_REQUESTS, 512, "adapted requests")
    with swapped_modules(wrapper, attn_lora=None, ffn_lora=None):
        plain = [request(i) for i in range(TRAINED_REQUESTS)]
    rels = [rel_l2_of(a, p) for a, p in zip(adapted, plain)]
    x = torch.randn(2, 4, 64, 64, device="cuda", generator=gen).to(torch.bfloat16)
    tt = torch.tensor([500, 500], device="cuda")
    ctx = torch.randn(2, 77, 768, device="cuda", generator=gen).to(torch.bfloat16)
    with torch.inference_mode():
        eps_a = m.unet_eps(x, tt, ctx)
        with swapped_modules(wrapper, attn_lora=None, ffn_lora=None) as plain_m:
            eps_rel = rel_l2_of(eps_a, plain_m.unet_eps(x, tt, ctx))
    log(f"serve_trained: {TRAINED_REQUESTS} requests with the rank-{TRAINED_RANK} adapters, "
        f"512x512, 25 steps: launches as an unadapted request's ({counts}); relative L2 from "
        f"the same seeds without adapters {', '.join(f'{r:.3e}' for r in rels)} (at least "
        f"{ADAPTED_REL_L2:g}); of one UNet call's prediction {eps_rel:.3e} (at least "
        f"{ADAPTED_EPS_REL_L2:g})")
    if min(rels) < ADAPTED_REL_L2 or eps_rel < ADAPTED_EPS_REL_L2:
        raise AssertionError("serve_trained: the adapters left an image or a prediction as it "
                             "was")
    out.update(adapted_rel_l2=rels, adapted_eps_rel_l2=eps_rel)

    times = {}
    times["adapted"] = profiled_ms(lambda: request(0))
    with swapped_modules(wrapper, attn_lora=None, ffn_lora=None):
        times["plain"] = profiled_ms(lambda: request(0))
    out["adapter_call"] = ac = adapter_call_ms(m)
    # 2. the batcher with the adapters: a drain through 8 slots, then the small
    # drain held to the one-shot pipeline and to the plain versions
    adas = subject_embeddings(wrapper, faces)
    batcher = wrapper.make_batcher(num_slots=BATCH_SLOTS)
    if batcher.m.attn_lora is not m.attn_lora or batcher.m.ffn_lora is not m.ffn_lora:
        raise AssertionError("serve_trained: make_batcher dropped the adapters")
    reqs = batch_requests(wrapper, adas, 512, TRAINED_DRAIN)
    batcher.generate_all(batch_requests(wrapper, adas, 512, TRAINED_DRAIN))  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    drained = batcher.generate_all(reqs)
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    out["batch_counts"] = batch_counts = launch_counts()
    expect_counts(batch_counts, unet16_calls=batcher.steps, decodes=TRAINED_DRAIN)
    check_images([drained[r.request_id] for r in reqs], TRAINED_DRAIN, 512, "adapted drain")
    out["drain_imgs_per_sec"] = TRAINED_DRAIN / drain_s
    log(f"serve_trained: adapted drain of {TRAINED_DRAIN} requests through {BATCH_SLOTS} slots, "
        f"512x512, 25 steps: {drain_s:.2f} s, {TRAINED_DRAIN / drain_s:.3f} imgs/sec; launches "
        f"{batch_counts}")
    out["small_drain"] = batcher_against_pipeline(wrapper, faces)
    del batcher

    # 3. the ensemble: the base UNet and one from a trainer's unet_fp16.safetensors
    unet2_src = build(lambda: UNet2DConditionModel(base_unet.cfg), "cuda", torch.bfloat16,
                      init_unet_weights_, gen)
    path16 = os.path.join(tmp.name, "unet_fp16.safetensors")
    save_state_dict(cast_fp16(bridge.tree_state_dict(unet2_src)), path16)  # `Trainer.save`
    del unet2_src
    unet2 = convert_sd.load_module(lambda: UNet2DConditionModel(base_unet.cfg),
                                   unflatten_tree(load_state_dict(path16)), "cuda", torch.bfloat16)
    single = request(0)
    with swapped_modules(wrapper, unet=[base_unet, unet2], unet_weights=(1.0, 0.0)):
        one_zero = request(0)
    if not torch.equal(one_zero, single):
        raise AssertionError("serve_trained: the (1, 0) ensemble differs from its first UNet "
                             f"by {(one_zero - single).abs().max().item():.3e}")
    with swapped_modules(wrapper, unet=[base_unet, unet2], unet_weights=(0.5, 0.5)):
        _build.reset_launch_counts()
        half = request(1)
        torch.cuda.synchronize()
        out["ensemble_counts"] = ens_counts = launch_counts()
        expect_counts(ens_counts, unet_calls=2 * 25, decodes=1)
        check_images([half[0]], 1, 512, "ensemble")
        times["ensemble"] = profiled_ms(lambda: request(0))
    log(f"serve_trained: ensemble of the base UNet and one loaded from unet_fp16.safetensors: at "
        f"(1, 0) the image equals the single UNet's bit for bit; at (0.5, 0.5) launches "
        f"{ens_counts} (the UNet's twice a request's, the VAE's once)")
    del unet2

    # 4a. export_unet_to_diffusers -> convert_unet -> a fresh UNet, one call bit for bit
    with swapped_modules(wrapper, attn_lora=None, ffn_lora=None):
        src = wrapper.pipeline.m
    unet_tree = layout.as_lists(unflatten_tree(bridge.tree_state_dict(base_unet)))
    for blk in unet_tree["down_blocks"] + unet_tree["up_blocks"]:
        blk.setdefault("attentions", [])
    round_trip = convert_sd.convert_unet(convert_sd.export_unet_to_diffusers(unet_tree))
    fresh = convert_sd.load_module(lambda: UNet2DConditionModel(base_unet.cfg), round_trip,
                                   "cuda", torch.bfloat16)
    with torch.inference_mode():
        same_call = torch.equal(fresh(x, tt, ctx), base_unet(x, tt, ctx))
    log(f"serve_trained: export_unet_to_diffusers -> convert_unet -> a fresh UNet: one call "
        f"equal bit for bit: {same_call}")
    if not same_call:
        raise AssertionError("serve_trained: the diffusers round trip changed a UNet call")
    del fresh, round_trip

    # 4b. an SD1.5 single file (LDM layout, fp16, EMA shadows, schedule buffers)
    text_tree = unflatten_tree(bridge.tree_state_dict(src.text_encoder))
    # CLIP-L's table, without the placeholder rows the wrappers grew
    text_tree["token_embedding"] = text_tree["token_embedding"][:CLIP_L_TEXT.vocab_size]
    vae_tree = unflatten_tree({**bridge.tree_state_dict(src.vae),
                               **bridge.tree_state_dict(src.vae_encoder)})
    t0 = time.perf_counter()
    sd = layout.sd_single_file(unet_tree, vae_tree, text_tree, base_unet.cfg)
    single_path = os.path.join(tmp.name, "v1-5-synthetic.safetensors")
    save_state_dict(sd, single_path)
    write_s = time.perf_counter() - t0
    size_gb = os.path.getsize(single_path) / 1e9
    n_keys = len(sd)
    del sd, unet_tree, text_tree, vae_tree
    gc.collect()
    t0 = time.perf_counter()
    towers = convert_sd.load_sd_towers(single_path)
    load_s = time.perf_counter() - t0
    loaded = convert_sd.load_pipeline_modules(towers, "cuda", torch.bfloat16,
                                              tokenizer=m.tokenizer)
    torch.cuda.synchronize()
    land_s = time.perf_counter() - t0 - load_s
    del towers
    diff_leaves, diff_elems, normal_diffs, n_leaves = 0, 0, 0, 0
    for name in ("unet", "vae", "vae_encoder", "text_encoder"):
        got, ref = getattr(loaded, name).state_dict(), getattr(src, name).state_dict()
        for k, v in got.items():
            r = ref[k][:v.shape[0]] if k == "token_embedding" else ref[k]
            n_leaves += 1
            bad = v != r
            if bad.any():
                diff_leaves += 1
                diff_elems += int(bad.sum())
                normal_diffs += int((bad & (r.float().abs() >= FP16_MIN_NORMAL)).sum())
    log(f"serve_trained: SD1.5 single file (LDM layout, fp16, {n_keys} tensors with the "
        f"model_ema shadows and the schedule buffers): {size_gb:.2f} GB written in {write_s:.1f} "
        f"s; load_sd_towers {load_s:.1f} s, landed on the card in {land_s:.1f} s; {diff_leaves} "
        f"of {n_leaves} leaves differ from the source, in {diff_elems} elements, "
        f"{normal_diffs} of them at a magnitude fp16 keeps in full (expected 0)")
    if normal_diffs:
        raise AssertionError("serve_trained: the single file changed values fp16 holds exactly")
    w2 = AdaFaceWrapper("text2img", loaded, wrapper.id2ada_prompt_encoder, guidance_scale=6.0,
                        num_inference_steps=25)
    ada = w2.prepare_adaface_embeddings(images=faces["b"])
    gen_req = lambda: torch.Generator("cuda").manual_seed(400)  # noqa: E731
    img_file = w2(REQUESTS[1][1], generator=gen_req())
    with swapped_modules(wrapper, attn_lora=None, ffn_lora=None):
        wrapper.update_text_encoder_subj_embeddings(ada)
        img_src = wrapper(REQUESTS[1][1], generator=gen_req())
    file_err = (img_file - img_src).abs().max().item()
    check_images([img_file[0]], 1, 512, "single-file request")
    log(f"serve_trained: a request on the single file's towers against the source's: image "
        f"max_abs_err {file_err:.3e} (bound {IMAGE_TOL:g})")
    if file_err > IMAGE_TOL:
        raise AssertionError("serve_trained: the single file's request moved off the source's")
    del loaded, w2
    tmp.cleanup()
    m.attn_lora = m.ffn_lora = None

    out.update(times=times, file=dict(gb=size_gb, write_s=write_s, load_s=load_s, land_s=land_s,
                                      diff_leaves=diff_leaves, diff_elems=diff_elems,
                                      err=file_err),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               seconds=time.perf_counter() - t_phase)
    for label, (host, dev, ops) in times.items():
        log(f"serve_trained [{card}]: one 512x512 25-step request, {label}: {host:.1f} ms on the "
            f"host clock (median of 3), device busy {dev:.2f} ms in {ops} operations "
            f"(torch.profiler)")
    log(f"serve_trained [{card}]: the adapters' own device time in one UNet call at CFG batch 2: "
        f"{ac['adapted_ms']:.3f} ms in {ac['adapted_ops']} operations for the {ac['layers']} "
        f"adapted layers against {ac['plain_ms']:.3f} ms in {ac['plain_ops']} plain "
        f"(torch.profiler), so {25 * (ac['adapted_ms'] - ac['plain_ms']):.2f} ms a request; "
        f"an adapted request's device time minus a plain one's "
        f"{times['adapted'][1] - times['plain'][1]:.2f} ms")
    log(f"serve_trained [{card}]: adapted drain {out['drain_imgs_per_sec']:.3f} imgs/sec; peak "
        f"memory {out['peak_gib']:.2f} GiB; phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The Stage-1 training slice: the backward kernels, then the trainer
# ---------------------------------------------------------------------------

# (label, B, H, Sq, Sk, D): every attention of the student UNet whose
# backward the training path runs, at the largest teacher bucket (batch 4 x
# 4 steps = UNet batch 16)
FLASH_BWD_CASES = [(f"{label} batch 16", 16, *dims) for label, _, *dims in FLASH_CASES[:-1]]
# the VAE decoder's mid-block attention with gradient, at the finetuning
# configuration's batch 2 (recon decodes): the D 512 cluster kernels
FLASH_BWD_VAE = [("vae mid self batch 2", 2, 1, 4096, 4096, 512)]
# the recon path's masked self-attention at 64x64 (every self-attention of
# the trained UNet carries the image's face mask) at batch 4
FLASH_BWD_RECON = [("recon masked 64x64 self batch 4", 4, 8, 4096, 4096, 40)]
# off the path: a key mask (batch 1 all masked) and the causal rule at
# ragged lengths (Sq 200, Sk 177: rows 0..22 see only masked keys); D 36,
# whose rows are off 16 bytes, takes the wide forward (its keys split, the
# statistics from `flash_combine`) and padded copies in the backward
FLASH_BWD_MASKED = [("masked Sq200 Sk177 D40", 40, False),
                    ("masked Sq200 Sk177 D36", 36, False),
                    ("masked causal Sq200 Sk177 D80", 80, True),
                    ("causal Sq200 Sk177 D160", 160, True),
                    ("masked Sq200 Sk177 D512", 512, False),
                    ("masked causal Sq200 Sk177 D512", 512, True)]
STATS_TOL = 1e-4  # the rows' m and 1/l, kernel against plain, of max(1, |plain|)


def face_mask(b: int, hw: int) -> torch.Tensor:
    """[B, hw·hw] key mask of a face on a latent map: 1 inside an ellipse of
    about a third of the map (shifted by a few cells from sample to
    sample), 0 outside, as the recon's `img_mask` keeps the face's keys."""
    yy, xx = torch.meshgrid(torch.arange(hw, device="cuda"), torch.arange(hw, device="cuda"),
                            indexing="ij")
    masks = []
    for i in range(b):
        cy, cx = hw * (0.45 + 0.02 * i), hw * (0.5 - 0.03 * i)
        inside = ((yy - cy) / (0.38 * hw)) ** 2 + ((xx - cx) / (0.3 * hw)) ** 2 <= 1.0
        masks.append(inside.float().flatten())
    return torch.stack(masks)


def timed(kernel, plain, library) -> dict:
    """Single-launch medians in turns (kernel, plain, library, library,
    plain, kernel; the plain version, a yardstick tens of times slower, one
    run a turn), and the kernel's 20 calls as a CUDA graph."""
    fns = [kernel, plain, library, library, plain, kernel]
    turns = [None if f is None else median_ms(f, reps=1, warmup=0) if f is plain
             else median_ms(f, reps=5) for f in fns]
    pick = lambda i: None if turns[i] is None else min(turns[i], turns[5 - i])  # noqa: E731
    return dict(ms=pick(0), plain_ms=pick(1), library_ms=pick(2), graph_ms=graph_ms(kernel))


def flash_library_backward(q, k, v, g, backends=("FLASH_ATTENTION",), kv_mask=None):
    """The autograd backward of `F.scaled_dot_product_attention` on the first
    of `backends` that takes the shape, for the same q, k, v, key mask and
    g: a yardstick, never called by the port. → (the call, the backend's
    name), (None, None) where all refuse it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    attn_mask = None if kv_mask is None else (kv_mask > 0)[:, None, None, :]
    for name in backends:
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                o = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=attn_mask)
            torch.autograd.grad(o, (qq, kk, vv), g, retain_graph=True)
        except RuntimeError as e:
            log(f"library {name} backward refused: {str(e).splitlines()[0][:160]}")
            continue
        return lambda: torch.autograd.grad(o, (qq, kk, vv), g, retain_graph=True), name
    return None, None


def bwd_kernel_bounds(b, h, sq, sk, d) -> dict:
    """(least ms, what bounds it) of each backward launch's own work, at
    every head dim: delta reads out and g and writes delta; dkdv does four
    products (S^T, dP^T, dV, dK), reads q, k, v, g and the rows' m, 1/l,
    delta, writes dk, dv; dq three (S, dP, dQ), reads the same, writes dq."""
    prod, nq, nk, rows = 2.0 * b * h * sq * sk * d, b * h * sq * d, b * h * sk * d, b * h * sq
    return {"delta": bound(2 * 2 * nq + 4 * rows),
            "dkdv": bound(2 * (2 * nq + 4 * nk) + 12 * rows, 4 * prod),
            "dq": bound(2 * (3 * nq + 2 * nk) + 12 * rows, 3 * prod)}


def check_flash_bwd(gen, cases=None, masked: bool = True) -> dict:
    """The backward kernels against `flash_bwd_chunked` (dq, dk, dv) and
    against `flash_bwd_tiled` (their arithmetic in plain PyTorch; at D 512 in
    the plan's head-dim slices) at every path shape (`cases`: the student UNet's at batch
    16, the recon's face-masked self-attention at batch 4 and the VAE
    decoder's at batch 2 unless given), with the statistics the forward
    kept; two runs to the same bits, and a run without the statistics (a
    forward launch writes them) to the same bits too; plus masked and causal
    cases at ragged lengths; times of the whole backward and of each kernel
    beside its own bound and the library's backward."""
    from adaface_tpu_torch.ops import attention as A

    results = {}
    for label, b, h, sq, sk, d in (cases or FLASH_BWD_CASES + FLASH_BWD_RECON + FLASH_BWD_VAE):
        q, k, v = flash_inputs(gen, label, b, h, sq, sk, d)
        mask = face_mask(b, 64) if label.startswith("recon masked") else None
        scale = 1.0 / math.sqrt(d)
        plan = A.flash_bwd_plan(q.dtype, b, h, sq, sk, d,
                                torch.cuda.get_device_properties(0).multi_processor_count)
        out, stats = A._flash_cuda(q, k, v, mask, False, scale, with_stats=True)
        # the gradient of out as the path gives it: [B, S, H·D] memory
        g = torch.randn((b, sq, h * d), generator=gen, device="cuda").to(q.dtype)
        g = g.reshape(b, sq, h, d).transpose(1, 2)
        kernel = lambda: A.flash_bwd(q, k, v, mask, out, g, False, scale, stats=stats)  # noqa
        got, again = kernel(), kernel()
        ref = A.flash_bwd_chunked(q, k, v, mask, out, g, False, scale)
        torch.cuda.synchronize()
        errs = {n: max_err(x, r) for n, x, r in zip(("dq", "dk", "dv"), got, ref)}
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del ref, again
        tiled = A.flash_bwd_tiled(q, k, v, mask, out, g, False, scale, stats,
                                  d_slices=plan.d_slices)
        tiled_errs = {n: max_err(x, r) for n, x, r in zip(("dq", "dk", "dv"), got, tiled)}
        del tiled
        without = A.flash_bwd(q, k, v, mask, out, g, False, scale)
        same_without = all(torch.equal(x, y) for x, y in zip(got, without))
        del without
        torch.cuda.empty_cache()
        # the flash backend takes no mask and stops at head dim 256: there the
        # first backend that takes the call
        library, backend = flash_library_backward(
            q, k, v, g, ("FLASH_ATTENTION",) if d <= 256 and mask is None else
            ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"), mask)
        t = timed(kernel, lambda: A.flash_bwd_chunked(q, k, v, mask, out, g, False, scale),
                  library)
        first_ms = graph_ms(lambda: A.flash_bwd(q, k, v, mask, out, g, False, scale, False,
                                                False, stats=stats))
        no_dq = graph_ms(lambda: A.flash_bwd(q, k, v, mask, out, g, False, scale, False, True,
                                             stats=stats))
        # q, out, g read and dq written; k, v read and dk, dv written; five
        # products of [Sq, Sk] by D: S = QKᵀ, dP = G Vᵀ, dV = Pᵀ G, dK = dSᵀ Q, dQ = dS K
        bound_ms, bound_by = bound(2 * (4 * q.numel() + 4 * k.numel()),
                                   5 * 2.0 * b * h * sq * sk * d)
        res = dict(err=max(e for e, _ in errs.values()), mag=max(m for _, m in errs.values()),
                   tiled_err=max((e for e, _ in tiled_errs.values()), default=None),
                   same_bits=same, same_bits_without_stats=same_without, bound_ms=bound_ms,
                   bound_by=bound_by, library=backend,
                   bound_bytes=2 * (4 * q.numel() + 4 * k.numel()),
                   bound_flops=5 * 2.0 * b * h * sq * sk * d, plan=dataclasses.asdict(plan),
                   delta_graph_ms=first_ms, dkdv_graph_ms=no_dq - first_ms,
                   dq_graph_ms=t["graph_ms"] - no_dq,
                   kernel_bounds=bwd_kernel_bounds(b, h, sq, sk, d), **t)
        lib = "refused" if t["library_ms"] is None else f"{backend} {t['library_ms']:.4f} ms"
        log(f"flash bwd {label:32s} B{b} H{h} Sq{sq} Sk{sk} D{d}: max_abs_err "
            + " ".join(f"{n} {e:.3e}" for n, (e, _) in errs.items())
            + f" (bound {BF16_TOL * res['mag']:.3e}) against tiled "
            + " ".join(f"{n} {e:.3e}" for n, (e, _) in tiled_errs.items())
            + f" same bits {same}, without stats {same_without} | plan {res['plan']} | single: "
            f"kernels {t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms library {lib} | 20 as a "
            f"CUDA graph (device alone): {t['graph_ms']:.4f} ms (delta {first_ms:.4f}, dkdv "
            f"{res['dkdv_graph_ms']:.4f}, dq {res['dq_graph_ms']:.4f}) | least {bound_ms:.4f} "
            f"ms by {bound_by}, reached {bound_ms / t['graph_ms']:.1%}")
        bad = [n for n, (e, m) in {**errs, **{f"tiled {n}": x for n, x in tiled_errs.items()}
                                   }.items() if e > BF16_TOL * m]
        if bad or not same or not same_without:
            raise AssertionError(f"flash bwd {label}: {bad} {errs} {tiled_errs}, same bits "
                                 f"{same}, without stats {same_without}")
        results[label] = res
        del q, k, v, out, g, got, kernel, stats
        torch.cuda.empty_cache()
    for label, d, causal in FLASH_BWD_MASKED if masked else ():
        q, k, v = flash_inputs(gen, "self", 2, 2, 200, 177, d)
        mask = torch.ones((2, 177), device="cuda")
        mask[1] = 0.0
        mask[0, 150:] = 0.0
        if causal:
            mask[1, :16] = 1.0
        scale = 1.0 / math.sqrt(d)
        out, stats = A._flash_cuda(q, k, v, mask, causal, scale, with_stats=True)
        g = torch.randn(out.shape, generator=gen, device="cuda").to(q.dtype)
        got = A.flash_bwd(q, k, v, mask, out, g, causal, scale, stats=stats)
        again = A.flash_bwd(q, k, v, mask, out, g, causal, scale, stats=stats)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        ref = A.flash_bwd_chunked(q, k, v, mask, out, g, causal, scale)
        errs = {n: max_err(x, r) for n, x, r in zip(("dq", "dk", "dv"), got, ref)}
        plan = A.flash_bwd_plan(q.dtype, 2, 2, 200, 177, d,
                                torch.cuda.get_device_properties(0).multi_processor_count)
        tiled = A.flash_bwd_tiled(q, k, v, mask, out, g, causal, scale, stats,
                                  d_slices=plan.d_slices)
        errs.update({f"tiled {n}": max_err(x, r)
                     for n, x, r in zip(("dq", "dk", "dv"), got, tiled)})
        log(f"flash bwd {label}: max_abs_err "
            + " ".join(f"{n} {e:.3e} (bound {BF16_TOL * m:.3e})" for n, (e, m) in errs.items())
            + f" same bits {same}")
        if any(e > BF16_TOL * m for e, m in errs.values()) or not same:
            raise AssertionError(f"flash bwd {label}: {errs}, same bits {same}")
        results[label] = dict(err=max(e for e, _ in errs.values()))
    return results


def check_flash_stats(gen) -> dict:
    """The forward kernels with the rows' statistics (the wgmma kernel's; the
    wide kernel's at the VAE's D 512, where serving passes none; and
    `flash_combine`'s where the wide kernel splits the keys: the ragged D 512
    and D 36 cases): O bit for bit what it is without them, the same
    launches, and m and 1/l against `flash_stats_tiled` (STATS_TOL of
    max(1, |plain|) elementwise; zeros past Sq), at every attention shape of
    the training path at batch 16, the recon's face mask, the VAE decoder's
    mid block at batch 2, and masked, causal and ragged cases (batch 1 all
    masked: m = -1e30, 1/l = 1/Sk)."""
    from adaface_tpu_torch.ops import attention as A

    cases = [(label, b, h, sq, sk, d, None, False)
             for label, b, h, sq, sk, d in FLASH_BWD_CASES + FLASH_BWD_RECON + FLASH_BWD_VAE]
    cases += [(label, 2, 2, 200, 177, d, "ragged", causal)
              for label, d, causal in FLASH_BWD_MASKED]
    out = {}
    for label, b, h, sq, sk, d, kind, causal in cases:
        q, k, v = flash_inputs(gen, label if kind is None else "self", b, h, sq, sk, d)
        mask = None
        if label.startswith("recon masked"):
            mask = face_mask(b, 64)
        elif kind == "ragged":
            mask = torch.ones((b, sk), device="cuda")
            mask[1] = 0.0
            mask[0, 150:] = 0.0
        scale = 1.0 / math.sqrt(d)
        A._build.reset_launch_counts()
        plain_o = A._flash_cuda(q, k, v, mask, causal, scale)
        launches = launch_counts()
        A._build.reset_launch_counts()
        o, stats = A._flash_cuda(q, k, v, mask, causal, scale, with_stats=True)
        ref = A.flash_stats_tiled(q, k, v, mask, causal, scale)
        torch.cuda.synchronize()
        equal = torch.equal(plain_o, o) and launches == launch_counts()
        err = ((stats[..., :sq] - ref).abs() / ref.abs().clamp(min=1.0)).amax(dim=(1, 2, 3))
        tail = stats[..., sq:].abs().max().item() if stats.shape[-1] > sq else 0.0
        row = dict(o_equal=equal, m_err=err[0].item(), inv_l_err=err[1].item(), tail=tail)
        log(f"flash stats {label:32s} B{b} H{h} Sq{sq} Sk{sk} D{d}: O with stats equal to O "
            f"without, in the same launches {launches}: {equal}; m {row['m_err']:.3e}, 1/l "
            f"{row['inv_l_err']:.3e} of max(1, |plain|) (bound {STATS_TOL:.0e}); past Sq {tail}")
        if not equal or max(row["m_err"], row["inv_l_err"]) > STATS_TOL or tail != 0.0:
            raise AssertionError(f"flash stats {label}: {row}")
        out[label] = row
        del q, k, v, plain_o, o, stats, ref
        torch.cuda.empty_cache()
    return out


def gn_bwd_case(G, label, shape, eps, silu, dtype, gen, kernel=None, timed_case=True) -> dict:
    """One GroupNorm backward on the kernel(s) `gn_bwd_plan` names (or
    `kernel`, forced): the forward's statistics against `gn_stats_plain`;
    (dx, dγ, dβ) against the closed form on the same statistics; two runs to
    the same bits; where `timed_case`, the times (module docstring of
    `check_gn_bwd`)."""
    x, scale, bias = gn_inputs(gen, shape, dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = g.contiguous(memory_format=torch.channels_last)
    _, stats = G._gn_forward(x, scale, bias, 32, eps, silu, with_stats=True)
    plain_stats = G.gn_stats_plain(x, 32, eps).reshape(stats.shape)
    stats_err = ((stats - plain_stats).abs() / plain_stats.abs().clamp_min(1.0)).max().item()
    plan = G.bwd_plan_for(x, 32, kernel)
    run = lambda: G.gn_silu_bwd(x, scale, bias, g, 32, stats, silu, plan=plan)  # noqa: E731
    got, again = run(), run()
    plain = lambda: G.gn_silu_bwd_plain(x, scale, bias, g, 32, eps, silu, stats)  # noqa: E731
    ref = plain()
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    errs = {n: max_err(a, r) for n, a, r in zip(("dx", "dgamma", "dbeta"), got, ref)}
    same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    where = (f"gn bwd {label:34s} {shape} {str(dtype)[6:]} silu {silu:d} {plan.kernel} slab "
             f"{plan.slab} chunks {plan.chunks} threads {plan.threads}"
             + (f" stage rows {plan.stage_rows} smem {plan.smem}" if plan.kernel == "fused" else ""))
    errs_text = (" ".join(f"{n} {e:.3e}" for n, (e, _) in errs.items())
                 + f" (bound {tol * max(m for _, m in errs.values()):.3e}); statistics "
                 f"{stats_err:.2e} (bound {STATS_TOL:.0e}); same bits {same}")
    if any(e > tol * m for e, m in errs.values()) or not same or stats_err > STATS_TOL:
        log(f"{where}: {errs_text}")
        raise AssertionError(f"gn bwd {label}: {errs}, statistics {stats_err}, same bits {same}")
    res = dict(kernel=plan.kernel, err=max(e for e, _ in errs.values()), same_bits=same,
               stats_err=stats_err)
    if not timed_case:
        log(f"{where}: {errs_text}")
        return res
    xx, ss, bb = (t.detach().requires_grad_() for t in (x, scale, bias))
    act = F.silu if silu else (lambda t: t)
    y = act(F.group_norm(xx, 32, ss, bb, eps))
    res.update(timed(run, plain, lambda: torch.autograd.grad(y, (xx, ss, bb), g,
                                                            retain_graph=True)))
    res["host_us"] = host_us(run)
    x_bytes = x.numel() * x.element_size()
    affine = 4 * shape[1] * x.element_size()  # γ, β read, dγ, dβ written
    # the function reads x and g and writes dx: 3 passes; the split pair
    # cannot do with fewer than 5 (x and g twice, dx once)
    res["bound_ms"], res["bound_by"] = bound(3 * x_bytes + affine)
    if plan.kernel == "fused":
        res["fused_graph_ms"] = graph_ms(lambda: G.gn_bwd_fused(x, g, stats, scale, bias, 32, silu,
                                                                plan, True))
        res["fused_bound_ms"] = res["bound_ms"]
        times = f"gn_bwd_fused {res['fused_graph_ms']:.4f}"
    else:
        gpart, _ = G.gn_bwd_reduce(x, g, stats, scale, bias, 32, silu, plan, True)
        res["reduce_graph_ms"] = graph_ms(lambda: G.gn_bwd_reduce(x, g, stats, scale, bias, 32,
                                                                  silu, plan, True))
        res["dx_graph_ms"] = graph_ms(lambda: G.gn_bwd_dx(x, g, stats, gpart, scale, bias, 32,
                                                          silu, plan))
        res["reduce_bound_ms"] = bound(2 * x_bytes + affine)[0]
        res["dx_bound_ms"] = bound(3 * x_bytes + 2 * shape[1] * x.element_size())[0]
        res["floor_ms"] = bound(5 * x_bytes + affine)[0]
        times = (f"gn_bwd_reduce {res['reduce_graph_ms']:.4f} (least {res['reduce_bound_ms']:.4f})"
                 f", gn_bwd_dx {res['dx_graph_ms']:.4f} (least {res['dx_bound_ms']:.4f}); "
                 f"5-pass floor {res['floor_ms']:.4f} ms")
    log(f"{where}: {errs_text} | single: backward {res['ms']:.4f} ms plain {res['plain_ms']:.4f}"
        f" ms F.group_norm{'+silu' if silu else ''} autograd {res['library_ms']:.4f} ms | 20 as "
        f"a CUDA graph: {res['graph_ms']:.4f} ms ({times}) | least {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']} (3 passes), reached {res['bound_ms'] / res['graph_ms']:.1%} | host "
        f"{res['host_us']:.1f} us a call")
    del xx, y
    return res


def check_gn_bwd(gen, cases=None) -> dict:
    """The GroupNorm backward on the forward's statistics (`gn_bwd_fused`
    where `gn_bwd_plan` gives a map one cluster launch, else `gn_bwd_reduce`
    + `gn_bwd_dx`) against the closed-form plain VJP (dx, dγ, dβ) at every
    UNet GroupNorm shape at batch 16, fp32, and the VAE decoder's maps at
    batch 2, or at `cases` (label, shape, eps, silu, dtype) alone; the
    statistics the forward kept against `gn_stats_plain`; two runs to the
    same bits. Off the path, untimed: the decoder's resnet maps without SiLU
    and the split pair forced at a UNet map. Each timed case prints its plan,
    each kernel's device time (20 launches as a CUDA graph) beside its own
    bound, the whole backward's single and graph times beside its 3-pass
    bound (and the split pair's 5-pass floor), the library's `F.group_norm`
    (+ `F.silu`) autograd backward, and the host's µs a call."""
    from adaface_tpu_torch.ops import fused_gn as G

    results, off_path = {}, []
    if cases is None:
        cases = [(f"{label} batch 16", (16, c, hw, hw), eps, silu, torch.bfloat16)
                 for label, c, hw, eps, silu, _ in UNET_GN]
        cases.append(("resnet 64x64 320 fp32", (2, 320, 64, 64), 1e-5, True, torch.float32))
        cases += [(f"vae {label} batch 2", (2, c, hw, hw), 1e-6, silu, torch.bfloat16)
                  for label, c, hw, silu, dec, _ in VAE_GN if dec]
        off_path = [(f"vae {label} batch 2 no silu", (2, c, hw, hw), 1e-6, False,
                     torch.bfloat16, None) for label, c, hw, silu, dec, _ in VAE_GN
                    if dec and silu]
        off_path.append(("resnet 64x64 320 batch 16 split", (16, 320, 64, 64), 1e-5, True,
                         torch.bfloat16, "split"))
    for label, shape, eps, silu, dtype, kernel in off_path:
        results[label] = gn_bwd_case(G, label, shape, eps, silu, dtype, gen, kernel, False)
        torch.cuda.empty_cache()
    for label, shape, eps, silu, dtype in cases:
        results[label] = gn_bwd_case(G, label, shape, eps, silu, dtype, gen)
        torch.cuda.empty_cache()
    return results


TRAIN_CONFIG = "configs/stage1-distill-arc2face.yaml"
# micro-steps of the training phase: 3 optimizer updates at the config's
# accumulation of 2, the planner's teacher buckets 2, 3, 4 twice (seed 0)
TRAIN_MICRO_STEPS = 6
TRAIN_SUBJECTS = 2  # of TRAIN_PHOTOS synthetic 512x512 PNGs each
TRAIN_PHOTOS = 2
# SubjBasisGenerator gradients of one student step, kernels against the
# plain versions (bf16 UNet), relative L2 over all of them: the prediction
# written in PERF.md before the first run is 2e-2; the UNet call's 5e-2 is
# the ceiling held here
TRAIN_GRAD_REL_L2 = 5e-2


def write_train_photos(root: str, size: int = 512) -> str:
    """A PersonalizedBase folder: TRAIN_SUBJECTS subjects of TRAIN_PHOTOS
    random RGB PNGs, written with the port's PNG writer."""
    import os

    from adaface_tpu_torch.utils.image import write_png

    rs = np.random.RandomState(SEED + 7)
    for s in range(TRAIN_SUBJECTS):
        d = os.path.join(root, f"subject{s}")
        os.makedirs(d)
        for i in range(TRAIN_PHOTOS):
            write_png(os.path.join(d, f"{i}.png"),
                      rs.randint(0, 256, (size, size, 3)).astype(np.uint8))
    return root


# the VAE decoder's GroupNorm maps (C, H = W): no UNet map has them
VAE_DECODER_GN_MAPS = {(c, hw) for _, c, hw, _, dec, _ in VAE_GN if dec}
GN_BWD_VAE = "gn_bwd at the VAE decoder's maps"  # a census count, not a launch key
VAE_DECODE_GN = sum(dec for *_, dec, _ in VAE_GN)  # GroupNorms of one decode: 30


def backward_census(loss, want: collections.Counter) -> None:
    """Add to `want` the backward launches the autograd graph of `loss`
    holds: per flash node `flash_bwd_delta`, `flash_bwd_dkdv[wg]` where k or
    v needs a gradient and `flash_bwd_dq[wg]` where q does (at head dim 512
    the `[d512]` keys); per GroupNorm node one `gn_bwd_fused`
    or one `gn_bwd_reduce` and one `gn_bwd_dx`, as the node's plan says, and
    the nodes on the VAE decoder's maps under GN_BWD_VAE. The nodes' head
    dims, map shapes and plans are read from attributes the Functions set, so
    the saved tensors of a recomputed (checkpointed) decoder are not
    unpacked."""
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops.fused_gn import GN_BWD_DX, GN_BWD_FUSED, GN_BWD_REDUCE

    seen, stack = set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        name = type(node).__name__
        if name == "_FlashAttentionBackward":
            nq, nk, nv = node.needs_input_grad[:3]
            wide = -(-node.head_dim // 16) == A.BWD_WIDE_KSTEPS
            delta, dkdv, dq = ((A.FLASH_BWD_DELTA_WIDE, A.FLASH_BWD_DKDV_WIDE,
                                A.FLASH_BWD_DQ_WIDE) if wide else
                               (A.FLASH_BWD_DELTA, A.FLASH_BWD_DKDV_WG, A.FLASH_BWD_DQ_WG))
            want[delta] += 1
            want[dkdv] += int(nk or nv)
            want[dq] += int(nq)
        elif name == "_GroupNormSiLUBackward":
            if node.bwd_kernel == "fused":
                want[GN_BWD_FUSED] += 1
            else:
                want[GN_BWD_REDUCE] += 1
                want[GN_BWD_DX] += 1
            want[GN_BWD_VAE] += int((node.shape[1], node.shape[2]) in VAE_DECODER_GN_MAPS)
        stack.extend(f for f, _ in node.next_functions)


def fit_gn_backward(phase: str, counts: dict) -> dict:
    """After a fit: no `gn_stats` launched by a backward (a forward on the
    split pair launches one `gn_stats` and one `gn_norm`; the backward reads
    the statistics its forward kept), and the incoming gradients the
    GroupNorm backward had to copy to channels-last memory, by shape (reset
    before the fit; reported, not held)."""
    from adaface_tpu_torch.ops import fused_gn as G

    copies = dict(G.G_COPIES)
    log(f"{phase}: gn_stats {counts.get(G.GN_STATS, 0)} and gn_norm {counts.get(G.GN_NORM, 0)} "
        f"launches (none from a backward); GroupNorm backward gn_bwd_fused "
        f"{counts.get(G.GN_BWD_FUSED, 0)}, gn_bwd_reduce {counts.get(G.GN_BWD_REDUCE, 0)}, "
        f"gn_bwd_dx {counts.get(G.GN_BWD_DX, 0)}; incoming gradients copied to channels-last: "
        f"{copies or 'none'}")
    if counts.get(G.GN_STATS, 0) != counts.get(G.GN_NORM, 0):
        raise AssertionError(f"{phase}: gn_stats launched outside a forward: {counts}")
    return copies


def fit_flash_lookups(phase: str, counts: dict) -> dict:
    """After a fit: the flash caches' lookups since their reset (the
    backward's tensor maps of q, k, v and g join the forward's in one cache
    keyed on address and layout), and the check that every backward read the
    statistics its forward kept: no forward launch made for them
    (FLASH_BWD_STATS)."""
    from adaface_tpu_torch.ops import attention as A

    lookups = A.cache_lookups()
    log(f"{phase}: flash cache lookups over the fit {lookups}")
    if counts.get(A.FLASH_BWD_STATS, 0):
        raise AssertionError(f"{phase}: {counts[A.FLASH_BWD_STATS]} backward calls found no "
                             "statistics from their forward")
    return lookups


def sbg_snapshot(trainer) -> list:
    return [p.detach().clone() for p in trainer.state.optimizer.params]


def sbg_grads(trainer, batch) -> tuple[list, float]:
    """(the SubjBasisGenerator's gradients, the loss) of one student step on
    `batch`, without the optimizer."""
    from adaface_tpu_torch.train.train_step import unet_distill_loss_fn

    params = trainer.state.optimizer.params
    for p in params:
        p.grad = None
    loss, _ = unet_distill_loss_fn(trainer.state.params, trainer.frozen, batch, trainer.schedule,
                                   trainer.tcfg)
    loss.backward()
    out = [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p) for p in params]
    for p in params:
        p.grad = None
    return out, loss.item()


def sync_ms(fn):
    """(fn's result, its ms on the host clock with the device synchronized
    before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


class TimedTeacher:
    """A teacher whose calls are timed on the host clock, the device
    synchronized before and after."""

    def __init__(self, teacher):
        self.teacher, self.ms = teacher, []

    def __getattr__(self, name):
        return getattr(self.teacher, name)

    def __call__(self, *a, **kw):
        out, ms = sync_ms(lambda: self.teacher(*a, **kw))
        self.ms.append(ms)
        return out


def train_step_split(trainer, dataset, step: int) -> dict:
    """One micro-step's time on the host clock, split into host prep (the
    batch without the teacher: collate, VAE encode, face ID → image
    prompts, prompts), the teacher, the student's forward and backward, and
    the optimizer, each with the device synchronized around it."""
    from adaface_tpu_torch.train.train_step import trainable_parameters, unet_distill_loss_fn

    flags = trainer.planner.plan(step)
    teacher = trainer.teacher
    examples = [dataset[i] for i in range(trainer.cfg.batch_size)]
    trainer.teacher = timed = TimedTeacher(teacher)
    try:
        batch, prep_ms = sync_ms(lambda: trainer._prepare_batch(examples, flags,
                                                                trainer.draws_for(flags)))
    finally:
        trainer.teacher = teacher
    teacher_ms = timed.ms
    params = trainable_parameters(trainer.state.params)

    def student():
        for p in params:
            p.grad = None
        loss, _ = unet_distill_loss_fn(trainer.state.params, trainer.frozen, batch,
                                       trainer.schedule, trainer.tcfg)
        loss.backward()
        return loss

    _, student_ms = sync_ms(student)
    update, opt_ms = sync_ms(trainer.state.optimizer.step)
    return dict(steps=flags.num_denoising_steps, host_prep_ms=prep_ms - teacher_ms[0],
                teacher_ms=teacher_ms[0], student_ms=student_ms, optimizer_ms=opt_ms,
                update=update, total_ms=prep_ms + student_ms + opt_ms)


def train_stage1(gen) -> dict:
    """Stage-1 UNet distillation on the card at full SD1.5 width, through
    `train_torch.build_trainer` and `Trainer.fit` with the configuration of
    TRAIN_CONFIG (SD1.5 UNet and VAE encoder in bf16, CLIP-L text and the
    Arc2Face encoder in fp32, the default face backend, prodigy, grad clip
    0.2, accumulation 2, batch 4, the teacher's buckets of 2-4 steps, batches
    prepared two ahead in a second thread) on synthetic 512x512 PNGs:
    TRAIN_MICRO_STEPS micro-steps with finite losses, the SubjBasisGenerator
    still after odd micro-steps and moved after even ones, the backward
    kernels' launches as the autograd graphs of the student steps hold
    them, a checkpoint written by the fit's cadence that reloads equal, one
    student step's SubjBasisGenerator gradients kernels against plain, the
    step's time split, the device's busy share and the peak memory."""
    import tempfile

    import train_torch
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import fused_gn as G
    from adaface_tpu_torch.train.checkpoint import load_adaface_ckpt
    from adaface_tpu_torch.train.train_step import make_train_step, unet_distill_loss_fn

    # every UNet map's backward is one cluster launch: the split pair stays at 0
    ran = (A.FLASH_BWD_DELTA, A.FLASH_BWD_DKDV_WG, A.FLASH_BWD_DQ_WG, G.GN_BWD_FUSED)
    bwd_keys = ran + (G.GN_BWD_REDUCE, G.GN_BWD_DX)
    repo = str(pathlib.Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=repo) as tmp:
        data = write_train_photos(os.path.join(tmp, "photos"))
        cfg, args = train_torch.parse_args([
            f"trainer.ckpt_every={TRAIN_MICRO_STEPS}", "--base", os.path.join(repo, TRAIN_CONFIG),
            "--data_roots", data, "--log_dir", os.path.join(tmp, "logs"),
            "--max_steps", str(TRAIN_MICRO_STEPS)])
        t0 = time.perf_counter()
        trainer, dataset, start = train_torch.build_trainer(cfg, args)
        torch.cuda.synchronize()
        log(f"train: the stack at full width on the card in {time.perf_counter() - t0:.1f} s; "
            f"{len(trainer.state.optimizer.params)} trainable tensors, "
            f"{sum(p.numel() for p in trainer.state.optimizer.params)} parameters; optimizer "
            f"{trainer.cfg.optimizer}, accumulation {trainer.cfg.accum_steps}, batch "
            f"{trainer.cfg.batch_size}, prefetch {trainer.cfg.prefetch}")

        # one student step's gradients, kernels against plain, at batch 1 of
        # the 2-step bucket (the plain attention's fp32 scores of the batch-16
        # bucket would not fit beside the activations)
        flags = dataclasses.replace(trainer.planner.plan(0), num_denoising_steps=2)
        trainer.planner = type(trainer.planner)(**{
            f.name: getattr(trainer.planner, f.name)
            for f in dataclasses.fields(trainer.planner)})  # the fit plans from step 0 again
        one = trainer._prepare_batch([dataset[0]], flags, trainer.draws_for(flags))
        kernel_grads, kernel_loss = sbg_grads(trainer, one)
        with plain_versions():
            plain_grads, plain_loss = sbg_grads(trainer, one)
        num = sum(((a.float() - b.float()) ** 2).sum() for a, b in zip(kernel_grads, plain_grads))
        den = sum((b.float() ** 2).sum() for b in plain_grads)
        grad_rel = (num / den).sqrt().item()
        finite = all(torch.isfinite(g).all() for g in kernel_grads)
        log(f"train: one student step at UNet batch 2, kernels against plain: loss "
            f"{kernel_loss:.6e} / {plain_loss:.6e}, SubjBasisGenerator gradients relative L2 "
            f"{grad_rel:.3e} (ceiling {TRAIN_GRAD_REL_L2:.0e}), norm {den.sqrt().item():.3e}")
        if not finite or not math.isfinite(kernel_loss) or grad_rel > TRAIN_GRAD_REL_L2:
            raise AssertionError(f"train: gradients kernels against plain {grad_rel}, finite "
                                 f"{finite}")
        del one, kernel_grads, plain_grads

        # the fit: the backward launches each student graph holds, the
        # parameters after each micro-step
        want = collections.Counter()

        def census_loss(*a):
            loss, metrics = unet_distill_loss_fn(*a)
            backward_census(loss, want)
            return loss, metrics

        trainer._steps[("unet_distill",)] = make_train_step(census_loss, trainer.frozen,
                                                            trainer.schedule, trainer.tcfg)
        post, records = trainer._post_step, []
        before = [sbg_snapshot(trainer)]

        def watch(step, f, metrics):
            after = sbg_snapshot(trainer)
            moved = any(not torch.equal(a, b) for a, b in zip(before[0], after))
            records.append(dict(step=step, steps=f.num_denoising_steps, moved=moved,
                                loss=float(metrics["loss"]), t=time.perf_counter()))
            before[0] = after
            post(step, f, metrics)

        trainer._post_step = watch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        A.cache_lookups(reset=True)
        G.G_COPIES.clear()
        t0 = time.perf_counter()
        trainer.fit(dataset, num_steps=args.max_steps, start_step=start)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = launch_counts()
        lookups = fit_flash_lookups("train", counts)
        copies = fit_gn_backward("train", counts)
        peak = torch.cuda.max_memory_allocated()
        del before[0]
        for r in records:
            log(f"train: micro-step {r['step']}: teacher {r['steps']} steps (UNet batch "
                f"{trainer.cfg.batch_size * r['steps']}), loss {r['loss']:.6e}, "
                f"SubjBasisGenerator moved {r['moved']}")
        gaps = [b["t"] - a["t"] for a, b in zip(records, records[1:])]
        log(f"train: {len(records)} micro-steps in {fit_s:.2f} s (first batch's preparation "
            f"included); between micro-steps {', '.join(f'{g:.3f}' for g in gaps)} s; peak "
            f"memory {peak / 2**30:.2f} GiB; launches {dict(sorted(counts.items()))}")
        fit_want = dict(want)
        per_step = {k: v / len(records) for k, v in sorted(fit_want.items())}
        log(f"train: backward launches the student graphs hold {dict(sorted(fit_want.items()))}"
            f" ({per_step} a student step); seconds per optimizer step "
            f"{2 * statistics.mean(gaps):.3f} (twice the mean gap between micro-steps)")
        if len(records) != TRAIN_MICRO_STEPS or not all(math.isfinite(r["loss"]) for r in records):
            raise AssertionError(f"train: micro-steps {records}")
        if [r["moved"] for r in records] != [i % 2 == 1 for i in range(TRAIN_MICRO_STEPS)]:
            raise AssertionError(f"train: the accumulation of 2 does not show: {records}")
        if {r["steps"] for r in records} != {2, 3, 4}:
            raise AssertionError(f"train: teacher buckets {[r['steps'] for r in records]}")
        if {k: counts.get(k, 0) for k in bwd_keys} != {k: want[k] for k in bwd_keys} \
                or not all(want[k] for k in ran):
            raise AssertionError(f"train: backward launches {counts}, the graphs hold {want}")

        # the fit's checkpoint reloads equal
        ck = trainer.latest_ckpt(args.log_dir)
        state, manifest = load_adaface_ckpt(ck)
        saved = state["subj_basis_generators"]["joint"]
        live = {n: p for n, p in trainer.state.params["sbg"].named_parameters() if n in saved}
        equal = (manifest["step"] == TRAIN_MICRO_STEPS and set(saved) == set(live)
                 and all(torch.equal(saved[n], live[n].detach().cpu()) for n in saved))
        trainer.load(ck)
        equal = equal and all(torch.equal(saved[n], live[n].detach().cpu()) for n in saved)
        log(f"train: checkpoint {os.path.basename(ck)} ({len(saved)} tensors) reloads equal: "
            f"{equal}")
        if not equal:
            raise AssertionError("train: the checkpoint does not reload equal")

        # where a micro-step's time goes, and the device's busy share
        splits = [train_step_split(trainer, dataset, TRAIN_MICRO_STEPS + i) for i in range(3)]
        for sp in splits:
            log(f"train: micro-step split at {sp['steps']} teacher steps: host prep "
                f"{sp['host_prep_ms']:.1f} ms, teacher {sp['teacher_ms']:.1f} ms, student "
                f"forward + backward {sp['student_ms']:.1f} ms, optimizer "
                f"{sp['optimizer_ms']:.1f} ms ({'an update' if sp['update'] else 'accumulation'}"
                f"); total {sp['total_ms']:.1f} ms (synchronized, no prefetch)")
        # one micro-step at the largest bucket, unprofiled and by kind of kernel
        from torch.profiler import ProfilerActivity, profile

        fl = dataclasses.replace(trainer.planner.plan(TRAIN_MICRO_STEPS + 3),
                                 num_denoising_steps=4)
        batch = trainer._prepare_batch([dataset[i] for i in range(trainer.cfg.batch_size)], fl,
                                       trainer.draws_for(fl))
        step_fn = trainer._get_step(fl)
        step = lambda: step_fn(trainer.state, batch)  # noqa: E731
        step()
        _, wall_ms = sync_ms(step)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sync_ms(step)
        n_ops, busy_ms = profile_report(prof, "train: a micro-step at 4 teacher steps", 12)
        log(f"train: a micro-step at 4 teacher steps (UNet batch {4 * trainer.cfg.batch_size}), "
            f"prepared batch: "
            f"{wall_ms:.1f} ms on the host clock, device busy {busy_ms:.1f} ms in {n_ops} "
            f"operations under the profiler ({busy_ms / wall_ms:.1%} of the unprofiled wall)")
    return dict(counts=counts, want=fit_want, records=records, fit_s=fit_s, peak=peak,
                grad_rel=grad_rel, splits=splits, busy_ms=busy_ms, wall_ms=wall_ms,
                lookups=lookups, copies=copies)


JOINT_CONFIG = "configs/stage1-distill-joint.yaml"
JOINT_MICRO_STEPS = 4  # 2 optimizer updates at the config's accumulation of 2
JOINT_SUFFIX = 4  # static suffix embeddings a SubjBasisGenerator (`train.py`'s default)


def train_stage1_joint(card: str) -> dict:
    """Stage-1 UNet distillation of the joint encoder (Arc2Face +
    ConsistentID, each SubjBasisGenerator with its 4 static suffix
    embeddings) at full SD1.5 width through `train_torch.build_trainer` and
    `Trainer.fit` with JOINT_CONFIG and no override but the data, the log
    dir and JOINT_MICRO_STEPS (batch 4, accumulation 2, prodigy, the
    teacher's 2-4 step chain with CFG at p 0.5 over the 20 image-prompt
    tokens) on synthetic 512x512 PNGs: the suffix embeddings' gradient
    of one student step by sub-encoder (finite; Arc2Face's not 0;
    ConsistentID's 0, as in the JAX package: its 4 + 4 ada tokens follow the
    20 the placeholder holds, `tests/test_torch_stage1_configs.py`); the fit
    with its losses, each SubjBasisGenerator's largest update, seconds per
    optimizer step on the host clock, the launches by kernel and the peak
    memory; `Trainer.save`, then the checkpoint loaded into a fresh joint
    encoder (`load_subj_basis_generators`) whose ada tokens equal the
    trainer's encoder's bit for bit; one more optimizer step under the
    profiler for its device time; two micro-steps with `sample_every` 1,
    their previews decoded by the sample logger's worker."""
    import tempfile

    import train_torch
    from torch.profiler import ProfilerActivity, profile

    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import create_id2ada_prompt_encoder
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import fused_gn as G
    from adaface_tpu_torch.text.tokenizer import default_tokenizer
    from adaface_tpu_torch.train.checkpoint import load_subj_basis_generators
    from adaface_tpu_torch.train.train_step import trainable_parameters, unet_distill_loss_fn

    t_phase = time.perf_counter()
    ran = (A.FLASH_T, A.FLASH_STD, A.FLASH_BWD_DELTA, A.FLASH_BWD_DKDV_WG, A.FLASH_BWD_DQ_WG,
           G.GN_FUSED, G.GN_BWD_FUSED)
    repo = str(pathlib.Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=repo) as tmp:
        data = write_train_photos(os.path.join(tmp, "photos"))
        cfg, args = train_torch.parse_args([
            "--base", os.path.join(repo, JOINT_CONFIG), "--data_roots", data,
            "--log_dir", os.path.join(tmp, "logs"), "--max_steps", str(JOINT_MICRO_STEPS)])
        t0 = time.perf_counter()
        trainer, dataset, start = train_torch.build_trainer(cfg, args)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        encs, sbgs = trainer.encoder.encoders, trainer.state.params["sbg"]
        width = trainer.em.placeholders[0].num_vectors
        if [s.cfg.num_static_img_suffix_embs for s in sbgs] != [JOINT_SUFFIX] * 2 or width != 20 \
                or [e.subj_basis_generator for e in encs] != list(sbgs):
            raise AssertionError(f"joint: suffixes {[s.cfg for s in sbgs]}, placeholder {width}")
        log(f"joint: the stack at full width on the card in {build_s:.1f} s; "
            f"{len(trainer.state.optimizer.params)} trainable tensors, "
            f"{sum(p.numel() for p in trainer.state.optimizer.params)} parameters in "
            f"{len(sbgs)} SubjBasisGenerators (suffix {JOINT_SUFFIX} each), placeholder {width}; "
            f"optimizer {trainer.cfg.optimizer}, accumulation {trainer.cfg.accum_steps}, batch "
            f"{trainer.cfg.batch_size}, teacher p_uses_cfg {trainer.teacher.p_uses_cfg}")

        # the suffix embeddings' gradient of one student step (2-step bucket)
        flags = dataclasses.replace(trainer.planner.plan(0), num_denoising_steps=2)
        trainer.planner = type(trainer.planner)(**{
            f.name: getattr(trainer.planner, f.name)
            for f in dataclasses.fields(trainer.planner)})  # the fit plans from step 0 again
        batch = trainer._prepare_batch([dataset[i] for i in range(trainer.cfg.batch_size)],
                                       flags, trainer.draws_for(flags))
        params = trainable_parameters(trainer.state.params)
        for p in params:
            p.grad = None
        loss, _ = unet_distill_loss_fn(trainer.state.params, trainer.frozen, batch,
                                       trainer.schedule, trainer.tcfg)
        loss.backward()
        def grad_norm(tensors) -> float:
            return math.sqrt(sum(p.grad.float().pow(2).sum().item() for p in tensors
                                 if p.grad is not None))

        sfx = [grad_norm([s.static_img_suffix_embs]) for s in sbgs]
        sbg_norm = [grad_norm(s.parameters()) for s in sbgs]
        for p in params:
            p.grad = None
        del batch
        log(f"joint: one student step (loss {loss.item():.6e}): the suffix embeddings' gradient "
            f"norm Arc2Face {sfx[0]:.6e}, ConsistentID {sfx[1]:.6e}; the SubjBasisGenerators' "
            f"{sbg_norm[0]:.6e}, {sbg_norm[1]:.6e} (ConsistentID's ada tokens lie past the 20 "
            f"the placeholder holds: 0, as in the JAX package)")
        if not all(map(math.isfinite, sfx + sbg_norm)) or not sfx[0] > 0 or sbg_norm[1] != 0:
            raise AssertionError(f"joint: suffix gradients {sfx}, generators {sbg_norm}")

        # the fit
        before = [[p.detach().clone() for p in s.parameters() if p.requires_grad] for s in sbgs]
        post, records = trainer._post_step, []

        def watch(step, f, metrics):
            records.append(dict(step=step, steps=f.num_denoising_steps,
                                loss=float(metrics["loss"]), t=time.perf_counter()))
            post(step, f, metrics)

        trainer._post_step = watch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit(dataset, num_steps=args.max_steps, start_step=start)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        trainer._post_step = post
        updates = [max((p.detach() - b).abs().max().item()
                       for p, b in zip([p for p in s.parameters() if p.requires_grad], bs))
                   for s, bs in zip(sbgs, before)]
        del before
        gaps = [b["t"] - a["t"] for a, b in zip(records, records[1:])]
        host_s = 2 * statistics.mean(gaps)
        for r in records:
            log(f"joint: micro-step {r['step']}: teacher {r['steps']} steps, loss "
                f"{r['loss']:.6e}")
        log(f"joint: {len(records)} micro-steps in {fit_s:.2f} s (the first batch's preparation "
            f"included): {host_s:.3f} s per optimizer step on the host clock (twice the mean gap "
            f"between micro-steps), {fit_s / (len(records) / 2):.3f} s with the first batch; "
            f"peak memory {peak / 2**30:.2f} GiB; the SubjBasisGenerators' largest update "
            f"Arc2Face {updates[0]:.3e}, ConsistentID {updates[1]:.3e}; launches by kernel "
            f"{dict(sorted(counts.items()))}")
        if len(records) != JOINT_MICRO_STEPS or not all(math.isfinite(r["loss"]) for r in records):
            raise AssertionError(f"joint: micro-steps {records}")
        if not all(counts.get(k, 0) for k in ran) or not updates[0] > 0:
            raise AssertionError(f"joint: launches {counts}, updates {updates}")

        # the checkpoint into a fresh joint encoder: the same ada tokens
        ck = trainer.save(JOINT_MICRO_STEPS)
        fresh = create_id2ada_prompt_encoder(
            "jointIDs", torch.Generator("cuda").manual_seed(SEED + 31), default_tokenizer(),
            "cuda", is_training=True, out_id_embs_cfg_scales=tuple(cfg["model"][
                "out_id_embs_cfg_scales"]), num_static_img_suffix_embs=JOINT_SUFFIX)
        # a checkpoint leaves out the prompt2token_proj towers' embedding
        # tables: both encoders take them from the same CLIP-L weights
        frozen_tables = ("clip.token_embedding", "clip.position_embedding")
        for e, trained in zip(fresh.encoders, sbgs):
            ref = trained.state_dict()
            e.subj_basis_generator.load_state_dict({k: ref[k] for k in frozen_tables},
                                                   strict=False)
        x = torch.randn((2, width, 768), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED + 32))

        def ada(encoder):
            out, off = [], 0
            for e in encoder.encoders:
                n = e.subj_basis_generator.cfg.num_id_vecs
                out.append(e.subj_basis_generator(
                    x[:, off:off + n], out_id_embs_cfg_scale=e.out_id_embs_cfg_scale,
                    is_face=True, enable_static_img_suffix_embs=True))
                off += n
            return torch.cat(out, dim=1)

        with torch.no_grad():
            mine, unloaded = ada(trainer.encoder), ada(fresh)
            load_subj_basis_generators(fresh, ck)
            theirs = ada(fresh)
        equal = torch.equal(mine, theirs)
        apart = (mine - unloaded).abs().max().item()
        log(f"joint: {os.path.basename(ck)} into a fresh joint encoder: ada tokens "
            f"{tuple(theirs.shape)} equal to the trainer's bit for bit: {equal} (before the "
            f"load {apart:.3e} apart)")
        if not equal or not apart > 0 or tuple(mine.shape) != (2, 20 + 2 * JOINT_SUFFIX, 768):
            raise AssertionError(f"joint: reloaded ada tokens {tuple(theirs.shape)} differ "
                                 f"by {(mine - theirs).abs().max().item()}")
        del fresh, mine, theirs

        # one optimizer step (2 micro-steps) under the profiler: device time
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.fit(dataset, num_steps=2, start_step=JOINT_MICRO_STEPS)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        n_ops, busy_ms = profile_report(prof, "joint: one optimizer step", 10)

        # the previews of `sample_every` on the card: the sample logger's worker
        # decodes each micro-step's latents on its own stream (a random bf16
        # VAE decoder, as `train_torch.py` builds one for them)
        from adaface_tpu_torch.core.params import build, init_fan_in_
        from adaface_tpu_torch.models.vae import VAEDecoder
        from adaface_tpu_torch.utils.image import read_png
        from adaface_tpu_torch.utils.sample_logger import SampleLogger

        trainer.frozen["vae"] = build(VAEDecoder, "cuda", torch.bfloat16, init_fan_in_,
                                      torch.Generator("cuda").manual_seed(SEED + 33))
        trainer.sample_logger = SampleLogger(trainer.cfg.log_dir)
        trainer.cfg.sample_every = 1
        t0 = time.perf_counter()
        trainer.fit(dataset, num_steps=2, start_step=JOINT_MICRO_STEPS + 2)
        preview_s = time.perf_counter() - t0
        shown = sorted(os.listdir(trainer.sample_logger.dir))
        grids = [read_png(os.path.join(trainer.sample_logger.dir, n)) for n in shown]
        log(f"joint: 2 micro-steps with a preview each in {preview_s:.2f} s (decoded by the "
            f"sample logger's worker): {shown}, grids {[g.shape for g in grids]}")
        if shown != [f"{JOINT_MICRO_STEPS + 2 + i:07d}_unet_distill.png" for i in range(2)] \
                or any(g.shape != (520, 2080, 3) or g.std() == 0 for g in grids):
            raise AssertionError(f"joint: previews {shown}")
        trainer.sample_logger.close()
    secs = time.perf_counter() - t_phase
    log(f"joint: one optimizer step (2 micro-steps, their batches prepared): device busy "
        f"{busy_ms:.1f} ms in {n_ops} operations, {prof_s:.2f} s on the host clock under the "
        f"profiler; card {card}; the phase {secs:.1f} s")
    return dict(counts=counts, records=records, fit_s=fit_s, host_s_per_step=host_s,
                device_ms_per_step=busy_ms, peak=peak, suffix_grad=sfx, sbg_grad=sbg_norm,
                updates=updates, reloaded_equal=equal, build_s=build_s, preview_s=preview_s,
                seconds=secs)


FINETUNE_CONFIG = "configs/finetune-unet.yaml"
# micro-steps of the finetuning phase: 3 optimizer updates at the config's
# accumulation of 4 (the first at the warmup's learning rate of 0, so the
# parameters move at the second and the third); from step 0 the planner
# (seed 0, the config's probabilities) draws steps 5 and 7 on pure noise
FINETUNE_MICRO_STEPS = 12
FINETUNE_SPLIT_STEPS = (0, 5)  # an on-image and a pure-noise micro-step, split by part
# one recon step's gradients, kernels against plain (bf16 UNet compute, bf16
# decoder), relative L2 over the SubjBasisGenerator's and over the UNet's:
# the prediction is written in PERF.md before the first run; the UNet call's
# 5e-2 is the ceiling held here
FINETUNE_GRAD_REL_L2 = 5e-2


def central_face(img):
    """One face whatever the pixels: the central 60% of the image."""
    h, w = img.shape[:2]
    return [(np.array([0.2 * w, 0.2 * h, 0.8 * w, 0.8 * h], np.float32), 1.0)]


def recon_loss_for(trainer, flags):
    """The recon loss function the trainer builds for `flags`."""
    from adaface_tpu_torch.train.recon_step import make_recon_loss_fn

    rcfg = dataclasses.replace(trainer.cfg.recon_cfg, on_pure_noise=flags.normal_recon_on_pure_noise,
                               do_adv_attack=flags.do_adv_attack)
    return make_recon_loss_fn(rcfg, trainer.host_detector)


def recon_grads(trainer, flags, batch) -> tuple[list, float]:
    """(the gradients of every trainable parameter, the loss) of one recon
    step on `batch`, its loss's draws from the step's fresh stream."""
    from adaface_tpu_torch.core.device import fp32_convolutions

    params = trainer.state.optimizer.params
    for p in params:
        p.grad = None
    loss, _ = recon_loss_for(trainer, flags)(trainer.state.params, trainer.frozen, batch,
                                             trainer.schedule, trainer.tcfg,
                                             trainer.draws_for(flags, loss=True))
    with fp32_convolutions():  # as `make_train_step` runs the backward
        loss.backward()
    out = [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
           for p in params]
    for p in params:
        p.grad = None
    return out, loss.item()


def rel_l2_lists(out: list, ref: list) -> float:
    num = sum(((a.float() - b.float()) ** 2).sum() for a, b in zip(out, ref))
    return (num / sum((b.float() ** 2).sum() for b in ref)).sqrt().item()


def param_sums(trainer) -> list:
    """Each trainable tensor's fp64 sum (moves when any element does), read
    back in one transfer."""
    return torch.stack([p.detach().double().sum()
                        for p in trainer.state.optimizer.params]).tolist()


class SyncTimer:
    """Patch module functions with wrappers that time each call on the host
    clock, the device synchronized before and after, by part."""

    def __init__(self):
        self.ms = collections.defaultdict(float)
        self._patches = []

    def wrap(self, module, name, part, made: bool = False):
        """Time the calls of `module.name`, or with `made` the calls of the
        functions it returns."""
        real = getattr(module, name)

        def timing(fn):
            def timed(*a, **kw):
                out, ms = sync_ms(lambda: fn(*a, **kw))
                self.ms[part] += ms
                return out
            return timed

        patched = (lambda *a, **kw: timing(real(*a, **kw))) if made else timing(real)
        self._patches.append(mock.patch.object(module, name, patched))

    def __enter__(self):
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def finetune_step_split(trainer, dataset, flags) -> dict:
    """One recon micro-step on the host clock, split into host prep (the
    batch: collate, VAE encode, face ID → image prompts, input detection,
    prompts), the UNet calls, the decodes and the ArcFace losses, host
    detection on the recons, the rest of the forward, the backward and the
    optimizer, each timed with the device synchronized around it."""
    from adaface_tpu_torch.core.device import fp32_convolutions
    from adaface_tpu_torch.train import recon_step as R
    from adaface_tpu_torch.train.train_step import trainable_parameters

    examples = [dataset[i] for i in range(trainer.cfg.batch_size)]
    batch, prep_ms = sync_ms(lambda: trainer._prepare_batch(examples, flags,
                                                            trainer.draws_for(flags)))
    timer = SyncTimer()
    real_runner = R.unet_runner

    def timed_runner(*a, **kw):
        unet = real_runner(*a, **kw)

        def call(*x, **y):
            out, ms = sync_ms(lambda: unet(*x, **y))
            timer.ms["unet"] += ms
            return out
        return call

    timer._patches.append(mock.patch.object(R, "unet_runner", timed_runner))
    timer.wrap(R, "vae_decode", "decode")
    timer.wrap(R, "calc_arcface_align_loss", "arcface")
    timer.wrap(R, "calc_bg_faces_suppress_loss", "arcface")
    timer.wrap(R, "detect_faces", "detection")
    params = trainable_parameters(trainer.state.params)
    for p in params:
        p.grad = None
    with timer:
        (loss, _), fwd_ms = sync_ms(lambda: recon_loss_for(trainer, flags)(
            trainer.state.params, trainer.frozen, batch, trainer.schedule, trainer.tcfg,
            trainer.draws_for(flags, loss=True)))
    with fp32_convolutions():  # as `make_train_step` runs the backward
        _, bwd_ms = sync_ms(loss.backward)
    update, opt_ms = sync_ms(trainer.state.optimizer.step)
    parts = dict(timer.ms)
    return dict(noise=flags.normal_recon_on_pure_noise, host_prep_ms=prep_ms,
                unet_ms=parts.get("unet", 0.0), decode_ms=parts.get("decode", 0.0),
                arcface_ms=parts.get("arcface", 0.0), detection_ms=parts.get("detection", 0.0),
                other_forward_ms=fwd_ms - sum(parts.values()), backward_ms=bwd_ms,
                optimizer_ms=opt_ms, update=update, total_ms=prep_ms + fwd_ms + bwd_ms + opt_ms)


def train_finetune(gen) -> dict:
    """Full-UNet finetuning on the card at full SD1.5 width, through
    `train_torch.build_trainer` and `Trainer.fit` with FINETUNE_CONFIG (every
    iteration recon; the UNet's fp32 master weights trained beside the
    SubjBasisGenerator, computed in bf16; the VAE encoder and decoder in
    bf16; CLIP-L text, the Arc2Face encoder and a random ArcFace in fp32;
    cautious AdamW, grad clip 0.2, accumulation 4, batch 2) on synthetic
    512x512 PNGs, with a detector of one central face injected (the default
    chain's backend, printed, finds no face in random photos). One recon
    step's gradients
    kernels against plain; FINETUNE_MICRO_STEPS micro-steps with finite
    losses, on images and on pure noise, the trainable parameters still
    inside an accumulation window and moved at each update, the backward
    kernels' launches (the D 512 flash backward and the GroupNorm backward at
    the decoder's maps among them) as the autograd graphs hold them; the
    fit's checkpoint with `unet_fp16.safetensors` reloads equal; a micro-step's
    split, the device's busy share, the peak memory; and the adversarial
    gradient once at full width."""
    import tempfile

    import train_torch
    from adaface_tpu_torch.core.bridge import tree_state_dict
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import fused_gn as G
    from adaface_tpu_torch.tools.ckpt_lib import cast_fp16, load_state_dict
    from adaface_tpu_torch.train.checkpoint import load_adaface_ckpt
    from adaface_tpu_torch.train.face_detect import HostFaceDetector, map_bboxes_to_latent
    from adaface_tpu_torch.train.optimizers import _lr_at
    from adaface_tpu_torch.train.recon_multistep import calc_arcface_adv_grad
    from adaface_tpu_torch.train.train_step import make_train_step

    bwd_keys = (A.FLASH_BWD_DELTA, A.FLASH_BWD_DKDV_WG, A.FLASH_BWD_DQ_WG,
                A.FLASH_BWD_DELTA_WIDE, A.FLASH_BWD_DKDV_WIDE, A.FLASH_BWD_DQ_WIDE,
                G.GN_BWD_FUSED, G.GN_BWD_REDUCE, G.GN_BWD_DX)
    repo = str(pathlib.Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=repo) as tmp:
        data = write_train_photos(os.path.join(tmp, "photos"))
        cfg, args = train_torch.parse_args([
            f"trainer.ckpt_every={FINETUNE_MICRO_STEPS}", "--base",
            os.path.join(repo, FINETUNE_CONFIG), "--data_roots", data, "--log_dir",
            os.path.join(tmp, "logs"), "--max_steps", str(FINETUNE_MICRO_STEPS)])
        t0 = time.perf_counter()
        trainer, dataset, start = train_torch.build_trainer(cfg, args)
        torch.cuda.synchronize()
        log(f"finetune: the stack at full width on the card in {time.perf_counter() - t0:.1f} s;"
            f" {len(trainer.state.optimizer.params)} trainable tensors, "
            f"{sum(p.numel() for p in trainer.state.optimizer.params)} parameters (UNet "
            f"{next(trainer.state.params['unet'].parameters()).dtype}, compute "
            f"{trainer.cfg.recon_cfg.compute_dtype}); optimizer {trainer.cfg.optimizer}, "
            f"accumulation {trainer.cfg.accum_steps}, batch {trainer.cfg.batch_size}, prefetch "
            f"{trainer.cfg.prefetch}")
        log(f"finetune: the default face detector chain finds backend "
            f"'{trainer.host_detector.backend}' on this machine (a random 512x512 photo has no "
            "face for it); a detector of one central face is injected")
        trainer.host_detector = HostFaceDetector(detector_fn=central_face)
        if "arcface" not in trainer.frozen or "vae" not in trainer.frozen:
            raise AssertionError("finetune: the identity towers are not wired")

        # one recon step's gradients, kernels against plain (on images)
        flags = trainer.planner.plan(0)
        trainer.planner = type(trainer.planner)(**{
            f.name: getattr(trainer.planner, f.name)
            for f in dataclasses.fields(trainer.planner)})  # the fit plans from step 0 again
        one = trainer._prepare_batch([dataset[i] for i in range(trainer.cfg.batch_size)], flags,
                                     trainer.draws_for(flags))
        kernel_grads, kernel_loss = recon_grads(trainer, flags, one)
        with plain_versions():
            plain_grads, plain_loss = recon_grads(trainer, flags, one)
        n_sbg = len(trainer.state.optimizer.params) - len(
            list(trainer.state.params["unet"].parameters()))
        grad_rel = {"sbg": rel_l2_lists(kernel_grads[:n_sbg], plain_grads[:n_sbg]),
                    "unet": rel_l2_lists(kernel_grads[n_sbg:], plain_grads[n_sbg:])}
        finite = all(torch.isfinite(g).all() for g in kernel_grads)
        log(f"finetune: one recon step on images, kernels against plain: loss "
            f"{kernel_loss:.6e} / {plain_loss:.6e}; gradients relative L2 SubjBasisGenerator "
            f"{grad_rel['sbg']:.3e}, UNet {grad_rel['unet']:.3e} (ceiling "
            f"{FINETUNE_GRAD_REL_L2:.0e})")
        if not finite or not math.isfinite(kernel_loss) or max(grad_rel.values()) \
                > FINETUNE_GRAD_REL_L2:
            raise AssertionError(f"finetune: gradients kernels against plain {grad_rel}, finite "
                                 f"{finite}")
        del one, kernel_grads, plain_grads
        torch.cuda.empty_cache()

        # the fit: the backward launches each recon graph holds, the
        # parameters after each micro-step
        want = collections.Counter()

        def census(loss_fn):
            def loss_and_census(*a):
                loss, metrics = loss_fn(*a)
                backward_census(loss, want)
                return loss, metrics
            return loss_and_census

        real_get = trainer._get_step

        def get_step(f):
            key = ("recon", f.normal_recon_on_pure_noise, f.do_adv_attack, f.recon_ffn_adapter)
            if key not in trainer._steps:
                trainer._steps[key] = make_train_step(census(recon_loss_for(trainer, f)),
                                                      trainer.frozen, trainer.schedule,
                                                      trainer.tcfg)
            return real_get(f)

        trainer._get_step = get_step
        post, records = trainer._post_step, []
        before = [param_sums(trainer)]

        core = trainer.state.optimizer.optimizer
        count = [core.count]

        def watch(step, f, metrics):
            after = param_sums(trainer)
            moved = [a != b for a, b in zip(before[0], after)]
            # an update, and the learning rate it took
            lr = (_lr_at(core.param_groups[0]["lr"], count[0]) if core.count > count[0]
                  else None)
            count[0] = core.count
            records.append(dict(step=step, noise=f.normal_recon_on_pure_noise, lr=lr,
                                sbg_moved=any(moved[:n_sbg]), unet_moved=any(moved[n_sbg:]),
                                loss=float(metrics["loss"]),
                                detected=float(metrics.get("recon_face_detected_frac", -1)),
                                align=float(metrics.get("loss_arcface_align_recon", -1)),
                                t=time.perf_counter()))
            before[0] = after
            post(step, f, metrics)

        trainer._post_step = watch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        A.cache_lookups(reset=True)
        G.G_COPIES.clear()
        t0 = time.perf_counter()
        trainer.fit(dataset, num_steps=args.max_steps, start_step=start)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = launch_counts()
        lookups = fit_flash_lookups("finetune", counts)
        copies = fit_gn_backward("finetune", counts)
        peak = torch.cuda.max_memory_allocated()
        for r in records:
            upd = "no update" if r["lr"] is None else f"an update at lr {r['lr']:.3e}"
            log(f"finetune: micro-step {r['step']}: {'pure noise' if r['noise'] else 'images'}, "
                f"loss {r['loss']:.6e}, ArcFace align {r['align']:.4f}, recon faces detected "
                f"{r['detected']:.2f}, {upd}, SubjBasisGenerator moved {r['sbg_moved']}, UNet "
                f"moved {r['unet_moved']}")
        gaps = [b["t"] - a["t"] for a, b in zip(records, records[1:])]
        fit_want = dict(want)
        log(f"finetune: {len(records)} micro-steps in {fit_s:.2f} s (first batch's preparation "
            f"included); between micro-steps {', '.join(f'{g:.3f}' for g in gaps)} s; seconds "
            f"per optimizer step {trainer.cfg.accum_steps * statistics.mean(gaps):.3f} "
            f"({trainer.cfg.accum_steps} x the mean gap); peak memory {peak / 2**30:.2f} GiB")
        log(f"finetune: launches {dict(sorted(counts.items()))}; backward launches the recon "
            f"graphs hold {dict(sorted(fit_want.items()))}")
        accum = trainer.cfg.accum_steps
        window = [i % accum == accum - 1 for i in range(FINETUNE_MICRO_STEPS)]
        moves = [r["lr"] is not None and r["lr"] > 0 for r in records]
        if len(records) != FINETUNE_MICRO_STEPS or not all(math.isfinite(r["loss"])
                                                           for r in records):
            raise AssertionError(f"finetune: micro-steps {records}")
        # an update at each window's end, and the parameters still inside a
        # window and moved at every update whose learning rate is not 0
        if [r["lr"] is not None for r in records] != window or sum(moves) < 2 \
                or [r["sbg_moved"] for r in records] != moves \
                or [r["unet_moved"] for r in records] != moves:
            raise AssertionError(f"finetune: the accumulation of {accum} does not show: {records}")
        if {r["noise"] for r in records} != {False, True} or min(r["detected"] for r in records) < 1:
            raise AssertionError(f"finetune: variants or detections {records}")
        decodes = 2 * FINETUNE_MICRO_STEPS  # two active denoising steps a micro-step
        if {k: counts.get(k, 0) for k in bwd_keys} != {k: want[k] for k in bwd_keys} \
                or any(want[k] != decodes for k in (A.FLASH_BWD_DELTA_WIDE, A.FLASH_BWD_DKDV_WIDE,
                                                    A.FLASH_BWD_DQ_WIDE)) \
                or want[GN_BWD_VAE] != VAE_DECODE_GN * decodes \
                or not all(want[k] for k in (G.GN_BWD_FUSED, G.GN_BWD_REDUCE, G.GN_BWD_DX)):
            raise AssertionError(f"finetune: backward launches {counts}, the graphs hold {want}")

        # the fit's checkpoint reloads equal, the finetuned UNet with it
        ck = trainer.latest_ckpt(args.log_dir)
        state, manifest = load_adaface_ckpt(ck)
        saved = state["subj_basis_generators"]["joint"]
        live = {n: p for n, p in trainer.state.params["sbg"].named_parameters() if n in saved}
        unet_file = load_state_dict(os.path.join(ck, "unet_fp16.safetensors"))
        unet_now = cast_fp16(tree_state_dict(trainer.state.params["unet"]))
        equal = (manifest["step"] == FINETUNE_MICRO_STEPS and set(saved) == set(live)
                 and all(torch.equal(saved[n], live[n].detach().cpu()) for n in saved)
                 and set(unet_file) == set(unet_now)
                 and all(np.array_equal(unet_file[k], unet_now[k]) for k in unet_now))
        log(f"finetune: checkpoint {os.path.basename(ck)} ({len(saved)} SubjBasisGenerator "
            f"tensors, unet_fp16.safetensors {len(unet_file)} tensors, "
            f"{os.path.getsize(os.path.join(ck, 'unet_fp16.safetensors')) / 2**20:.1f} MiB) "
            f"reloads equal: {equal}")
        if not equal:
            raise AssertionError("finetune: the checkpoint does not reload equal")

        # where a micro-step's time goes, and the device's busy share
        splits = [finetune_step_split(trainer, dataset, trainer.planner.plan(s))
                  for s in FINETUNE_SPLIT_STEPS]
        for sp in splits:
            log(f"finetune: micro-step split on {'pure noise' if sp['noise'] else 'images'}: host "
                f"prep {sp['host_prep_ms']:.1f} ms, UNet calls {sp['unet_ms']:.1f} ms, decodes "
                f"{sp['decode_ms']:.1f} ms, ArcFace losses {sp['arcface_ms']:.1f} ms, host "
                f"detection on the recons {sp['detection_ms']:.1f} ms, rest of the forward "
                f"{sp['other_forward_ms']:.1f} ms, backward {sp['backward_ms']:.1f} ms, optimizer "
                f"{sp['optimizer_ms']:.1f} ms ({'an update' if sp['update'] else 'accumulation'})"
                f"; total {sp['total_ms']:.1f} ms (synchronized, no prefetch)")
        from torch.profiler import ProfilerActivity, profile

        fl = trainer.planner.plan(0)
        batch = trainer._prepare_batch([dataset[i] for i in range(trainer.cfg.batch_size)], fl,
                                       trainer.draws_for(fl))
        step_fn = trainer._get_step(fl)
        step = lambda: step_fn(trainer.state, batch, trainer.draws_for(fl, loss=True))  # noqa
        step()
        _, wall_ms = sync_ms(step)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sync_ms(step)
        n_ops, busy_ms = profile_report(prof, "finetune: a recon micro-step on images", 12)
        log(f"finetune: a recon micro-step on images, prepared batch: {wall_ms:.1f} ms on the "
            f"host clock, device busy {busy_ms:.1f} ms in {n_ops} operations under the profiler "
            f"({busy_ms / wall_ms:.1%} of the unprofiled wall)")

        # the adversarial gradient once at full width (the decode in bf16)
        nb = min(trainer.cfg.recon_cfg.adv_bs, batch["x_start"].shape[0])
        px = batch["ref_images"].shape[-1]
        boxes = torch.tensor([[0.2 * px, 0.2 * px, 0.8 * px, 0.8 * px]] * nb, device="cuda")
        before_adv = launch_counts()
        adv, adv_ms = sync_ms(lambda: calc_arcface_adv_grad(
            trainer.frozen["arcface"], trainer.frozen["vae"], batch["x_start"][:nb],
            map_bboxes_to_latent(boxes, px, batch["x_start"].shape[-1]), boxes,
            torch.rand((nb, 512), generator=gen, device="cuda")))
        wide = launch_counts().get(A.FLASH_BWD_DQ_WIDE, 0) - before_adv.get(A.FLASH_BWD_DQ_WIDE, 0)
        log(f"finetune: adversarial ArcFace gradient at {tuple(adv.shape)}: {adv_ms:.1f} ms, "
            f"|max| {adv.abs().max().item():.3e}, finite {bool(torch.isfinite(adv).all())}, D 512 "
            f"dq launches {wide}")
        if not torch.isfinite(adv).all() or not adv.abs().max() > 0 or wide != 1:
            raise AssertionError("finetune: the adversarial gradient")
    return dict(counts=counts, want=fit_want, records=records, fit_s=fit_s, peak=peak,
                grad_rel=grad_rel, splits=splits, busy_ms=busy_ms, wall_ms=wall_ms,
                lookups=lookups, copies=copies)


STAGE2_CONFIG = "configs/stage2-comp-distill.yaml"
# micro-steps of the Stage-2 phase: 4 optimizer updates at the config's
# accumulation of 2; the planner (comp every 4th micro-step, unet-distill every
# 5th of the others) draws comp at 0 (4 priming steps) and 4 (3), unet-distill
# at 6 and recon at the others
STAGE2_MICRO_STEPS = 8
STAGE2_TYPES = ["comp_distill", "recon", "recon", "recon", "comp_distill", "recon",
                "unet_distill", "recon"]
# one comp step's gradients at batch 1 (UNet batch 4: the plain attention's
# fp32 scores at batch 12 would not fit), kernels against plain (bf16 both),
# relative L2 over each part's: a few times what the card reads (PERF.md §6:
# 9.2-9.5e-4, 9.9e-5, 1.8-1.9e-3 on an H100)
STAGE2_GRAD_REL_L2 = {"sbg": 5e-3, "attn_lora": 1e-3, "ffn_lora": 5e-3}
# the backward kernels at Stage 2's new shapes: the UNet's six at batch 12 (the
# comp step's 4 blocks x batch 3), the decoder's D 512 at batch 3 (a step's
# subject-comp decode), the GroupNorm backward at every UNet map at batch 12
# and every decoder map at batch 3
FLASH_BWD_STAGE2 = [(f"{label} batch 12", 12, *dims) for label, _, *dims in FLASH_CASES[:-1]]
FLASH_BWD_STAGE2_VAE = [("vae mid self batch 3", 3, 1, 4096, 4096, 512)]
GN_BWD_STAGE2 = (
    [(f"{label} batch 12", (12, c, hw, hw), eps, silu, torch.bfloat16)
     for label, c, hw, eps, silu, _ in UNET_GN]
    + [(f"vae {label} batch 3", (3, c, hw, hw), 1e-6, silu, torch.bfloat16)
       for label, c, hw, silu, dec, _ in VAE_GN if dec])


def add_adapters(trainer, gen) -> dict:
    """The UNet's attention and FFN adapters at its config's rank (fp32, the
    JAX initialisers' scales) joined to the trainer's trainables, as
    `tests/test_train.py:367-373` adds them; the optimizer restarts over the
    new set."""
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.models.unet import AttnLoRA, FFNLoRA, init_lora_weights_

    cfg = trainer.frozen["unet"].cfg
    lora = {"attn_lora": build(lambda: AttnLoRA(cfg), "cuda", torch.float32,
                               init_lora_weights_, gen),
            "ffn_lora": build(lambda: FFNLoRA(cfg), "cuda", torch.float32, init_lora_weights_,
                              gen)}
    trainer.state = trainer._init_state(dict(trainer.state.params, **lora))
    return lora


def comp_loss_for(trainer, flags):
    """The comp loss function the trainer builds for `flags`."""
    from adaface_tpu_torch.train.comp_step import make_comp_loss_fn

    ccfg = dataclasses.replace(trainer.comp_cfg, num_priming_steps=flags.num_priming_steps)
    return make_comp_loss_fn(ccfg, trainer.host_detector)


def comp_grads(trainer, flags, batch) -> tuple[dict, float]:
    """({part: the gradients of its parameters}, the loss) of one comp step on
    `batch`, its loss's draws from the step's fresh stream."""
    from adaface_tpu_torch.core.device import fp32_convolutions

    params = trainer.state.optimizer.params
    for p in params:
        p.grad = None
    loss, _ = comp_loss_for(trainer, flags)(trainer.state.params, trainer.frozen, batch,
                                            trainer.schedule, trainer.tcfg,
                                            trainer.draws_for(flags, loss=True))
    with fp32_convolutions():  # as `make_train_step` runs the backward
        loss.backward()
    parts = {"sbg": [p for sbg in trainer.state.params["sbg"] for p in sbg.parameters()
                     if p.requires_grad]}
    for key in ("attn_lora", "ffn_lora"):
        parts[key] = list(trainer.state.params[key].parameters())
    names = {key: [n for n, _ in trainer.state.params[key].named_parameters()]
             for key in ("attn_lora", "ffn_lora")}
    out = {key: [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                 for p in ps] for key, ps in parts.items()}
    for p in params:
        p.grad = None
    return dict(out, names=names), loss.item()


def comp_step_split(trainer, dataset, flags) -> dict:
    """One comp micro-step on the host clock, split into host prep (the batch:
    collate, VAE encode, face ID → image prompts, input detection, prompts),
    the text encode, the priming, the denoising steps with gradient, the
    decodes, host detection on the recons, the ArcFace losses, the
    subject-single re-denoise, the GMA flow calls of the elastic matching
    (with `use_face_flow`), the rest of the forward, the backward and the
    optimizer, each timed with the device synchronized around it."""
    from adaface_tpu_torch.core.device import fp32_convolutions
    from adaface_tpu_torch.train import comp_face_align as CF
    from adaface_tpu_torch.train import comp_step as CS
    from adaface_tpu_torch.train.train_step import trainable_parameters

    examples = [dataset[i] for i in range(trainer.cfg.batch_size)]
    batch, prep_ms = sync_ms(lambda: trainer._prepare_batch(examples, flags,
                                                            trainer.draws_for(flags)))
    timer = SyncTimer()
    timer.wrap(CS, "encode_comp_prompts", "text")
    timer.wrap(CS, "prime_comp_x_start", "priming")
    timer.wrap(CS, "comp_distill_denoise", "denoise")
    timer.wrap(CF, "vae_decode", "decode")
    timer.wrap(CF, "detect_faces", "detection")
    timer.wrap(CF, "calc_arcface_align_loss", "arcface")
    timer.wrap(CF, "calc_bg_faces_suppress_loss", "arcface")
    timer.wrap(CF, "ss_redenoise_loop", "redenoise")
    timer.wrap(CS, "make_latent_flow_fn", "flow", made=True)  # the GMA flow's calls
    params = trainable_parameters(trainer.state.params)
    for p in params:
        p.grad = None
    with timer:
        (loss, _), fwd_ms = sync_ms(lambda: comp_loss_for(trainer, flags)(
            trainer.state.params, trainer.frozen, batch, trainer.schedule, trainer.tcfg,
            trainer.draws_for(flags, loss=True)))
    with fp32_convolutions():
        _, bwd_ms = sync_ms(loss.backward)
    update, opt_ms = sync_ms(trainer.state.optimizer.step)
    parts = {k: timer.ms.get(k, 0.0) for k in ("text", "priming", "denoise", "decode",
                                               "detection", "arcface", "redenoise", "flow")}
    return dict(priming_steps=flags.num_priming_steps, host_prep_ms=prep_ms,
                **{f"{k}_ms": v for k, v in parts.items()},
                other_forward_ms=fwd_ms - sum(parts.values()), backward_ms=bwd_ms,
                optimizer_ms=opt_ms, update=update, total_ms=prep_ms + fwd_ms + bwd_ms + opt_ms)


def masked_flash_breakdown(gen) -> dict:
    """The recon path's masked self-attention at 64x64 (S 4096, D 40, 8 heads;
    q, k, v views of one [B, S, 3·H·D] projection, as the UNet lays them out)
    at batches 2 and 4: the plan `flash_plan` gives, and the device time of a
    launch (20 as a CUDA graph) without a mask, with an all-ones mask and
    with a mask that drops a quarter of the keys, each against the plain
    version's output."""
    from adaface_tpu_torch.ops import attention as A

    out = {}
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for b in (2, 4):
        h, s, d = 8, 4096, 40
        qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.split(h * d, dim=-1))
        ones = torch.ones((b, s), device="cuda")
        part = ones.clone()
        part[:, : s // 4] = 0.0  # the top rows of a map, as an augmentation's blank border
        plan = A.flash_plan(q.dtype, b, h, s, s, d, sm)
        row = {"plan": dataclasses.asdict(plan) if dataclasses.is_dataclass(plan) else str(plan)}
        for name, mask in (("unmasked", None), ("all-ones mask", ones),
                           ("quarter masked", part)):
            got = A._flash_cuda(q, k, v, mask, False, d ** -0.5)
            ref = A.scaled_dot_product_attention(q, k, v, kv_mask=mask, scale=d ** -0.5)
            err, mag = max_err(got, ref)
            row[name] = {"graph_ms": graph_ms(lambda: A._flash_cuda(q, k, v, mask, False,
                                                                   d ** -0.5)), "err": err}
            if err > BF16_TOL * mag:
                raise AssertionError(f"masked flash B{b} {name}: {err} against {mag}")
        log(f"masked flash forward B{b} H{h} S{s} D{d}: plan {row['plan']}; device ms a launch "
            + ", ".join(f"{k} {v['graph_ms']:.4f}" for k, v in row.items() if k != "plan"))
        out[b] = row
    return out


def recon_flash_profile(trainer, dataset, flags) -> dict:
    """One recon micro-step on images (the attn-LoRA gate off), profiled with
    each flash forward launch recorded in order (batch, query and key length,
    head dim, masked), so the kernel events, in the same order on the one
    stream, are summed by shape and mask."""
    from torch.profiler import ProfilerActivity, profile

    from adaface_tpu_torch.ops import attention as A

    batch = trainer._prepare_batch([dataset[i] for i in range(trainer.cfg.batch_size)], flags,
                                   trainer.draws_for(flags))
    step_fn = trainer._get_step(flags)
    step_fn(trainer.state, batch, trainer.draws_for(flags, loss=True))  # warm the plans
    seen, real = [], A._flash_cuda

    def recorded(q, k, v, kv_mask, causal, scale, **kw):
        seen.append((q.shape[0], q.shape[2], k.shape[2], q.shape[3], kv_mask is not None))
        return real(q, k, v, kv_mask, causal, scale, **kw)

    torch.cuda.synchronize()
    with mock.patch.object(A, "_flash_cuda", recorded), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_fn(trainer.state, batch, trainer.draws_for(flags, loss=True))
        torch.cuda.synchronize()
    events = [e for e in device_events(prof) if re.search(r"flash_fwd_(wg_|wide_)?kernel", e.name)]
    events.sort(key=lambda e: e.start)
    if len(events) != len(seen):
        raise AssertionError(f"recon profile: {len(seen)} flash launches, {len(events)} events")
    groups: dict = {}
    for shape, e in zip(seen, events):
        n, us = groups.get(shape, (0, 0.0))
        groups[shape] = (n + 1, us + e.us)
    for (b, sq, sk, d, masked), (n, us) in sorted(groups.items()):
        log(f"recon flash forward B{b} Sq{sq} Sk{sk} D{d} {'masked' if masked else 'unmasked'}: "
            f"{n} launches, {us / 1e3:.3f} ms, {us / 1e3 / n:.4f} ms a launch")
    return {f"B{b} Sq{sq} Sk{sk} D{d} {'masked' if m else 'unmasked'}": (n, us / 1e3)
            for (b, sq, sk, d, m), (n, us) in groups.items()}


def train_stage2(gen) -> dict:
    """Stage-2 compositional distillation on the card at full SD1.5 width,
    through `train_torch.build_trainer` and `Trainer.fit` with STAGE2_CONFIG
    (comp-distill every 4th micro-step, unet-distill and recon between; the
    joint encoder's two SubjBasisGenerators, CLIP-L text and a random ArcFace
    in fp32; the SD1.5 UNet and the VAE in bf16, the losses computing in
    bf16; prodigy, grad clip 0.2, batch 3, accumulation 2) on synthetic
    512x512 PNGs with a detector of one central face injected, plus the
    UNet's attention and FFN adapters at rank 192 as trainables. First the
    backward kernels at this slice's new shapes (FLASH_BWD_STAGE2, GN_BWD_STAGE2)
    against their plain versions; then one comp step's gradients, kernels
    against plain, at batch 1, with the adapters' unused parts exactly 0;
    STAGE2_MICRO_STEPS micro-steps (two comp iterations at 4 and 3 priming
    steps, recon, unet-distill) with finite losses and the parameters moved
    at each update whose learning rate is not 0; the backward launches as the
    autograd graphs hold them, per micro-step; the fit's checkpoint with
    `unet_lora_modules` reloads equal; a comp micro-step's split and busy
    share, the peak memory and seconds per optimizer step."""
    import tempfile

    import train_torch
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import fused_gn as G
    from adaface_tpu_torch.train import trainer as T
    from adaface_tpu_torch.train.checkpoint import load_adaface_ckpt
    from adaface_tpu_torch.train.comp_step import sample_comp_rand
    from adaface_tpu_torch.train.face_detect import HostFaceDetector
    from adaface_tpu_torch.train.optimizers import _lr_at
    from adaface_tpu_torch.train.train_step import trainable_state_dicts

    flash_bwd = check_flash_bwd(gen, FLASH_BWD_STAGE2 + FLASH_BWD_STAGE2_VAE, masked=False)
    gn_bwd = check_gn_bwd(gen, GN_BWD_STAGE2)
    masked = masked_flash_breakdown(gen)
    torch.cuda.empty_cache()
    bwd_keys = (A.FLASH_BWD_DELTA, A.FLASH_BWD_DKDV_WG, A.FLASH_BWD_DQ_WG,
                A.FLASH_BWD_DELTA_WIDE, A.FLASH_BWD_DKDV_WIDE, A.FLASH_BWD_DQ_WIDE,
                G.GN_BWD_FUSED, G.GN_BWD_REDUCE, G.GN_BWD_DX)
    repo = str(pathlib.Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=repo) as tmp:
        data = write_train_photos(os.path.join(tmp, "photos"))
        cfg, args = train_torch.parse_args([
            f"trainer.ckpt_every={STAGE2_MICRO_STEPS}", "--base",
            os.path.join(repo, STAGE2_CONFIG), "--data_roots", data, "--log_dir",
            os.path.join(tmp, "logs"), "--max_steps", str(STAGE2_MICRO_STEPS)])
        t0 = time.perf_counter()
        trainer, dataset, start = train_torch.build_trainer(cfg, args)
        lora = add_adapters(trainer, gen)
        torch.cuda.synchronize()
        n_lora = sum(p.numel() for m in lora.values() for p in m.parameters())
        log(f"stage2: the stack at full width on the card in {time.perf_counter() - t0:.1f} s; "
            f"{len(trainer.state.optimizer.params)} trainable tensors, "
            f"{sum(p.numel() for p in trainer.state.optimizer.params)} parameters (the adapters "
            f"{n_lora} at rank {trainer.frozen['unet'].cfg.lora_rank}; {len(trainer.state.params['sbg'])} "
            f"SubjBasisGenerators); UNet {next(trainer.frozen['unet'].parameters()).dtype}, "
            f"compute {trainer.comp_cfg.compute_dtype}; optimizer {trainer.cfg.optimizer}, "
            f"accumulation {trainer.cfg.accum_steps}, batch {trainer.cfg.batch_size}, prefetch "
            f"{trainer.cfg.prefetch}; comp {trainer.comp_cfg.num_denoising_steps} denoising "
            f"steps, attn_norm_weight {trainer.comp_cfg.attn_norm_weight}, rep_distill_weight "
            f"{trainer.comp_cfg.rep_distill_weight}")
        trainer.host_detector = HostFaceDetector(detector_fn=central_face)
        if "arcface" not in trainer.frozen or "vae" not in trainer.frozen:
            raise AssertionError("stage2: the identity towers are not wired")

        # one comp step's gradients at batch 1, kernels against plain
        flags = trainer.planner.plan(0)
        trainer.planner = type(trainer.planner)(**{
            f.name: getattr(trainer.planner, f.name)
            for f in dataclasses.fields(trainer.planner)})  # the fit plans from step 0 again
        one = trainer._prepare_batch([dataset[0]], flags, trainer.draws_for(flags))
        kernel_grads, kernel_loss = comp_grads(trainer, flags, one)
        with plain_versions():
            plain_grads, plain_loss = comp_grads(trainer, flags, one)
        grad_rel = {k: rel_l2_lists(kernel_grads[k], plain_grads[k])
                    for k in ("sbg", "attn_lora", "ffn_lora")}
        finite = all(torch.isfinite(g).all() for k in grad_rel for g in kernel_grads[k])
        gates = sample_comp_rand(trainer.draws_for(flags, loss=True), one["noise"],
                                 trainer.schedule, trainer.comp_cfg)["den_ffn_gates"]
        zero = {}
        for key in ("attn_lora", "ffn_lora"):
            for n, g in zip(kernel_grads["names"][key], kernel_grads[key]):
                zero[f"{key}.{n}"] = not g.any().item()
        # never run in a comp step: the k / v adapters, the other FFN names
        unused = {n for n in zero if ".k." in n or ".v." in n or n.startswith(
            ("ffn_lora.recon_loss.", "ffn_lora.unet_distill."))}
        # run, with a gradient: the out adapters and the normalization's scale
        # factors, and the comp FFN adapter where a step drew it; A has none
        # while B is 0 (dL/dA = s·Bᵀ·dL/dW), q's only where the elastic
        # matching's attention candidate is a token's minimum (q2 feeds nothing
        # else), so neither is held here
        used = {n for n in zero if n not in unused and not n.endswith("lora_a")
                and ".q." not in n and not (n.startswith("ffn_lora.comp_distill.")
                                            and not gates.any())}
        q_nonzero = sum(not zero[n] for n in zero if ".q." in n)
        log(f"stage2: one comp step at batch 1 (UNet batch 4), kernels against plain: loss "
            f"{kernel_loss:.6e} / {plain_loss:.6e}; gradients relative L2 "
            + ", ".join(f"{k} {v:.3e}" for k, v in grad_rel.items())
            + f" (limits {STAGE2_GRAD_REL_L2}); comp FFN gates {gates.tolist()}; exactly 0: "
            f"{sum(zero[n] for n in unused)} of {len(unused)} unused adapter tensors (k, v, "
            f"the recon_loss and unet_distill FFN adapters), {sum(zero[n] for n in used)} of "
            f"{len(used)} used ones, {q_nonzero} of 9 q adapter tensors non-zero; "
            f"SubjBasisGenerators' gradient norm "
            f"{math.sqrt(sum((g.float() ** 2).sum().item() for g in kernel_grads['sbg'])):.3e}")
        if not finite or not math.isfinite(kernel_loss) or any(
                v > STAGE2_GRAD_REL_L2[k] for k, v in grad_rel.items()):
            raise AssertionError(f"stage2: gradients kernels against plain {grad_rel}, finite "
                                 f"{finite}")
        if not all(zero[n] for n in unused) or any(zero[n] for n in used) \
                or not any(g.any() for g in kernel_grads["sbg"]):
            raise AssertionError(f"stage2: the gradients' zeros {zero}")
        del one, kernel_grads, plain_grads
        torch.cuda.empty_cache()

        # the fit: each micro-step's backward launches as its graph holds them,
        # the parameters after each micro-step
        per_step = []
        real_make = T.make_train_step

        def make_with_census(loss_fn, *a, **kw):
            def loss_and_census(*args):
                loss, metrics = loss_fn(*args)
                c = collections.Counter()
                backward_census(loss, c)
                per_step.append(c)
                return loss, metrics
            return real_make(loss_and_census, *a, **kw)

        n_sbg = sum(1 for sbg in trainer.state.params["sbg"] for p in sbg.parameters()
                    if p.requires_grad)
        post, records = trainer._post_step, []
        before = [param_sums(trainer)]
        core = trainer.state.optimizer.optimizer
        count = [core.count]

        def watch(step, f, metrics):
            after = param_sums(trainer)
            moved = [a != b for a, b in zip(before[0], after)]
            lr = (_lr_at(core.param_groups[0]["lr"], count[0]) if core.count > count[0]
                  else None)
            count[0] = core.count
            records.append(dict(step=step, type=f.iter_type, priming=f.num_priming_steps,
                                lr=lr, sbg_moved=any(moved[:n_sbg]),
                                lora_moved=any(moved[n_sbg:]), loss=float(metrics["loss"]),
                                metrics={k: float(v) for k, v in metrics.items()},
                                t=time.perf_counter()))
            before[0] = after
            post(step, f, metrics)

        trainer._post_step = watch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        A.cache_lookups(reset=True)
        G.G_COPIES.clear()
        t0 = time.perf_counter()
        with mock.patch.object(T, "make_train_step", make_with_census):
            trainer.fit(dataset, num_steps=args.max_steps, start_step=start)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = launch_counts()
        lookups = fit_flash_lookups("stage2", counts)
        copies = fit_gn_backward("stage2", counts)
        peak = torch.cuda.max_memory_allocated()
        want = collections.Counter()
        for c in per_step:
            want.update(c)
        for r, c in zip(records, per_step):
            m = r["metrics"]
            upd = "no update" if r["lr"] is None else f"an update (group lr {r['lr']:.3e})"
            extra = (f"priming {r['priming']}, fg_bg {m['loss_comp_fg_bg_preserve']:.4e}, rep "
                     f"{m['loss_rep_distill']:.4e}, ArcFace align "
                     f"{m.get('loss_arcface_align_comp', -1):.4f}, sc face "
                     f"{m.get('comp_sc_face_detected', -1):.0f}, redenoise ok "
                     f"{m.get('comp_ss_redenoise_success_frac', -1):.2f}, "
                     if r["type"] == "comp_distill" else "")
            log(f"stage2: micro-step {r['step']}: {r['type']}, {extra}loss {r['loss']:.6e}, "
                f"{upd}, SubjBasisGenerators moved {r['sbg_moved']}, adapters moved "
                f"{r['lora_moved']}; backward launches {dict(sorted(c.items()))}")
        gaps = [b["t"] - a["t"] for a, b in zip(records, records[1:])]
        fit_want = dict(want)
        accum = trainer.cfg.accum_steps
        log(f"stage2: {len(records)} micro-steps in {fit_s:.2f} s (first batch's preparation "
            f"included); between micro-steps {', '.join(f'{g:.3f}' for g in gaps)} s; seconds "
            f"per optimizer step {accum * statistics.mean(gaps):.3f} ({accum} x the mean gap); "
            f"peak memory {peak / 2**30:.2f} GiB")
        log(f"stage2: launches {dict(sorted(counts.items()))}; backward launches the graphs "
            f"hold {dict(sorted(fit_want.items()))}")
        window = [i % accum == accum - 1 for i in range(STAGE2_MICRO_STEPS)]
        moves = [r["lr"] is not None and r["lr"] > 0 for r in records]
        if [r["type"] for r in records] != STAGE2_TYPES \
                or [r["priming"] for r, t in zip(records, STAGE2_TYPES)
                    if t == "comp_distill"] != [4, 3] \
                or not all(math.isfinite(r["loss"]) for r in records):
            raise AssertionError(f"stage2: micro-steps {records}")
        if [r["lr"] is not None for r in records] != window or sum(moves) < 1 \
                or [r["sbg_moved"] for r in records] != moves \
                or [r["lora_moved"] for r in records] != moves:
            raise AssertionError(f"stage2: the accumulation of {accum} does not show: {records}")
        if {k: counts.get(k, 0) for k in bwd_keys} != {k: want[k] for k in bwd_keys} \
                or not all(want[k] for k in bwd_keys):
            raise AssertionError(f"stage2: backward launches {counts}, the graphs hold {want}")

        # the fit's checkpoint reloads equal, the adapters with it
        ck = trainer.latest_ckpt(args.log_dir)
        state, manifest = load_adaface_ckpt(ck)
        saved_sbg = state["subj_basis_generators"]["joint"]
        saved_lora = state.get("unet_lora_modules") or {}
        live_sbg = trainable_state_dicts(trainer.state.params)
        live_lora = {k: trainer.state.params[k].state_dict() for k in ("attn_lora", "ffn_lora")}

        def equal_now():
            return (set(saved_lora) == set(live_lora)
                    and all(torch.equal(saved_lora[k][n], t.detach().cpu())
                            for k, sd in live_lora.items() for n, t in sd.items())
                    and all(torch.equal(s_[n], t.detach().cpu())
                            for s_, sd in zip(saved_sbg, live_sbg) for n, t in sd.items()))

        equal = manifest["step"] == STAGE2_MICRO_STEPS and equal_now()
        for m in lora.values():  # move the adapters, then load them back
            with torch.no_grad():
                for p in m.parameters():
                    p.add_(1.0)
        trainer.load(ck)
        live_lora = {k: trainer.state.params[k].state_dict() for k in ("attn_lora", "ffn_lora")}
        equal = equal and equal_now()
        log(f"stage2: checkpoint {os.path.basename(ck)} ({sum(len(d) for d in saved_sbg)} "
            f"SubjBasisGenerator tensors, unet_lora_modules "
            f"{ {k: len(v) for k, v in saved_lora.items()} }) reloads equal: {equal}")
        if not equal:
            raise AssertionError("stage2: the checkpoint does not reload equal")

        # where a comp micro-step's time goes, and the device's busy share
        splits = [comp_step_split(trainer, dataset, trainer.planner.plan(STAGE2_MICRO_STEPS))]
        for sp in splits:
            log(f"stage2: comp micro-step split ({sp['priming_steps']} priming steps), ms: host "
                f"prep {sp['host_prep_ms']:.1f}, text encode {sp['text_ms']:.1f}, priming "
                f"{sp['priming_ms']:.1f}, denoising steps with gradient {sp['denoise_ms']:.1f}, "
                f"decodes {sp['decode_ms']:.1f}, host detection {sp['detection_ms']:.1f}, "
                f"ArcFace losses {sp['arcface_ms']:.1f}, subject-single re-denoise "
                f"{sp['redenoise_ms']:.1f}, rest of the forward {sp['other_forward_ms']:.1f}, "
                f"backward {sp['backward_ms']:.1f}, optimizer {sp['optimizer_ms']:.1f} "
                f"({'an update' if sp['update'] else 'accumulation'}); total "
                f"{sp['total_ms']:.1f} (synchronized, no prefetch)")
        from torch.profiler import ProfilerActivity, profile

        fl = trainer.planner.plan(STAGE2_MICRO_STEPS + 1)
        fl = trainer.planner.plan(STAGE2_MICRO_STEPS + 4) if fl.iter_type != "comp_distill" \
            else fl
        batch = trainer._prepare_batch([dataset[i] for i in range(trainer.cfg.batch_size)], fl,
                                       trainer.draws_for(fl))
        step_fn = trainer._get_step(fl)
        step = lambda: step_fn(trainer.state, batch, trainer.draws_for(fl, loss=True))  # noqa
        step()
        _, wall_ms = sync_ms(step)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sync_ms(step)
        n_ops, busy_ms = profile_report(prof, "stage2: a comp micro-step", 15)
        log(f"stage2: a comp micro-step ({fl.num_priming_steps} priming steps), prepared batch: "
            f"{wall_ms:.1f} ms on the host clock, device busy {busy_ms:.1f} ms in {n_ops} "
            f"operations under the profiler ({busy_ms / wall_ms:.1%} of the unprofiled wall)")
        recon = next(f for f in (trainer.planner.plan(STAGE2_MICRO_STEPS + 5 + i)
                                 for i in range(8)) if f.iter_type == "recon")
        recon = dataclasses.replace(recon, normal_recon_on_pure_noise=False, do_adv_attack=False,
                                    recon_enable_attn_lora=False)
        recon_flash = recon_flash_profile(trainer, dataset, recon)
    return dict(counts=counts, want=fit_want, per_step=per_step, records=records, fit_s=fit_s,
                peak=peak, grad_rel=grad_rel, splits=splits, busy_ms=busy_ms, wall_ms=wall_ms,
                flash_bwd=flash_bwd, gn_bwd=gn_bwd, masked=masked, recon_flash=recon_flash,
                copies=copies)


# the Stage-2 recipes' phase: comp at 0 (4 priming steps), then recon at 1-3;
# two optimizer updates at the config's accumulation of 2: the first at the
# warmup's learning rate 0 (the parameters stay), the second at 1/1000 of it
RECIPES_MICRO_STEPS = 4
RECIPES_TYPES = ["comp_distill", "recon", "recon", "recon"]
FLOW_CARD_CPU_REL_L2 = 1e-4  # the latent flow, card against CPU, both fp32 without TF32
OPT_CARD_CPU_REL_L2 = 1e-5  # each optimized tensor after 3 updates, card against CPU
MKV_CARD_CPU_REL_L2 = 1e-5  # the MKV request's ada embeddings, card against CPU
RECIPE_OPTIMIZERS = ("adamw", "nadam", "muon", "adam8bit", "cautious_adamw")
RECIPE_OPT_MICRO_STEPS = 6  # 3 updates at accumulation 2


@contextmanager
def allow_tf32():
    """cuDNN convolutions and cuBLAS fp32 products with TF32 inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def unet_checksum(unet) -> float:
    """The fp32 sum of every UNet weight's fp32 sum, on the card: equal for
    equal weights, read back once."""
    return torch.stack([v.float().sum() for v in unet.state_dict().values()]).sum().item()


def flow_card_against_cpu(gma, captured: dict, card: str) -> dict:
    """The latent flow (`make_latent_flow_fn`) on one comp step's captured
    elastic-matching inputs of layer 22 (the demeaned q2 of the face crops,
    B 3, C 320, 64x64), on the card and on a CPU copy of the GMA, both fp32
    without TF32: relative L2, the largest difference, and the tokens whose
    pick between the flow-warped and the same-location candidate changes
    (the loss's per-token min, at the ssfg margin 1.02); the card's ms a call
    without and with TF32 (CUDA events, median of 3, the host's issue
    inside) and each one's device time and operations (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from adaface_tpu_torch.models import gma as GM

    tgt, src, h, w = captured["tgt"], captured["src"], captured["h"], captured["w"]
    fn = GM.make_latent_flow_fn(gma)
    tgt_c, src_c = tgt.cuda(), src.cuda()

    def with_tf32():  # the same flow with PyTorch's TF32 let in
        with allow_tf32():
            return GM.smooth_flow(GM.est_flow_from_feats(gma, tgt_c, src_c, h, w))

    def profiled(call) -> tuple[int, float]:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = [e for e in device_events(prof) if e.name != "Memset (Device)"]
        return len(events), sum(e.us for e in events) / 1e3

    with torch.no_grad():
        on_card = fn(tgt_c, src_c, h, w).cpu()
        cpu = GM.make_latent_flow_fn(on_cpu(gma))(tgt, src, h, w)

        def pick(flow):
            b, c, n = src.shape
            warped = GM.backward_warp_by_flow(src.reshape(b, c, h, w), flow).reshape(b, c, n)
            return ((warped - tgt) ** 2).mean(1) * 1.02 < ((src - tgt) ** 2).mean(1)

        picks_differ = int((pick(on_card) != pick(cpu)).sum())
        rel = rel_l2_of(on_card, cpu)
        calls = {"fp32": lambda: fn(tgt_c, src_c, h, w), "tf32": with_tf32}
        times = {k: median_ms(c, reps=3, warmup=1) for k, c in calls.items()}
        device = {k: profiled(c) for k, c in calls.items()}
        tf32_flow = with_tf32().cpu()
    out = dict(rel_l2=rel, max_abs=(on_card - cpu).abs().max().item(),
               picks_differ=picks_differ, tokens=tgt.shape[0] * tgt.shape[2], ms=times["fp32"],
               tf32_ms=times["tf32"], tf32_rel_l2=rel_l2_of(tf32_flow, cpu),
               launches=device["fp32"][0], device_ms=device["fp32"][1],
               tf32_device_ms=device["tf32"][1], flow_abs_max=cpu.abs().max().item())
    log(f"recipes: the latent flow at B{tgt.shape[0]} C{tgt.shape[1]} {h}x{w}, 12 iterations, "
        f"card ({card}) against CPU (fp32, TF32 off): relative L2 {rel:.3e} (limit "
        f"{FLOW_CARD_CPU_REL_L2:g}), max |diff| {out['max_abs']:.3e} of max |flow| "
        f"{out['flow_abs_max']:.3e}; flow-vs-same-location picks that differ: {picks_differ} "
        f"of {out['tokens']} tokens; a call {times['fp32']:.2f} ms (CUDA events, host "
        f"included), {out['device_ms']:.2f} ms of device time in {out['launches']} device "
        f"operations (torch.profiler); with TF32 {times['tf32']:.2f} ms, "
        f"{out['tf32_device_ms']:.2f} ms of device time in {device['tf32'][0]} operations, its "
        f"flow {out['tf32_rel_l2']:.3e} from the CPU's")
    if not math.isfinite(rel) or rel > FLOW_CARD_CPU_REL_L2:
        raise AssertionError(f"recipes: the flow card against CPU {rel}")
    return out


def optimizers_card_against_cpu(sbg, card: str) -> dict:
    """RECIPE_OPTIMIZERS (`cautious_adamw`: `Cautious` around optax's AdamW)
    behind the clip at 0.2 and accumulation 2, RECIPE_OPT_MICRO_STEPS
    micro-steps (3 updates) on copies of the fit's first SubjBasisGenerator's
    last prompt2token_proj layer (its MKV K and V [1536, 768]) and its layer
    weights, on the card and on the CPU with the same seeded gradients, TF32
    off: each tensor's relative L2 after the updates, and the card's ms an
    update."""
    from adaface_tpu_torch.core.device import fp32_convolutions
    from adaface_tpu_torch.train import optimizers as O

    last = len(sbg.clip.layers) - 1
    layouts = O.jax_layouts(sbg)
    chosen = [(n, p) for n, p in sbg.named_parameters()
              if n.startswith(f"clip.layers.{last}.") or n == "hidden_state_layer_weights"]
    rs = torch.Generator().manual_seed(SEED + 11)
    grads = [[torch.randn(p.shape, generator=rs) * (0.01 if i % 2 else 1.0) for _, p in chosen]
             for i in range(RECIPE_OPT_MICRO_STEPS)]
    out = {}
    for name in RECIPE_OPTIMIZERS:
        finals, update_ms = {}, []
        for device in ("cuda", "cpu"):
            ps = [torch.nn.Parameter(p.detach().to(device).clone()) for _, p in chosen]
            lay = {q: layouts[p] for q, (_, p) in zip(ps, chosen) if p in layouts}
            common = dict(warmup_steps=1, total_steps=10, grad_clip=0.2)
            if name == "cautious_adamw":
                sched = O.warmup_cosine(1e-3, 1, 10)
                opt = O.MultiSteps(O.Cautious(O.AdamW(ps, sched, weight_decay=0.005)), 0.2, 2)
            else:
                opt = O.make_optimizer(name, ps, 1e-3, accum_steps=2, layouts=lay, **common)
            with fp32_convolutions(matmuls=True):
                for g in grads:
                    for q, gi in zip(ps, g):
                        q.grad = gi.to(device, copy=True)
                    if device == "cuda":
                        moved, ms = sync_ms(opt.step)
                        if moved:
                            update_ms.append(ms)
                    else:
                        opt.step()
            finals[device] = [q.detach().cpu() for q in ps]
        rels = [rel_l2_of(a, b) for a, b in zip(finals["cuda"], finals["cpu"])]
        moved = all(not torch.equal(a, p.detach().cpu())
                    for a, (_, p) in zip(finals["cuda"], chosen))
        out[name] = dict(rel_l2=max(rels), update_ms=update_ms, moved=moved)
        log(f"recipes: optimizer {name} ({card}), {len(chosen)} tensors "
            f"({sum(p.numel() for _, p in chosen)} parameters), 3 updates at accumulation 2, "
            f"card against CPU: largest relative L2 {max(rels):.3e} (limit "
            f"{OPT_CARD_CPU_REL_L2:g}); the card's updates "
            + ", ".join(f"{m:.2f}" for m in update_ms) + " ms; moved " + str(moved))
        if max(rels) > OPT_CARD_CPU_REL_L2 or not moved:
            raise AssertionError(f"recipes: optimizer {name} card against CPU {rels}")
    return out


def serve_mkv(ckpt: str, gen, card: str) -> dict:
    """The MKV checkpoint served: a random SD1.5 server (`build_server`) makes
    one 512x512, 25-step request with its own SubjBasisGenerator, then
    `AdaFaceWrapper.load_adaface_ckpt` loads the fit's checkpoint (the joint
    list's Arc2Face generator, K and V at 2x) and the same request runs
    again: its ada embeddings against a CPU copy of the encoder (fp32), a
    finite image, and the kernel launches equal to the unextended request's."""
    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt
    from adaface_tpu_torch.models.clip import layer_multipliers
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.text.tokenizer import default_tokenizer

    wrapper, _ = build_server(gen)
    enc = wrapper.id2ada_prompt_encoder
    fid = torch.randn((1, 512), generator=gen, device="cuda")
    prompt = REQUESTS[0][1]
    runs = {}
    for label in ("unextended", "mkv"):
        if label == "mkv":
            wrapper.load_adaface_ckpt(ckpt)
        ada = wrapper.prepare_adaface_embeddings(face_id_embs=fid)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        img = wrapper(prompt, generator=torch.Generator("cuda").manual_seed(5))
        torch.cuda.synchronize()
        runs[label] = dict(ada=ada.detach().float().cpu(), img=img, counts=launch_counts(),
                           ms=(time.perf_counter() - t0) * 1e3)
        check_images(list(img), 1, 512, f"recipes: the {label} request")
    mults = layer_multipliers(enc.subj_basis_generator.clip)
    cpu_enc = Arc2FaceID2AdaPrompt(on_cpu(enc.text_encoder), on_cpu(enc.subj_basis_generator),
                                   default_tokenizer(),
                                   out_id_embs_cfg_scale=enc.out_id_embs_cfg_scale)
    with torch.inference_mode():
        ada_cpu, _, _ = cpu_enc.generate_adaface_embeddings(face_id_embs=fid.cpu())
    rel = rel_l2_of(runs["mkv"]["ada"], ada_cpu)
    moved = rel_l2_of(runs["mkv"]["ada"], runs["unextended"]["ada"])
    same = runs["mkv"]["counts"] == runs["unextended"]["counts"]
    log(f"recipes: serve_mkv ({card}): prompt2token_proj multipliers {mults}; ada embeddings "
        f"card against CPU {rel:.3e} (limit {MKV_CARD_CPU_REL_L2:g}), {moved:.3e} from the "
        f"unextended generator's; request {runs['unextended']['ms']:.1f} ms unextended, "
        f"{runs['mkv']['ms']:.1f} ms MKV; launches equal: {same} {runs['mkv']['counts']}")
    if mults != [2] * len(mults) or rel > MKV_CARD_CPU_REL_L2 or not same or moved == 0:
        raise AssertionError(f"recipes: serve_mkv {mults} {rel} {same} {moved}")
    return dict(counts=runs["mkv"]["counts"], rel_l2=rel, ms=runs["mkv"]["ms"])


def train_stage2_recipes(gen, card: str) -> dict:
    """The Stage-2 recipes at full SD1.5 width. An unextended checkpoint of the
    joint encoder's two SubjBasisGenerators is written (`save_adaface_ckpt`);
    `train_torch.build_trainer` takes STAGE2_CONFIG with `--adaface_ckpt_path`
    it, `--extend_mkv_multiplier 2`, `comp_distill.use_face_flow=true` (a
    random GMA), `trainer.optimizer=adam8bit`; the comp iterations' UNet from a
    second seeded draw goes in by `Trainer.set_comp_unet` (the weights on the
    host; the central-face detector injected). RECIPES_MICRO_STEPS micro-steps
    (comp at 0, then recon) with finite losses, the parameters moved at the
    update whose learning rate is not 0 and none at the warmup's first, the
    UNet holding the comp weights inside the comp step and the base ones
    after it (checksums), the backward launches as the graphs hold them, the
    peak memory; a comp micro-step's split with the flow on its own line, and
    the device's busy share of a comp micro-step with and without the flow.
    Then the flow card against CPU on the fit's captured inputs, the
    optimizers card against CPU, and `serve_mkv` on the fit's checkpoint."""
    import tempfile

    import train_torch
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.id2ada.subj_basis_generator import (SubjBasisConfig,
                                                              SubjBasisGenerator,
                                                              init_sbg_weights_)
    from adaface_tpu_torch.models.clip import layer_multipliers
    from adaface_tpu_torch.models.unet import UNet2DConditionModel, init_unet_weights_
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import fused_gn as G
    from adaface_tpu_torch.text.tokenizer import default_tokenizer
    from adaface_tpu_torch.train import comp_step as CS
    from adaface_tpu_torch.train import trainer as T
    from adaface_tpu_torch.train.checkpoint import save_adaface_ckpt
    from adaface_tpu_torch.train.face_detect import HostFaceDetector
    from adaface_tpu_torch.train.optimizers import Adam8bit, _lr_at

    bwd_keys = (A.FLASH_BWD_DELTA, A.FLASH_BWD_DKDV_WG, A.FLASH_BWD_DQ_WG,
                A.FLASH_BWD_DELTA_WIDE, A.FLASH_BWD_DKDV_WIDE, A.FLASH_BWD_DQ_WIDE,
                G.GN_BWD_FUSED, G.GN_BWD_REDUCE, G.GN_BWD_DX)
    repo = str(pathlib.Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(prefix=".recipes_smoke_", dir=repo) as tmp:
        data = write_train_photos(os.path.join(tmp, "photos"))
        tok = default_tokenizer()
        sbgs = [build(lambda c=c: SubjBasisGenerator(c, tok), "cuda", torch.float32,
                      init_sbg_weights_, gen)
                for c in (SubjBasisConfig(), SubjBasisConfig(num_id_vecs=4))]
        ck0 = save_adaface_ckpt(os.path.join(tmp, "unextended"), 0, {"joint": [
            {n: p for n, p in s.named_parameters() if not n.startswith(
                ("clip.token_embedding", "clip.position_embedding"))} for s in sbgs]})
        del sbgs
        t0 = time.perf_counter()
        cfg, args = train_torch.parse_args([
            "comp_distill.use_face_flow=true", "trainer.optimizer=adam8bit", "--base",
            os.path.join(repo, STAGE2_CONFIG), "--data_roots", data, "--log_dir",
            os.path.join(tmp, "logs"), "--max_steps", str(RECIPES_MICRO_STEPS),
            "--adaface_ckpt_path", ck0, "--extend_mkv_multiplier", "2"])
        trainer, dataset, start = train_torch.build_trainer(cfg, args)
        trainer.host_detector = HostFaceDetector(detector_fn=central_face)
        unet = trainer.frozen["unet"]
        comp = build(lambda: UNet2DConditionModel(unet.cfg), "cuda",
                     next(unet.parameters()).dtype, init_unet_weights_, gen)
        comp_ck = unet_checksum(comp)
        trainer.set_comp_unet(T._host_copy(comp.state_dict()))
        del comp
        torch.cuda.empty_cache()
        base_ck = unet_checksum(unet)
        core = trainer.state.optimizer.optimizer
        mults = [layer_multipliers(s.clip) for s in trainer.state.params["sbg"]]
        log(f"recipes ({card}): the stack at full width in {time.perf_counter() - t0:.1f} s: "
            f"use_face_flow {trainer.comp_cfg.use_face_flow} (a random GMA, "
            f"{sum(p.numel() for p in trainer.frozen['flow'].parameters())} parameters), "
            f"optimizer {type(core).__name__}, prompt2token_proj multipliers {mults}, "
            f"{sum(p.numel() for p in trainer.state.optimizer.params)} trainable parameters; "
            f"UNet checksums base {base_ck:.6e}, comp {comp_ck:.6e}")
        if not isinstance(core, Adam8bit) or mults != [[2] * 12] * 2 or comp_ck == base_ck:
            raise AssertionError(f"recipes: the stack {type(core)} {mults}")

        # the fit: the census of each micro-step's backward, the UNet's checksum
        # inside each step, the flow calls' inputs (the first) and count
        per_step, seen_ck, records, captured, n_flow = [], [], [], {}, [0]
        real_make, real_get = T.make_train_step, trainer._get_step
        real_flow = CS.make_latent_flow_fn

        def make_with_census(loss_fn, *a, **kw):
            def loss_and_census(*args):
                loss, metrics = loss_fn(*args)
                c = collections.Counter()
                backward_census(loss, c)
                per_step.append(c)
                return loss, metrics
            return real_make(loss_and_census, *a, **kw)

        def get_step(flags):
            step = real_get(flags)

            def checked(*a, **kw):
                seen_ck.append((flags.iter_type, unet_checksum(unet)))
                return step(*a, **kw)
            return checked

        def recording_flow(*a, **kw):
            fn = real_flow(*a, **kw)

            def rec(tgt, src, h, w, thres=0.0):
                n_flow[0] += 1
                if not captured:
                    captured.update(tgt=tgt.detach().float().cpu(),
                                    src=src.detach().float().cpu(), h=h, w=w)
                return fn(tgt, src, h, w, thres)
            return rec

        before = [param_sums(trainer)]
        post = trainer._post_step
        count = [core.count]

        def watch(step, f, metrics):
            after = param_sums(trainer)
            lr = _lr_at(core.param_groups[0]["lr"], count[0]) if core.count > count[0] else None
            count[0] = core.count
            records.append(dict(step=step, type=f.iter_type, loss=float(metrics["loss"]), lr=lr,
                                moved=sum(a != b for a, b in zip(before[0], after))))
            before[0] = after
            post(step, f, metrics)

        trainer._post_step = watch
        trainer._get_step = get_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(T, "make_train_step", make_with_census), \
                mock.patch.object(CS, "make_latent_flow_fn", recording_flow):
            trainer.fit(dataset, num_steps=RECIPES_MICRO_STEPS, start_step=start)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        trainer._get_step = real_get
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        after_ck = unet_checksum(unet)
        n_params = len(before[0])
        want = collections.Counter()
        for c in per_step:
            want.update(c)
        log(f"recipes ({card}): {len(records)} micro-steps in {fit_s:.2f} s: "
            + "; ".join(f"{r['step']} {r['type']} loss {r['loss']:.6e}"
                        + ("" if r["lr"] is None else f", an update at lr {r['lr']:.3e} moving "
                           f"{r['moved']} of {n_params} tensors") for r in records)
            + f"; UNet checksum inside each step {seen_ck}, after the fit {after_ck:.6e}; "
            f"{n_flow[0]} flow calls; peak memory {peak / 2**30:.2f} GiB")
        log(f"recipes: backward launches {({k: counts.get(k, 0) for k in bwd_keys})}, the "
            f"graphs hold {dict(want)}; launches {counts}")
        if [r["type"] for r in records] != RECIPES_TYPES \
                or not all(math.isfinite(r["loss"]) for r in records):
            raise AssertionError(f"recipes: micro-steps {records}")
        if seen_ck != [(t, comp_ck if t == "comp_distill" else base_ck) for t in RECIPES_TYPES] \
                or after_ck != base_ck:
            raise AssertionError(f"recipes: the comp UNet swap {seen_ck} {after_ck}")
        # an update moves the parameters where its learning rate is not 0 (a tensor
        # without gradient and at 0 stays), none where it is
        accum = trainer.cfg.accum_steps
        if not all(bool(r["moved"]) == bool(r["lr"]) for r in records) \
                or [r["lr"] is not None for r in records] != [
                    i % accum == accum - 1 for i in range(RECIPES_MICRO_STEPS)] \
                or not records[-1]["lr"] or not captured or n_flow[0] != 24:
            raise AssertionError(f"recipes: updates {records}, flow calls {n_flow[0]}")
        if {k: counts.get(k, 0) for k in bwd_keys} != {k: want[k] for k in bwd_keys} \
                or not want[A.FLASH_BWD_DKDV_WG] or not want[G.GN_BWD_FUSED]:
            raise AssertionError(f"recipes: backward launches {counts}, the graphs hold {want}")
        ck = trainer.save(RECIPES_MICRO_STEPS)

        # a comp micro-step's split, and its busy share with and without the flow
        from torch.profiler import ProfilerActivity, profile

        comp_flags = trainer.planner.plan(start + RECIPES_MICRO_STEPS)
        while comp_flags.iter_type != "comp_distill":
            comp_flags = trainer.planner.plan(comp_flags.step + 1)
        trainer._hot_swap_unet(True)
        try:
            split = comp_step_split(trainer, dataset, comp_flags)
        finally:
            trainer._hot_swap_unet(False)
        log(f"recipes ({card}): comp micro-step split ({split['priming_steps']} priming "
            f"steps), ms: "
            f"host prep {split['host_prep_ms']:.1f}, text encode {split['text_ms']:.1f}, "
            f"priming {split['priming_ms']:.1f}, denoising steps {split['denoise_ms']:.1f}, "
            f"decodes {split['decode_ms']:.1f}, host detection {split['detection_ms']:.1f}, "
            f"ArcFace {split['arcface_ms']:.1f}, re-denoise {split['redenoise_ms']:.1f}, "
            f"flow {split['flow_ms']:.1f}, rest of the forward {split['other_forward_ms']:.1f}, "
            f"backward {split['backward_ms']:.1f}, optimizer {split['optimizer_ms']:.1f}; total "
            f"{split['total_ms']:.1f} (synchronized, no prefetch)")
        batch = trainer._prepare_batch([dataset[i] for i in range(trainer.cfg.batch_size)],
                                       comp_flags, trainer.draws_for(comp_flags))
        busy = {}
        for label, use_flow in (("with the flow", True), ("without the flow", False)):
            trainer.comp_cfg = dataclasses.replace(trainer.comp_cfg, use_face_flow=use_flow)
            trainer._steps.clear()
            step_fn = trainer._get_step(comp_flags)
            step = lambda: step_fn(trainer.state, batch,  # noqa: E731
                                   trainer.draws_for(comp_flags, loss=True))
            trainer._hot_swap_unet(True)
            try:  # the split's comp micro-step warmed this one
                _, wall_ms = sync_ms(step)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    sync_ms(step)
            finally:
                trainer._hot_swap_unet(False)
            n_ops, busy_ms = profile_report(prof, f"recipes: a comp micro-step {label}", 8)
            busy[label] = dict(wall_ms=wall_ms, busy_ms=busy_ms, ops=n_ops)
            log(f"recipes ({card}): a comp micro-step {label}: {wall_ms:.1f} ms on the host "
                f"clock, device busy {busy_ms:.1f} ms in {n_ops} operations "
                f"({busy_ms / wall_ms:.1%} of the unprofiled wall)")
        trainer.comp_cfg = dataclasses.replace(trainer.comp_cfg, use_face_flow=True)
        trainer._steps.clear()
        on, off = busy["with the flow"], busy["without the flow"]
        log(f"recipes ({card}): the flow in a comp micro-step: {n_flow[0]} calls, "
            f"{split['flow_ms']:.1f} ms of the synchronized split, "
            f"{on['busy_ms'] - off['busy_ms']:.1f} ms of device time and "
            f"{on['ops'] - off['ops']} device operations more than the step without it")

        flow = flow_card_against_cpu(trainer.frozen["flow"], captured, card)
        opts = optimizers_card_against_cpu(trainer.state.params["sbg"][0], card)
        del trainer, batch, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        served = serve_mkv(ck, gen, card)
    return dict(counts=counts, want=dict(want), records=records, fit_s=fit_s, peak=peak,
                split=split, busy=busy, flow=flow, optimizers=opts, served=served)


def train_cli(config: str = STAGE2_CONFIG, max_steps: int = 7) -> dict:
    """`train_torch.py --base <config> --max_steps N` with no override on
    synthetic 512x512 PNGs (the default face detector: it finds no face in
    random photos), printing each micro-step's iteration type and loss from
    its metrics.csv (7 micro-steps of Stage 2: comp at 0 and 4, unet-distill
    at 6, recon at the others); not part of the smoke run:

        python3 -c "import chip_smoke as c; c.require_cuda(); c.train_cli()"
    """
    import csv
    import tempfile

    import train_torch

    kinds = {0: "recon", 1: "unet_distill", 2: "comp_distill"}
    repo = str(pathlib.Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=repo) as tmp:
        data = write_train_photos(os.path.join(tmp, "photos"))
        logs = os.path.join(tmp, "logs")
        t0 = time.perf_counter()
        metrics = train_torch.main(["--base", os.path.join(repo, config), "--data_roots", data,
                                    "--log_dir", logs, "--max_steps", str(max_steps)])
        secs = time.perf_counter() - t0
        with open(os.path.join(logs, "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
    steps = [(int(r["step"]), kinds[int(float(r["iter_type_id"]))], float(r["loss"]))
             for r in rows]
    for step, kind, loss in steps:
        log(f"train_torch {config}: micro-step {step} {kind}, loss {loss:.6e}")
    log(f"train_torch {config}: {len(steps)} micro-steps in {secs:.1f} s (the stack's build "
        f"included); last loss {float(metrics['loss']):.6e}")
    if len(steps) != max_steps or not all(math.isfinite(loss) for *_, loss in steps):
        raise AssertionError(f"train_torch {config}: {steps}")
    return dict(steps=steps, seconds=secs)


# device operations of a profile by kind, matched on the kernel's name in
# this order; "layout transpose" is cuDNN's layout change around a convolution
PROFILE_KINDS = (("layout transpose", r"nchwToNhwc|nhwcToNchw"),
                 ("convolution", r"fprop|conv|wgrad|dgrad"),
                 ("group norm kernel", r"gn_(stats|norm|fused|bwd)"),
                 ("batch norm kernel", r"\bbn_(stats|partial|finalize|norm_act)_kernel"),
                 ("flash kernel", r"flash_"),
                 ("copy", r"copy|Memcpy"),
                 ("concatenation", r"CatArray"),
                 ("matrix product", r"gemm|nvjet|cublas|cutlass"))


def profile_report(prof, label: str, top: int) -> tuple[int, float]:
    """Print a torch.profiler run's device time in all, by kind of kernel
    (PROFILE_KINDS) and for its `top` kernels by total time. Sums CUDA-kernel
    events only: the aten-op rows overlap their kernels. → (operations, ms)."""
    by_name: dict = {}
    for e in device_events(prof):
        if e.name != "Memset (Device)":
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.us)
    kinds = {kind: [0, 0.0] for kind, _ in PROFILE_KINDS + (("other", ""),)}
    for name, (n, us) in by_name.items():
        kind = next((k for k, pat in PROFILE_KINDS if re.search(pat, name)), "other")
        kinds[kind][0] += n
        kinds[kind][1] += us
    total_n = sum(n for n, _ in by_name.values())
    total = sum(us for _, us in by_name.values())
    log(f"profile {label}: {total / 1e3:.3f} ms of device time in {total_n} device operations; "
        + "; ".join(f"{k} {us / 1e3:.3f} ms x{n}" for k, (n, us) in kinds.items()))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"profile {label}: {us / 1e3:8.3f} ms {n:6d} x  {name[:150]}")
    return total_n, total / 1e3


def profile_request(top: int = 25) -> None:
    """Device time by kernel over one 512x512, 25-step request, with
    torch.profiler; not part of the smoke run:

        python3 -c "import chip_smoke as c; c.profile_request()"

    Prints the request's time on the host clock with the profiler off and
    on, the sum of the CUDA kernels' times in all and by kind (layout
    transposes, convolutions, GroupNorm kernels, copies, ...), and the
    kernels by total time."""
    from torch.profiler import ProfilerActivity, profile

    require_cuda()
    build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    wrapper, faces = build_server(gen)

    def request(seed):
        t0 = time.perf_counter()
        wrapper.prepare_adaface_embeddings(images=faces["a"])
        wrapper(REQUESTS[0][1], generator=torch.Generator("cuda").manual_seed(seed))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_runs = [request(s) for s in range(3)]  # the first warms up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = request(3)
    log(f"profile: request {', '.join(f'{x:.1f}' for x in plain_runs)} ms unprofiled, "
        f"{profiled:.1f} ms profiled")
    profile_report(prof, "request", top)


def short_kernel_name(name: str) -> str:
    """`void (anonymous namespace)::k<float>(float const*, ...)` → `k<float>`."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")[:60]


def profile_train_step(top: int = 25) -> None:
    """Device time by kernel over one face-parser train step at the published
    configuration (batch 16, crop 448, fp32), with torch.profiler; not part of
    the smoke run:

        python3 -c "import chip_smoke as c; c.profile_train_step()"

    Prints the step's time on the host clock with the profiler off and on,
    the sum of the CUDA kernels' times in all and by kind, the kernels by
    total time, and the train-mode BNs of one step by shape."""
    from torch.profiler import ProfilerActivity, profile

    from adaface_tpu_torch.train.face_parsing_train import (make_face_parsing_optimizer,
                                                            make_face_parsing_train_step)

    require_cuda()
    build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg, _, batches, model = build_face_parser(gen)
    step = make_face_parsing_train_step(cfg, model, make_face_parsing_optimizer(cfg, model))

    def one(i):
        t0 = time.perf_counter()
        step(*batches[i % 2])["loss"].item()
        return (time.perf_counter() - t0) * 1e3

    plain_runs = [one(i) for i in range(5)]  # the first warms up
    with bn_census(model) as seen, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = one(5)
    log(f"profile: train step {', '.join(f'{x:.1f}' for x in plain_runs)} ms unprofiled, "
        f"{profiled:.1f} ms profiled")
    log(f"profile: train-mode BNs of the step by (R, C): {dict(seen)}")
    expect_bn_census(seen, 1)
    profile_report(prof, "train step", top)


def profile_bn_stats(calls: int = RUN_LAUNCHES) -> None:
    """Device time of `bn_stats` by kernel name at every BN_CASES shape, with
    torch.profiler over `calls` calls: how many kernels a call launches and
    what each takes; not part of the smoke run:

        python3 -c "import chip_smoke as c; c.profile_bn_stats()"
    """
    from torch.profiler import ProfilerActivity, profile

    from adaface_tpu_torch.ops import fused_norm as N

    require_cuda()
    build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for label, r, c, _, dtype, _ in BN_CASES:
        x = (torch.randn((r, c), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
        for _ in range(3):
            N.bn_stats(x, BN_EPS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                N.bn_stats(x, BN_EPS)
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in device_events(prof):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.us)
        log(f"bn_stats {label:20s} R{r} C{c} {dtype}: "
            f"{sum(n for n, _ in by_name.values()) / calls:g} device operations a call, "
            f"{sum(us for _, us in by_name.values()) / calls:.2f} us a call; "
            + "; ".join(f"{short_kernel_name(name)} x{n / calls:g} "
                        f"{us / n:.2f} us" for name, (n, us) in by_name.items()))


def face_parser_batch(rs, batch: int, size: int):
    """Normalized images [B, 3, S, S] fp32 and labels [B, S, S] in 0..18
    with some 255 (ignored), from numpy. Each image gets its own gain and
    per-channel offset, as face crops differ in light and colour: iid noise
    images would give the BNs over pooled [B, 1, 1, C] maps nearly equal
    rows."""
    gain = rs.uniform(0.5, 2.0, (batch, 1, 1, 1))
    offset = rs.uniform(-1.0, 1.0, (batch, 3, 1, 1))
    images = (rs.randn(batch, 3, size, size) * gain + offset).astype(np.float32)
    labels = rs.randint(0, 19, (batch, size, size))
    labels[:, :size // 16] = 255
    return (torch.from_numpy(images).to("cuda", memory_format=torch.channels_last),
            torch.from_numpy(labels).to("cuda"))


@contextmanager
def deterministic_fp32():
    """Deterministic cuDNN algorithms, no TF32 in convolutions or matmuls."""
    from adaface_tpu_torch.core.device import fp32_convolutions
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with fp32_convolutions(matmuls=True):
            yield
    finally:
        torch.backends.cudnn.deterministic = saved


def bn_stats_fp64(x2, eps: float):
    """BN statistics summed in fp64, then rounded to fp32: a second plain
    reference, which sets the envelope of the train-step comparison."""
    xd = x2.double()
    return xd.mean(0).float(), torch.rsqrt(xd.var(0, unbiased=False) + eps).float()


def rel_l2(out: dict, ref: dict) -> tuple[dict, float]:
    """Relative L2 error of each tensor, and of all of them together."""
    per = {n: ((out[n] - ref[n]).norm() / ref[n].norm()).item() for n in ref}
    num = sum(((out[n] - ref[n]) ** 2).sum() for n in ref)
    den = sum((ref[n] ** 2).sum() for n in ref)
    return per, (num / den).sqrt().item()


def build_face_parser(gen):
    """→ (the published train configuration: batch 16, crop 448; the numpy
    generator; two batches on the card; BiSeNet with seeded random weights)."""
    from adaface_tpu_torch.models.bisenet import build_bisenet
    from adaface_tpu_torch.train.face_parsing_train import FaceParsingTrainConfig

    cfg = FaceParsingTrainConfig()
    rs = np.random.RandomState(SEED)
    batches = [face_parser_batch(rs, cfg.batch_size, cfg.crop_size) for _ in range(2)]
    return cfg, rs, batches, build_bisenet("cuda", gen)


def train_face_parser(gen) -> dict:
    from adaface_tpu_torch.models.bisenet import N_CLASSES, parsing_to_face_mask
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import fused_norm as N
    from adaface_tpu_torch.train.face_parsing_train import (
        face_parsing_loss, make_face_parsing_optimizer, make_face_parsing_train_step)

    cfg, rs, batches, model = build_face_parser(gen)
    n_params = sum(p.numel() for p in model.parameters())

    # one step's loss and gradients, kernels against plain, same weights
    def loss_and_grads(m):
        m.zero_grad(set_to_none=True)
        loss, _ = face_parsing_loss(m, *batches[0], cfg)
        loss.backward()
        return loss.item(), {n: p.grad.float() for n, p in m.named_parameters()}

    plain_model, fp64_model = copy.deepcopy(model), copy.deepcopy(model)
    with deterministic_fp32():
        loss_k, grads_k = loss_and_grads(model)
        with plain_versions():
            loss_p, grads_p = loss_and_grads(plain_model)
            with mock.patch.object(N, "bn_stats", bn_stats_fp64):
                _, grads_e = loss_and_grads(fp64_model)
    del plain_model, fp64_model
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    per, glob = rel_l2(grads_k, grads_p)
    per_env, glob_env = rel_l2(grads_e, grads_p)
    worst = max(per, key=per.get)
    bound_glob = max(GRAD_REL_TOL, ENVELOPE * glob_env)
    bound_per = max(GRAD_REL_TOL, ENVELOPE * max(per_env.values()))
    log(f"train: BiSeNet-ResNet18 {n_params} params, batch {cfg.batch_size} crop "
        f"{cfg.crop_size} fp32, deterministic cuDNN, no TF32: loss kernels {loss_k:.6f} plain "
        f"{loss_p:.6f} rel_diff {loss_rel:.3e} (bound {LOSS_REL_TOL:g}); gradients rel L2, "
        f"kernels against plain: all {glob:.3e} (bound {bound_glob:.3e}), largest tensor "
        f"{per[worst]:.3e} at {worst} (bound {bound_per:.3e}); envelope, plain with fp64 "
        f"statistics against plain: all {glob_env:.3e}, largest tensor "
        f"{max(per_env.values()):.3e}")
    if not math.isfinite(loss_k) or loss_rel > LOSS_REL_TOL:
        raise AssertionError(f"train step kernels against plain: loss {loss_k} vs {loss_p}")
    if not (glob <= bound_glob and all(math.isfinite(v) and v <= bound_per
                                       for v in per.values())):
        raise AssertionError(f"train step kernels against plain: gradients rel L2 {glob}, "
                             f"{per[worst]} at {worst}")
    del grads_k, grads_p, grads_e

    # the training path: the port's train step and optimizer, default flags
    opt = make_face_parsing_optimizer(cfg, model)
    step = make_face_parsing_train_step(cfg, model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, secs = [], []
    with bn_census(model) as seen:
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics = step(*batches[i % 2])
            losses.append(metrics["loss"].item())  # syncs
            secs.append(time.perf_counter() - t0)
    counts = launch_counts()
    expect_counts(counts, bisenet_forwards=TRAIN_STEPS)
    expect_bn_census(seen, TRAIN_STEPS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steady = (TRAIN_STEPS - 1) / sum(secs[1:])
    log(f"train: {TRAIN_STEPS} steps, losses {', '.join(f'{v:.4f}' for v in losses)}; "
        f"step times {', '.join(f'{v * 1e3:.1f}' for v in secs)} ms; "
        f"{steady:.3f} steps/sec over steps 2..{TRAIN_STEPS} "
        f"({TRAIN_STEPS / sum(secs):.3f} with the first); peak device memory "
        f"{peak_gib:.2f} GiB; launches {counts}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train: losses not finite: {losses}")

    # eval mode (running statistics, no kernel) at gen_face_masks.py's size
    model.eval()
    image, _ = face_parser_batch(rs, 1, 512)
    _build.reset_launch_counts()
    with torch.inference_mode():
        logits = model(image)
        parsing = logits.argmax(1)[0].cpu().numpy()
    expect_counts(launch_counts())
    mask = parsing_to_face_mask(parsing)
    if tuple(logits.shape) != (1, N_CLASSES, 512, 512) or not torch.isfinite(logits).all():
        raise AssertionError(f"eval: logits {tuple(logits.shape)} not finite or misshaped")
    if mask.shape != (512, 512) or mask.dtype != np.uint8 or not set(
            np.unique(mask)) <= {0, 255}:
        raise AssertionError("eval: face mask is not a binary [512, 512] uint8 map")
    log(f"eval: 512x512 forward to a face mask, {(mask > 0).mean():.3f} of pixels face")
    return dict(counts=counts, losses=losses, secs=secs, steps_per_sec=steady,
                peak_gib=peak_gib, loss_rel=loss_rel, grad_rel=glob, grad_rel_env=glob_env)


# ---------------------------------------------------------------------------
# int8 PTQ kernels (phase 3) and the serving speed modes
# ---------------------------------------------------------------------------

INT8_OPS_PER_S = 1979e12  # H100 SXM data sheet: dense int8 tensor-core operations
INT8_BATCHES = (2, 16)  # a request's CFG batch, the 8-slot batcher's
INT8_GRAPH = dict(launches=5, reps=3)  # the int8 cases' CUDA-graph timing: ~90 shapes
JSON_INT8 = "conv 2x320x64x64 -> 320 3x3/1"  # the 64x64 level's resnet convolution
# timed 512x512, 25-step requests of each mode (cut from 3 to keep the whole
# run under 750 s)
SPEED_REQUESTS = 2
# (name, int8, DeepCache interval, ToMe ratio)
SPEED_MODES = [("deepcache 3", False, 3, 0.0), ("deepcache 5", False, 5, 0.0),
               ("tome 0.5", False, 0, 0.5), ("int8", True, 0, 0.0),
               ("int8 + deepcache 3", True, 3, 0.0), ("int8 + deepcache 5", True, 5, 0.0)]
# the quality gate's turbo mode (`scripts/bench_quality_torch.py`'s default)
GATE_MODE = "int8 + deepcache 5"
SHALLOW_FLASH = 10  # flash launches of a shallow DeepCache call: 5 transformers at 64x64


def int8_label(mod, x_shape) -> str:
    from adaface_tpu_torch.ops.quant import Int8Conv2d

    o = mod.w_q.shape[0]
    if isinstance(mod, Int8Conv2d):
        n, c, h, w = x_shape
        k = mod.w_q.shape[1]
        return f"conv {n}x{c}x{h}x{w} -> {o} {k}x{k}/{mod.stride[0]}"
    return f"dense {math.prod(x_shape[:-1])}x{x_shape[-1]} -> {o}"


@contextmanager
def int8_census(module):
    """Count the int8 layers' calls inside `module` by shape label while the
    block runs; yields (counter, {label: one module of that shape})."""
    from adaface_tpu_torch.ops.quant import Int8Conv2d, Int8Linear

    modules = {}

    def key(mod, args, kwargs):
        label = int8_label(mod, tuple(args[0].shape))
        modules.setdefault(label, (mod, tuple(args[0].shape)))
        return label

    with census(module, (Int8Conv2d, Int8Linear), key) as seen:
        yield seen, modules


def int8_bound(x_bytes: float, w_q, y_numel: int, ops: float) -> tuple[float, str]:
    """The larger of the bytes (x as given, w_q int8, scale and bias fp32, y
    bf16) at 3.35 TB/s and the int8 operations at 1979 TOP/s, ms."""
    t_bytes = (x_bytes + w_q.numel() + 8 * w_q.shape[0] + 2 * y_numel) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def im2col_int_mm(x_q, w_kmajor, k: int, stride: int, pad: int):
    """The yardstick of `int8_conv_igemm`: int8 im2col of channels-last x_q
    ([N, C, H, W] in NHWC memory, or rows [M, C]) by shifted slices, then
    one `torch._int_mm` (cuBLASLt int8 → int32) with w [K, O]. Never on the
    path."""
    if x_q.dim() == 2:
        return torch._int_mm(x_q, w_kmajor)
    nhwc = x_q.permute(0, 2, 3, 1)
    if k == 1 and stride == 1:
        return torch._int_mm(nhwc.reshape(-1, nhwc.shape[-1]), w_kmajor)
    n, h, w, c = nhwc.shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    xp = F.pad(nhwc, (0, 0, pad, pad, pad, pad))
    cols = [xp[:, ky:ky + stride * ho:stride, kx:kx + stride * wo:stride]
            for ky in range(k) for kx in range(k)]
    return torch._int_mm(torch.cat(cols, dim=-1).reshape(n * ho * wo, k * k * c), w_kmajor)


def int8_path_shapes(gen):
    """One full-width SD1.5 UNet (random weights from `gen`, bf16) and its
    int8 copy with `quantize_dense`, called once at each of INT8_BATCHES:
    (unet, int8 unet, {label: (one module of that shape, x's shape)},
    {batch: {label: calls a UNet call}})."""
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.models.unet import (SD15_UNET, UNet2DConditionModel,
                                               init_unet_weights_)
    from adaface_tpu_torch.ops import quant as Q

    unet = build(lambda: UNet2DConditionModel(dataclasses.replace(SD15_UNET, fused_ln=False)),
                 "cuda", torch.bfloat16, init_unet_weights_, gen)
    q = Q.quantize_unet(unet, quantize_dense=True)
    shapes, per_call = {}, {}
    with torch.inference_mode():
        for b in INT8_BATCHES:
            x = torch.randn((b, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
            t = torch.full((b,), 501, dtype=torch.long, device="cuda")
            ctx = torch.randn((b, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
            with int8_census(q) as (seen, modules):
                eps = q(x, t, ctx)
            if not torch.isfinite(eps).all():
                raise AssertionError(f"int8 UNet at batch {b}: output not finite")
            per_call[b] = dict(seen)
            shapes.update(modules)
    return unet, q, shapes, per_call


def graph_nodes(fn) -> collections.Counter:
    """What one call of `fn` puts on the device: the nodes of a CUDA graph
    that captures it, by type ("kernel", "memset", ...), read through the
    CUDA runtime that torch loaded."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cudart = ctypes.CDLL("libcudart.so.12")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cudart.cudaGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cudart.cudaGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cudaGraphGetNodes failed")
    names = {0: "kernel", 1: "memcpy", 2: "memset"}  # cudaGraphNodeType
    kinds = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cudart.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cudaGraphNodeGetType failed")
        kinds[names.get(kind.value, f"type {kind.value}")] += 1
    return kinds


def check_int8(gen) -> dict:
    """`quant_act` and `int8_conv_igemm` against their plain
    versions at every int8 layer shape of the SD1.5 UNet (convolutions, and
    the `quantize_dense` layers) at CFG batch 2 and at batch 16, found by a
    census of one int8 UNet call at each: bit for bit, twice to the same
    bits, a cluster-split plan against the same plan unsplit, and the
    operations one layer puts on the device (three kernels, no memset);
    times single and as CUDA graphs beside the bound, cuDNN's bf16
    convolution (or cuBLAS's bf16 product) and im2col + `torch._int_mm`,
    both yardsticks only."""
    import ctypes

    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import quant as Q

    unet, q, shapes, per_call = int8_path_shapes(gen)
    lib = _build.load_library()
    sms = _build.sm_count(0)
    results = {}
    with torch.inference_mode():
        for label, (mod, x_shape) in shapes.items():
            conv = isinstance(mod, Q.Int8Conv2d)
            x = (torch.randn(x_shape, generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
            if conv:
                x = x.contiguous(memory_format=torch.channels_last)
            x_q, amax = Q.quantize_act_cuda(x)
            x_q_plain, _ = Q.quantize_act(x)
            amax_plain = x.float().abs().amax()
            y, y2 = mod(x), mod(x)
            with plain_versions():
                ref = mod(x)
            torch.cuda.synchronize()
            amax_same = amax[:1].view(torch.float32).item() == amax_plain.item()
            err = (y.float() - ref.float()).abs().max().item()
            if not (torch.equal(x_q, x_q_plain) and amax_same):
                raise AssertionError(f"int8 {label}: quantization differs from plain "
                                     f"({(x_q != x_q_plain).sum().item()} values)")
            if not torch.equal(y, ref):
                raise AssertionError(f"int8 {label}: kernel differs from plain by {err}")
            if not torch.equal(y, y2):
                raise AssertionError(f"int8 {label}: two runs differ")
            o = mod.w_q.shape[0]
            k = mod.w_q.shape[1] if conv else 1
            stride, pad = (mod.stride[0], mod.padding[0]) if conv else (1, 0)
            rows = y.numel() // o
            n_sp = (x.shape[0], x.shape[2], x.shape[3]) if conv else (rows, 1, 1)
            w_q = mod.w_q if conv else mod.w_q.reshape(o, 1, 1, -1)
            plan = Q.igemm_plan(rows, w_q.shape[-1], o, k, stride, sms)
            stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
            words, xq_buf = torch.empty(1 + Q.QUANT_SLOTS, dtype=torch.int32,
                                        device="cuda"), torch.empty_like(x_q)
            fn = lambda: mod(x)  # noqa: E731
            act_fn = lambda: lib.int8_quantize(x.data_ptr(), x.numel(), words.data_ptr(),  # noqa
                                               xq_buf.data_ptr(), stream())
            igemm = lambda pl=plan: Q._igemm(x_q, amax, w_q, mod.w_scale,  # noqa: E731
                                             mod.bias, *n_sp, k, stride, pad, pl)
            unsplit = dataclasses.replace(plan, split=1)
            if plan.split > 1 and not torch.equal(igemm(), igemm(unsplit)):
                raise AssertionError(f"int8 {label}: a {plan.split}-block cluster differs from "
                                     "one block")
            nodes = graph_nodes(fn)
            kernels, memsets = nodes["kernel"], nodes["memset"]
            occupancy = ctypes.c_int(0)
            _build.check(lib.int8_igemm_occupancy(plan.tile_n, plan.stages, plan.split,
                                                  ctypes.byref(occupancy)), "int8_igemm_occupancy")
            if (kernels, memsets) != (2, 0):
                raise AssertionError(f"int8 {label}: a layer put {kernels} kernels and {memsets} "
                                     "memsets on the device, expected 2 and 0")
            w_bf, b_bf = mod.dequantized().to(torch.bfloat16), mod.bias.to(torch.bfloat16)
            if conv:
                w_bf = w_bf.contiguous(memory_format=torch.channels_last)
                bf16 = lambda: F.conv2d(x, w_bf, b_bf, stride, pad)  # noqa: E731
            else:
                bf16 = lambda: F.linear(x, w_bf, b_bf)  # noqa: E731
            w_k = mod.w_q.reshape(o, -1).t()
            x_rows = x_q if conv else x_q.reshape(rows, -1)
            try:
                int_mm = graph_ms(lambda: im2col_int_mm(x_rows, w_k, k, stride, pad), **INT8_GRAPH)
            except RuntimeError as e:  # a shape cuBLASLt's int8 product refuses: no yardstick
                int_mm = None
                log(f"int8 {label}: torch._int_mm refused the shape ({str(e).splitlines()[0]})")
            ms, dev = median_ms(fn), graph_ms(fn, **INT8_GRAPH)
            with plain_versions():
                plain_ms = median_ms(fn, reps=3, warmup=1)
            r = dict(err=err, ms=ms, graph_ms=dev, plain_ms=plain_ms,
                     act_graph_ms=graph_ms(act_fn, **INT8_GRAPH),
                     act_plain_ms=median_ms(lambda: Q.quantize_act(x)),
                     igemm_graph_ms=graph_ms(igemm, **INT8_GRAPH),
                     plan=dataclasses.asdict(plan),
                     igemm_unsplit_graph_ms=(graph_ms(lambda: igemm(unsplit), **INT8_GRAPH)
                                             if plan.split > 1 else None),
                     cudnn_bf16_graph_ms=graph_ms(bf16, **INT8_GRAPH), int_mm_graph_ms=int_mm,
                     layer_kernels=kernels, layer_memsets=memsets,
                     smem_bytes=Q.igemm_smem(plan), blocks_per_sm=occupancy.value,
                     calls={b: per_call[b].get(label, 0) for b in INT8_BATCHES})
            if label == JSON_INT8:  # the host's cost of a layer, where the device is quick
                r["host_us"], r["cudnn_bf16_host_us"] = host_us(fn), host_us(bf16)
            ops = 2.0 * rows * o * (w_q.numel() // o)
            r["bound_ms"], r["bound_by"] = int8_bound(2 * x.numel(), w_q, y.numel(), ops)
            r["igemm_bound_ms"], r["igemm_bound_by"] = int8_bound(x.numel(), w_q, y.numel(), ops)
            r["act_bound_ms"] = 3 * x.numel() / HBM_BYTES_PER_S * 1e3
            results[label] = r
            if "host_us" in r:
                log(f"int8 {label}: host per call: the int8 layer {r['host_us']:.1f} us, cuDNN "
                    f"bf16 {r['cudnn_bf16_host_us']:.1f} us")
            log(f"int8 {label} (calls a UNet call at B2/B16: {r['calls'][2]}/{r['calls'][16]}): "
                f"bit-equal to plain, two runs the same bits, {kernels} kernels and {memsets} "
                f"memsets a layer | the layer (quant_act, int8_conv_igemm): single "
                f"{ms:.4f} ms, graph {dev:.4f} ms, plain (fp64 sums) {plain_ms:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bound_ms'] / dev:.1%}) | igemm "
                f"(N {plan.tile_n}, {plan.step}-byte steps, {plan.stages} stages, cluster "
                f"{plan.split}; {r['smem_bytes']} B of shared memory, {occupancy.value} blocks an "
                f"SM) graph "
                f"{r['igemm_graph_ms']:.4f} ms"
                + ("" if plan.split == 1 else f" (one block a tile {r['igemm_unsplit_graph_ms']:.4f},"
                   " the same bits)") +
                f" (bound {r['igemm_bound_ms']:.4f} by {r['igemm_bound_by']}, reached "
                f"{r['igemm_bound_ms'] / r['igemm_graph_ms']:.1%}) | quant_act "
                f"{r['act_graph_ms']:.4f} ms (bound {r['act_bound_ms']:.4f}) | cuDNN/cuBLAS bf16 graph "
                f"{r['cudnn_bf16_graph_ms']:.4f} ms | im2col + _int_mm graph "
                f"{'refused' if int_mm is None else f'{int_mm:.4f} ms'}")
            del x, x_q, x_q_plain, y, y2, ref, xq_buf, w_bf
        torch.cuda.empty_cache()
    for b in INT8_BATCHES:
        keys = ("graph_ms", "igemm_graph_ms", "act_graph_ms",
                "cudnn_bf16_graph_ms", "bound_ms", "igemm_bound_ms")
        sums = {key: sum(results[label][key] * n for label, n in per_call[b].items()
                         if label.startswith("conv")) for key in keys}
        n_conv = sum(n for label, n in per_call[b].items() if label.startswith("conv"))
        log(f"int8 per UNet call at batch {b}: {n_conv} convolutions, int8 layers "
            f"{sums['graph_ms']:.3f} ms of device time (igemm alone {sums['igemm_graph_ms']:.3f}, "
            f"{sums['igemm_bound_ms'] / sums['igemm_graph_ms']:.1%} of its bound; quant_act "
            f"{sums['act_graph_ms']:.3f}), cuDNN bf16 "
            f"{sums['cudnn_bf16_graph_ms']:.3f} ms, bound {sums['bound_ms']:.3f} ms")
        results[f"per call B{b}"] = dict(convs=n_conv, **sums)
    del unet, q
    torch.cuda.empty_cache()
    return results


@contextmanager
def tome_decisions(record: list | None = None, replay: list | None = None):
    """`ops.tome.match` recording its decisions (merged_pos, kept_pos, tgt)
    into `record`, or handing out those of `replay` in order instead of
    matching: a ToMe request held to another path with the same merges."""
    from adaface_tpu_torch.ops import tome as T

    match, handed = T.match, iter(replay) if replay is not None else None

    def patched(*args):
        if handed is not None:
            return next(handed)
        out = match(*args)
        if record is not None:
            record.append(tuple(t.clone() for t in out))
        return out

    with mock.patch.object(T, "match", patched):
        yield


@contextmanager
def int8_roundings(record: list | None = None, replay: list | None = None):
    """The int8 layers' quantized activations: the kernels' (x_q and the
    bits of max |x|, `quant_act`) recorded into `record`, or
    those of `replay` handed in order to the plain version (its x_q and the
    scale computed from them as the kernels compute it). A bf16 rounding
    upstream that the kernels and the plain versions take apart sends an
    activation at a half step to the other int8 value, and on random
    weights that flip moves every layer after it: handed over, the two
    paths differ only where the int8 sums and epilogues would."""
    from adaface_tpu_torch.ops import quant as Q

    if replay is not None:
        handed = iter(replay)

        def plain(x):
            x_q, amax = next(handed)
            if tuple(x_q.shape) != tuple(x.shape):
                raise AssertionError(f"int8 roundings: {tuple(x_q.shape)} handed to "
                                     f"{tuple(x.shape)}")
            return x_q, (amax[:1].view(torch.float32).clamp(min=1e-8) / 127.0).reshape(())

        with mock.patch.object(Q, "quantize_act", plain):
            yield
        return
    kernels = Q.quantize_act_cuda

    def recorded(x):
        x_q, amax = kernels(x)
        if record is not None:
            record.append((x_q.clone(), amax.clone()))
        return x_q, amax

    with mock.patch.object(Q, "quantize_act_cuda", recorded):
        yield


def decisions_apart(a: list, b: list) -> tuple[int, int]:
    """(merge decisions of two runs that differ, all): per build_merge call
    the merged set's positions and their targets, position by position."""
    diff = total = 0
    for (am, _, at), (bm, _, bt) in zip(a, b):
        diff += int((am != bm).sum()) + int((at != bt).sum())
        total += am.numel() + at.numel()
    return diff, total


def gn_expected_from(seen: dict) -> dict:
    """Launches of each GroupNorm kernel for a census of (shape, eps, SiLU)
    calls, by `gn_plan` on this card."""
    from adaface_tpu_torch.ops.fused_gn import GN_FUSED, GN_NORM, GN_STATS, gn_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = collections.Counter()
    for ((b, c, h, w), _, _), n in seen.items():
        groups = 32
        if gn_plan(torch.bfloat16, b, c, h * w, groups, sms).kernel == "fused":
            want[GN_FUSED] += n
        else:
            want[GN_STATS] += n
            want[GN_NORM] += n
    return want


def speed_request(w, seed: int, hw: int = 512, steps: int = 25, **mode):
    """One request through the wrapper's pipeline with a speed mode
    (`deepcache_interval`, `tome_ratio`): subject a's ada rows are in the
    table; → the image [3, hw, hw]."""
    from adaface_tpu_torch.inference.wrapper import DEFAULT_NEGATIVE_PROMPT

    return w.pipeline([w.update_prompt(REQUESTS[0][1])], negative_prompt=DEFAULT_NEGATIVE_PROMPT,
                      num_inference_steps=steps, guidance_scale=6.0, height=hw, width=hw,
                      generator=torch.Generator("cuda").manual_seed(seed), **mode)[0]


def serve_speed_modes(wrapper, faces, card: str) -> dict:
    """The pipeline's three speed modes at full SD1.5 width on the phase-5
    modules: one int8 UNet call kernels against plain and against the bf16
    call; a small request of each mode kernels against plain (ToMe with the
    kernel run's merges handed to the plain run, and the merges that differ
    unhanded counted); 3 timed 512x512, 25-step requests of each mode with
    launches by kernel, device time and operations, host time and the
    distance from the default path's image of the same seed; the 8-slot
    batcher serving the int8 UNet: a drain, and one step captured and
    replayed twice to the same bits."""
    from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import quant as Q

    t_phase = time.perf_counter()
    m = wrapper.pipeline.m
    wq = AdaFaceWrapper("text2img", m, wrapper.id2ada_prompt_encoder, guidance_scale=6.0,
                        num_inference_steps=25, quantize_unet=True)
    qunet = wq.pipeline.m.unet
    if m.unet.down_blocks[0].resnets[0].conv1.__class__ is not torch.nn.Conv2d:
        raise AssertionError("quantize_unet changed the caller's UNet")
    gen = torch.Generator("cuda").manual_seed(300)
    x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.full((2,), 501, dtype=torch.long, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        roundings = []
        with int8_census(qunet) as (layers, _), int8_roundings(record=roundings):
            eps_q = qunet(x, t, ctx).float()
        with plain_versions():
            with int8_roundings(replay=roundings):
                ref_q = qunet(x, t, ctx).float()
            free_q = qunet(x, t, ctx).float()
        eps_bf = m.unet(x, t, ctx).float()
    per_call = sum(layers.values())
    rel_kp, rel_bf = rel_l2_of(eps_q, ref_q), rel_l2_of(eps_q, eps_bf)
    rel_free = rel_l2_of(eps_q, free_q)
    corr = float(np.corrcoef(eps_q.cpu().numpy().ravel(), eps_bf.cpu().numpy().ravel())[0, 1])
    del roundings
    log(f"speed modes: int8 UNet call at CFG batch 2, 64x64 ({per_call} int8 layers): kernels "
        f"against plain with the kernels' int8 activations handed over rel L2 {rel_kp:.3e} "
        f"(bound {UNET_REL_TOL:g}), free-running {rel_free:.3e}; against the bf16 call rel L2 "
        f"{rel_bf:.3e}, correlation {corr:.6f}")
    if not torch.isfinite(eps_q).all() or rel_kp > UNET_REL_TOL:
        raise AssertionError(f"int8 UNet kernels against plain: rel L2 {rel_kp}")

    # a small request of each mode, kernels against plain
    wrapper.prepare_adaface_embeddings(images=faces["a"])
    small = {}
    for name, int8, dc, tome in SPEED_MODES:
        w = wq if int8 else wrapper
        mode = dict(deepcache_interval=dc, tome_ratio=tome)
        # ToMe merges only the 4096 tokens of a 512x512 image's 64x64 level
        hw, steps = (512, 2) if tome else (256, 4)
        record, unpinned, roundings = [], [], []
        with tome_decisions(record=record), int8_roundings(record=roundings):
            img_k = speed_request(w, 7, hw, steps, **mode)
        with plain_versions():
            with tome_decisions(replay=record if tome else None), \
                    int8_roundings(replay=roundings if int8 else None):
                img_p = speed_request(w, 7, hw, steps, **mode)
            if tome:
                with tome_decisions(record=unpinned):
                    speed_request(w, 7, hw, steps, **mode)
        err = (img_k - img_p).abs().max().item()
        apart = decisions_apart(record, unpinned) if tome else (0, 0)
        del roundings
        small[name] = dict(err=err, decisions_apart=apart)
        log(f"speed modes: {name} {hw}x{hw} {steps}-step request, kernels against plain: image "
            f"max_abs_err {err:.3e} (bound {IMAGE_TOL:g})"
            + (f"; merges handed over ({len(record)} build_merge calls); unhanded, {apart[0]} of "
               f"{apart[1]} decisions differ" if tome else "")
            + ("; the kernels' int8 activations handed over" if int8 else ""))
        if err > IMAGE_TOL:
            raise AssertionError(f"{name} request kernels against plain: error {err}")

    # timed requests: the default path first, then each mode, SPEED_REQUESTS seeds each
    speed_request(wrapper, 399, steps=2)
    default, default_lat = [], []
    for i in range(SPEED_REQUESTS):
        t0 = time.perf_counter()
        default.append(speed_request(wrapper, 400 + i))
        torch.cuda.synchronize()
        default_lat.append(time.perf_counter() - t0)
    _, default_dev, default_ops = profiled_ms(lambda: speed_request(wrapper, 400), host_runs=1)
    log(f"speed modes: default 512x512 25 steps: latency "
        f"{', '.join(f'{s * 1e3:.1f}' for s in default_lat)} ms, device {default_dev:.2f} ms in "
        f"{default_ops} operations")
    modes = {"default": dict(latency_ms=[s * 1e3 for s in default_lat], device_ms=default_dev,
                             operations=default_ops)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    vae_split = A.flash_plan(torch.bfloat16, *FLASH_CASES[-1][1:], sms).nsplit > 1
    for name, int8, dc, tome in SPEED_MODES:
        w = wq if int8 else wrapper
        mode = dict(deepcache_interval=dc, tome_ratio=tome)
        speed_request(w, 399, steps=2, **mode)  # warm-up: layouts, algorithms
        _build.reset_launch_counts()
        images, lat = [], []
        with gn_census(w.pipeline.m.unet) as seen_gn, gn_census(m.vae) as seen_vae, \
                int8_census(w.pipeline.m.unet) as (seen_int8, _):
            for i in range(SPEED_REQUESTS):
                t0 = time.perf_counter()
                images.append(speed_request(w, 400 + i, **mode))
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
        counts = launch_counts()
        check_images(images, SPEED_REQUESTS, 512, name)
        full = len(range(0, 25, dc)) if dc > 1 else 25
        shallow = 25 - full
        n = SPEED_REQUESTS
        want = collections.Counter({A.FLASH_T: n * (20 * full + SHALLOW_FLASH * shallow),
                                    A.FLASH_STD: n * 10 * full, A.FLASH_WIDE: n,
                                    A.FLASH_COMBINE: n * vae_split})
        want.update(gn_expected_from(seen_gn) + gn_expected_from(seen_vae))
        int8_calls = sum(seen_int8.values())
        if int8:
            for key in (Q.QUANT_ACT, Q.INT8_CONV):
                want[key] = int8_calls
            if dc <= 1 and int8_calls != n * 25 * per_call:
                raise AssertionError(f"{name}: {int8_calls} int8 layer calls, expected "
                                     f"{n * 25 * per_call}")
        want = {k: v for k, v in want.items() if v}
        if {k: v for k, v in counts.items() if v} != want:
            raise AssertionError(f"{name}: launch counts {counts}, expected {want}")
        again = []
        _, dev, ops = profiled_ms(lambda: again.append(speed_request(w, 400, **mode)),
                                  host_runs=1)
        same_bits = all(torch.equal(img, images[0]) for img in again)
        if tome and not same_bits:  # the merged sums are taken in a fixed order
            raise AssertionError(f"{name}: two runs of a request differ")
        dist = [(img - ref).abs().max().item() for img, ref in zip(images, default)]
        rel = [rel_l2_of(img, ref) for img, ref in zip(images, default)]
        modes[name] = dict(latency_ms=[s * 1e3 for s in lat], device_ms=dev, operations=ops,
                           counts=counts, max_abs_from_default=dist, rel_l2_from_default=rel,
                           full_calls=full, shallow_calls=shallow, same_bits=same_bits)
        if name == GATE_MODE:
            gate_images = dict(default=default, turbo=images)
        log(f"speed modes: {name} 512x512 25 steps ({full} full + {shallow} shallow UNet calls "
            f"a request): latency {', '.join(f'{s * 1e3:.1f}' for s in lat)} ms (default "
            f"{statistics.median(default_lat) * 1e3:.1f}), device {dev:.2f} ms in {ops} "
            f"operations (default {default_dev:.2f} in {default_ops}); a request run again "
            f"{'gives the same bits' if same_bits else 'DIFFERS'}; pixels from the default "
            f"image of the same seed: max {', '.join(f'{d:.3e}' for d in dist)}, rel L2 "
            f"{', '.join(f'{r:.3e}' for r in rel)}; launches {counts}")

    # the 8-slot batcher serving the int8 UNet
    adas = subject_embeddings(wq, faces)
    wq.make_batcher(num_slots=BATCH_SLOTS, num_inference_steps=2).generate_all(
        batch_requests(wq, adas, 512, BATCH_SLOTS))
    batcher = wq.make_batcher(num_slots=BATCH_SLOTS)
    if batcher.m.unet is not qunet:
        raise AssertionError("the int8 wrapper's batcher does not serve the int8 UNet")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = batcher.generate_all(batch_requests(wq, adas, 512, BATCH_SLOTS))
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    drain_counts = launch_counts()
    check_images([out[i] for i in range(BATCH_SLOTS)], BATCH_SLOTS, 512, "int8 batcher")
    if not all(drain_counts.get(k) for k in (Q.QUANT_ACT, Q.INT8_CONV)):
        raise AssertionError(f"int8 batcher: the int8 kernels did not run: {drain_counts}")
    b = wq.make_batcher(num_slots=BATCH_SLOTS)
    for slot, r in enumerate(batch_requests(wq, adas, 512, BATCH_SLOTS)):
        b._admit(slot, r)
    b._step()
    same, replay_ms = step_replays_same_bits(b, replays=2)
    log(f"speed modes: int8 batcher, {BATCH_SLOTS} requests through {BATCH_SLOTS} slots, "
        f"512x512, 25 steps: {drain_s:.2f} s, {BATCH_SLOTS / drain_s:.3f} imgs/sec; launches "
        f"{drain_counts}; a step captured in a CUDA graph and replayed twice: {replay_ms:.2f} ms "
        f"a replay, both with the eager step's bits: {same}")
    if not same:
        raise AssertionError("int8 batcher: a replayed CUDA graph of the step differs")
    secs = time.perf_counter() - t_phase
    log(f"speed modes: card {card}; the phase {secs:.1f} s")
    del wq, batcher, b
    return dict(int8_rel=rel_kp, int8_rel_free=rel_free, int8_rel_bf16=rel_bf, int8_corr=corr,
                small=small, modes=modes, gate_images=gate_images,
                int8_counts=modes["int8"]["counts"], drain_imgs_per_sec=BATCH_SLOTS / drain_s,
                drain_counts=drain_counts, replay_ms=replay_ms, seconds=secs)


XL_SUBJECTS = ("a", "b")  # one 1024x1024 request each, prompts from REQUESTS
XL_STEPS, SD3_STEPS = 25, 28
XL_HW = 1024
MODULATION_STD = 0.02  # SD3's adaLN-zero modulations and head, drawn off their 0 for the smoke


def transformer_blocks(module) -> int:
    """Transformer blocks in a UNet's Transformer2Ds (a depth-N one holds N)."""
    from adaface_tpu_torch.models.unet import Transformer2D

    return sum(len(t.blocks) if hasattr(t, "blocks") else 1
               for t in module.modules() if isinstance(t, Transformer2D))


def serve_xl_requests(w, faces, steps: int, gen_seed: int, census_of) -> dict:
    """One 1024x1024 request of each of XL_SUBJECTS through the wrapper `w`
    (a warm-up request of 2 steps first), with the kernels' launches, the
    GroupNorm census of each module in `census_of` ({name: module}), the
    host latency of each, then one more on the host's clock and one
    profiled: its device time and operations, by kind of kernel."""
    w.prepare_adaface_embeddings(images=faces["a"])
    w(REQUESTS[0][1], num_inference_steps=2, height=XL_HW, width=XL_HW,
      generator=torch.Generator("cuda").manual_seed(gen_seed - 1))
    torch.cuda.synchronize()
    from adaface_tpu_torch.ops import _build

    _build.reset_launch_counts()
    images, latencies = [], []
    with contextlib.ExitStack() as stack:
        seen = {name: stack.enter_context(gn_census(mod)) for name, mod in census_of.items()}
        for i, subject in enumerate(XL_SUBJECTS):
            prompt = next(p for s_, p in REQUESTS if s_ == subject)
            t0 = time.perf_counter()
            ada = w.prepare_adaface_embeddings(images=faces[subject])
            img = w(prompt, num_inference_steps=steps, height=XL_HW, width=XL_HW,
                    generator=torch.Generator("cuda").manual_seed(gen_seed + i))
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            if ada is None or tuple(ada.shape) != (16, 768):
                raise AssertionError(f"request {i}: ada embeddings {ada}")
            images.append(img[0])
    counts = launch_counts()
    check_images(images, len(XL_SUBJECTS), XL_HW, "1024x1024 requests")
    if torch.equal(images[0], images[1]):
        raise AssertionError("two subjects gave the same image")
    w.prepare_adaface_embeddings(images=faces["a"])
    from torch.profiler import ProfilerActivity, profile

    def request():
        return w(REQUESTS[0][1], num_inference_steps=steps, height=XL_HW, width=XL_HW,
                 generator=torch.Generator("cuda").manual_seed(gen_seed))

    host = sync_ms(request)[1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        request()
        torch.cuda.synchronize()
    ops, dev = profile_report(prof, f"{w.pipeline_name} {XL_HW}x{XL_HW} request", top=8)
    return dict(counts=counts, seen=seen, latencies_ms=[x * 1e3 for x in latencies],
                host_ms=host, device_ms=dev, operations=ops, images=images)


def check_module_call(module, args: tuple, kwargs: dict, what: str) -> dict:
    """One call kernels against plain (relative L2 <= UNET_REL_TOL) with its
    launches and GroupNorm census, and the call's device time both ways."""
    from adaface_tpu_torch.ops import _build

    with torch.inference_mode():
        _build.reset_launch_counts()
        with gn_census(module) as seen:
            out = module(*args, **kwargs).float()
        torch.cuda.synchronize()
        counts = launch_counts()
        with plain_versions():
            ref = module(*args, **kwargs).float()
            plain_ms = median_ms(lambda: module(*args, **kwargs), reps=3, warmup=1)
        ms = median_ms(lambda: module(*args, **kwargs), reps=3, warmup=1)
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: output not finite")
    rel = ((out - ref).norm() / ref.norm()).item()
    log(f"{what}: kernels against plain rel L2 {rel:.3e} (bound {UNET_REL_TOL:g}); a call "
        f"{ms:.1f} ms with the kernels, {plain_ms:.1f} ms plain; launches {counts}")
    if not rel <= UNET_REL_TOL:
        raise AssertionError(f"{what}: kernels against plain rel L2 {rel} above bound")
    return dict(rel=rel, ms=ms, plain_ms=plain_ms, counts=counts, seen=seen)


def serve_sdxl(encoder, faces, card: str) -> dict:
    """The SDXL pipeline at full width (SDXL-base's UNet, CLIP-L and OpenCLIP
    bigG, the VAE; random bf16 weights from their own seed) through
    `AdaFaceWrapper("sdxl")` with the phase-5 encoder: one UNet call at CFG
    batch 2 on a 128x128 latent kernels against plain (140 flash launches on
    the D 64 instance, the GroupNorms of its census), then one 1024x1024,
    25-step Euler request for each of two subjects (guidance 5.0), held to
    the launches their UNet calls and decodes predict: no wide-kernel launch
    but the VAE's."""
    from adaface_tpu_torch.inference.sdxl_pipeline import SDXLPipelineModules
    from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.text.tokenizer import default_tokenizer

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    m = SDXLPipelineModules.random_init(gen, "cuda", torch.bfloat16, tokenizer=default_tokenizer())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    per_call = 2 * transformer_blocks(m.unet)
    if per_call != sum(SDXL_FLASH_PER_CALL.values()):
        raise AssertionError(f"SDXL UNet: {per_call} attentions a call")
    hw = XL_HW // 8
    x = torch.randn((2, 4, hw, hw), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.full((2,), 501, dtype=torch.long, device="cuda")
    ctx = torch.randn((2, 77, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    added = {"text_embeds": torch.randn((2, 1280), generator=gen, device="cuda").to(
        torch.bfloat16), "time_ids": torch.tensor([[XL_HW, XL_HW, 0, 0, XL_HW, XL_HW]] * 2,
                                                  dtype=torch.float32, device="cuda")}
    call = check_module_call(m.unet, (x, t, ctx), dict(added_cond=added),
                             "sdxl UNet call CFG batch 2 128x128")
    want = collections.Counter({A.FLASH_T: per_call}) + gn_expected_from(call["seen"])
    if {k: v for k, v in call["counts"].items() if v} != dict(want):
        raise AssertionError(f"sdxl UNet call: launches {call['counts']}, expected {dict(want)}")
    expect_census(call["seen"], sdxl=1)

    w = AdaFaceWrapper("sdxl", m, encoder, guidance_scale=5.0, num_inference_steps=XL_STEPS)
    r = serve_xl_requests(w, faces, XL_STEPS, 300, {"unet": m.unet, "vae": m.vae})
    n = len(XL_SUBJECTS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    vae_split = A.flash_plan(torch.bfloat16, *FLASH_XL_CASES[-1][1:], sms).nsplit > 1
    want = collections.Counter({A.FLASH_T: n * XL_STEPS * per_call, A.FLASH_WIDE: n,
                                A.FLASH_COMBINE: n * vae_split})
    want.update(gn_expected_from(r["seen"]["unet"]) + gn_expected_from(r["seen"]["vae"]))
    want = {k: v for k, v in want.items() if v}
    expect_census(r["seen"]["unet"], sdxl=n * XL_STEPS)
    expect_census(r["seen"]["vae"], decode1024=n)
    if {k: v for k, v in r["counts"].items() if v} != want:
        raise AssertionError(f"sdxl requests: launches {r['counts']}, expected {want}")
    secs = time.perf_counter() - t_phase
    log(f"sdxl: modules built in {build_s:.1f} s; {n} requests 1024x1024 {XL_STEPS} Euler steps "
        f"guidance 5.0: latency {', '.join(f'{x:.1f}' for x in r['latencies_ms'])} ms; one more "
        f"{r['host_ms']:.1f} ms on the host, one profiled {r['device_ms']:.1f} ms of device time in "
        f"{r['operations']} operations; launches {r['counts']} (no wide-kernel launch at D 64: "
        f"{A.FLASH_WIDE} {r['counts'].get(A.FLASH_WIDE, 0)} = the {n} decodes); card {card}; "
        f"the phase {secs:.1f} s")
    out = dict(call={k: v for k, v in call.items() if k != "seen"}, build_s=build_s,
               counts=r["counts"], latencies_ms=r["latencies_ms"], host_ms=r["host_ms"],
               device_ms=r["device_ms"], operations=r["operations"], seconds=secs,
               flash_per_call=per_call)
    del w, m, r
    gc.collect()
    torch.cuda.empty_cache()
    return out


def draw_modulations_(mmdit, gen, std: float = MODULATION_STD) -> None:
    """The MMDiT's adaLN-zero modulations and head, 0 at the JAX init
    (velocity 0), drawn at N(0, std²): the smoke's velocity then depends on
    every block's attention and MLP."""
    from adaface_tpu_torch.core.params import normal_

    for lin in [mmdit.ada_out, mmdit.proj_out,
                *(x for blk in mmdit.blocks for x in (blk.ada_x, blk.ada_ctx))]:
        normal_(lin.weight, std, gen)


def serve_sd3(encoder, faces, card: str) -> dict:
    """The SD3 pipeline at full width (SD3-medium's MMDiT, CLIP-L and bigG
    with projections, the 16-channel VAE; random bf16 weights from their own
    seed, the modulations and head drawn off 0) through
    `AdaFaceWrapper("sd3")`: one MMDiT call at CFG batch 2 (4096 latent +
    333 context tokens) kernels against plain (24 joint attentions on the D
    64 instance), then one 1024x1024, 28-step rectified-flow request for
    each of two subjects (guidance 7.0, shift 3.0), held to the launches
    their MMDiT calls and decodes predict."""
    from adaface_tpu_torch.inference.sd3_pipeline import SD3PipelineModules
    from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.text.tokenizer import default_tokenizer

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    m = SD3PipelineModules.random_init(gen, "cuda", torch.bfloat16, tokenizer=default_tokenizer())
    draw_modulations_(m.mmdit, gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    cfg = m.mmdit.cfg
    hw = XL_HW // 8
    x = torch.randn((2, cfg.in_channels, hw, hw), generator=gen, device="cuda").to(
        torch.bfloat16)
    t = torch.full((2,), 700.0, device="cuda")
    ctx = torch.randn((2, 77 + m.t5_len, cfg.context_dim), generator=gen, device="cuda").to(
        torch.bfloat16)
    pooled = torch.randn((2, cfg.pooled_dim), generator=gen, device="cuda").to(torch.bfloat16)
    call = check_module_call(m.mmdit, (x, t, ctx, pooled), {},
                             "sd3 MMDiT call CFG batch 2 4429 tokens")
    if {k: v for k, v in call["counts"].items() if v} != {A.FLASH_T: cfg.depth}:
        raise AssertionError(f"sd3 MMDiT call: launches {call['counts']}")

    w = AdaFaceWrapper("sd3", m, encoder, guidance_scale=7.0, num_inference_steps=SD3_STEPS)
    r = serve_xl_requests(w, faces, SD3_STEPS, 310, {"vae": m.vae})
    n = len(XL_SUBJECTS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    vae_split = A.flash_plan(torch.bfloat16, *FLASH_XL_CASES[-1][1:], sms).nsplit > 1
    want = collections.Counter({A.FLASH_T: n * SD3_STEPS * cfg.depth, A.FLASH_WIDE: n,
                                A.FLASH_COMBINE: n * vae_split})
    want.update(gn_expected_from(r["seen"]["vae"]))
    want = {k: v for k, v in want.items() if v}
    expect_census(r["seen"]["vae"], decode1024=n)
    if {k: v for k, v in r["counts"].items() if v} != want:
        raise AssertionError(f"sd3 requests: launches {r['counts']}, expected {want}")
    secs = time.perf_counter() - t_phase
    log(f"sd3: modules built in {build_s:.1f} s; {n} requests 1024x1024 {SD3_STEPS} steps "
        f"guidance 7.0: latency {', '.join(f'{x:.1f}' for x in r['latencies_ms'])} ms; one more "
        f"{r['host_ms']:.1f} ms on the host, one profiled {r['device_ms']:.1f} ms of device time in "
        f"{r['operations']} operations; launches {r['counts']}; card {card}; the phase "
        f"{secs:.1f} s")
    out = dict(call={k: v for k, v in call.items() if k != "seen"}, build_s=build_s,
               counts=r["counts"], latencies_ms=r["latencies_ms"], host_ms=r["host_ms"],
               device_ms=r["device_ms"], operations=r["operations"], seconds=secs)
    del w, m, r
    gc.collect()
    torch.cuda.empty_cache()
    return out


VIDEO_STEPS = 25
MOTION_PROJ_OUT_STD = 0.1  # of fan-in^-1/2: `proj_out` drawn off its 0 so the frames interact
# one motion module in bf16 with the GroupNorm kernel against its fp32 plain
# computation, relative L2 of the temporal residual: about nine bf16
# roundings of the residual's chain (2^-9 each) through five norms and eight
# products of random weights
MOTION_REL_TOL = 3e-2
# (label, where, C, H = W): the motion modules held against plain, at the
# clip's batch 32
MOTION_CHECKS = [("motion 64x64 320", "down.0.0", 320, 64), ("motion 8x8 1280", "mid", 1280, 8)]
# (C, H = W, modules a video UNet call) of the motion modules
MOTION_LEVELS = [(320, 64, 5), (640, 32, 5), (1280, 16, 5), (1280, 8, 6)]


def motion_module(motion, where: str):
    """`motion.down[0][0]` for "down.0.0", `motion.mid` for "mid"."""
    m = motion
    for part in where.split("."):
        m = m[int(part)] if part.isdigit() else getattr(m, part)
    return m


def check_motion_module(mm, x, what: str) -> dict:
    """One motion module on x (bf16, channels-last, batch 2 x 16 frames) with
    the GroupNorm kernel against the same module in fp32 on the plain
    versions: the relative L2 of the temporal residual (output - x), and the
    module's launches (one GroupNorm; the temporal attention is plain)."""
    from adaface_tpu_torch.ops import _build

    ref_mm = copy.deepcopy(mm).float()
    with torch.inference_mode():
        _build.reset_launch_counts()
        out = mm(x, VIDEO_FRAMES)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        with plain_versions():
            ref = ref_mm(x.float(), VIDEO_FRAMES)
        ms = median_ms(lambda: mm(x, VIDEO_FRAMES), reps=5)
    res, ref_res = out.float() - x.float(), ref - x.float()
    rel = ((res - ref_res).norm() / ref_res.norm()).item()
    scale = (ref_res.norm() / x.float().norm()).item()
    log(f"{what} {tuple(x.shape)}: temporal residual kernels (bf16) against plain (fp32) rel L2 "
        f"{rel:.3e} (bound {MOTION_REL_TOL:g}); the residual {scale:.3e} of the input's norm; "
        f"a call {ms:.3f} ms; launches {counts}")
    if not (torch.isfinite(out).all() and rel <= MOTION_REL_TOL and scale > 0):
        raise AssertionError(f"{what}: kernels against plain rel L2 {rel} (residual {scale})")
    del ref_mm
    return dict(rel=rel, residual=scale, ms=ms, counts=counts)


class VideoUNet(torch.nn.Module):
    """A UNet with its motion modules at `num_frames`, as one module (so a
    GroupNorm census sees both)."""

    def __init__(self, unet, motion, num_frames: int):
        super().__init__()
        self.unet, self.motion, self.num_frames = unet, motion, num_frames

    def forward(self, x, t, ctx):
        return self.unet(x, t, ctx, motion=self.motion, num_frames=self.num_frames)


def motion_breakdown(motion, gen) -> dict:
    """Device ms (20 calls in a CUDA graph) of a motion module, one temporal
    attention (its LayerNorm, q/k/v, plain attention, o), the plain attention
    alone and one LayerNorm, at each level's shape at batch 32, and their
    sums over a video UNet call's 21 modules."""
    from adaface_tpu_torch.models.motion import MotionModule
    from adaface_tpu_torch.ops.attention import scaled_dot_product_attention

    per_call = collections.Counter()
    rows = {}
    b = 2
    with torch.inference_mode():
        for c, hw, n in MOTION_LEVELS:
            mm = next(m for m in motion.modules()
                      if isinstance(m, MotionModule) and m.proj_in.in_features == c)
            x = torch.randn((b * VIDEO_FRAMES, c, hw, hw), generator=gen, device="cuda").to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            y = torch.randn((b * hw * hw, VIDEO_FRAMES, c), generator=gen, device="cuda").to(
                torch.bfloat16)
            pe = mm.position_table(VIDEO_FRAMES, torch.bfloat16)
            attn = mm.blocks[0].attn[0]
            heads = mm.cfg.num_heads
            q, k, v = (t.reshape(b * hw * hw, VIDEO_FRAMES, heads, c // heads).transpose(1, 2)
                       for t in attn.qkv(y).split(c, dim=-1))
            r = dict(module=graph_ms(lambda: mm(x, VIDEO_FRAMES)),
                     attention=graph_ms(lambda: attn(y, pe, heads)),
                     sdpa=graph_ms(lambda: scaled_dot_product_attention(q, k, v)),
                     layer_norm=graph_ms(lambda: attn.norm(y)))
            rows[f"{c}x{hw}x{hw}"] = r
            # per module: 2 attentions (2 LayerNorms) and the feed-forward's LayerNorm
            for key, times in (("module", 1), ("attention", 2), ("sdpa", 2), ("layer_norm", 3)):
                per_call[key] += n * times * r[key]
            log(f"motion module {c}x{hw}x{hw} batch {b * VIDEO_FRAMES} (device ms, 20 calls in a "
                f"CUDA graph): the module {r['module']:.3f}, a temporal attention "
                f"{r['attention']:.3f} (its plain attention {r['sdpa']:.3f}), a LayerNorm "
                f"{r['layer_norm']:.3f}; {n} modules a UNet call")
            del x, y, q, k, v
    log("motion modules per video UNet call (21 modules, device ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_call.items()))
    return dict(levels=rows, per_call=dict(per_call))


def serve_video(wrapper, faces, card: str) -> dict:
    """The text-to-video path (AdaFace-Animate) on the phase-5 SD1.5 modules
    with the full MM_SD15_V2 motion modules (453 M parameters, random bf16
    from their own seed): the zero-`proj_out` video UNet call equal to the
    image UNet bit for bit; `proj_out` drawn off 0; two motion modules
    against fp32 plain; one video UNet call at one video of 16 frames (batch
    16) kernels against plain; then one 16-frame, 512x512, 25-step clip
    (guidance 6.0) through `AdaFaceWrapper("text2video")` after a 2-step
    warm-up clip, held to the launches of 25 UNet calls at CFG batch 32 and
    two decodes of 8 frames; one more clip profiled; the motion modules'
    device time by part."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from adaface_tpu_torch.core.params import build, normal_
    from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
    from adaface_tpu_torch.models.motion import (MM_SD15_V2, MotionModule, MotionModules,
                                                 init_motion_weights_)
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops.fused_gn import GN_FUSED, GN_NORM, GN_STATS

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    m = wrapper.pipeline.m
    unet = m.unet
    motion = build(lambda: MotionModules(unet.cfg, MM_SD15_V2), "cuda", torch.bfloat16,
                   init_motion_weights_, gen)
    modules = [mm for mm in motion.modules() if isinstance(mm, MotionModule)]
    n_params = sum(p.numel() for p in motion.parameters())
    if len(modules) != sum(n for *_, n in MOTION_LEVELS):
        raise AssertionError(f"motion: {len(modules)} modules")
    f = VIDEO_FRAMES
    x = torch.randn((f, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.full((f,), 501, dtype=torch.long, device="cuda")
    ctx = torch.randn((f, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        image_eps = unet(x, t, ctx)
        zero_eps = unet(x, t, ctx, motion=motion, num_frames=f)
    # proj_out is 0 at init: each module adds exactly 0 to its input
    if not torch.equal(zero_eps, image_eps):
        raise AssertionError("video UNet with zero proj_out differs from the image UNet: "
                             f"max {(zero_eps - image_eps).abs().max().item()}")
    log(f"video: {len(modules)} motion modules, {n_params} parameters; zero proj_out: the video "
        f"UNet call (1 video x {f} frames) equals the image UNet's bit for bit")
    for mm in modules:
        normal_(mm.proj_out.weight, MOTION_PROJ_OUT_STD * mm.proj_out.in_features ** -0.5, gen)

    checks = {}
    for label, where, c, hw in MOTION_CHECKS:
        xm = torch.randn((2 * f, c, hw, hw), generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        checks[label] = check_motion_module(motion_module(motion, where), xm, label)
        del xm
    call = check_module_call(VideoUNet(unet, motion, f), (x, t, ctx), {},
                             f"video UNet call 1 video x {f} frames 64x64")
    want = collections.Counter({A.FLASH_T: 20, A.FLASH_STD: 10}) + gn_expected_from(call["seen"])
    if {k: v for k, v in call["counts"].items() if v} != dict(want):
        raise AssertionError(f"video UNet call: launches {call['counts']}, expected {dict(want)}")
    expect_census(call["seen"], video16=1)
    with torch.inference_mode():
        moved = ((unet(x, t, ctx, motion=motion, num_frames=f).float() - image_eps.float()).norm()
                 / image_eps.float().norm()).item()
    log(f"video: the video UNet call {moved:.3e} (relative L2) from the image UNet's once "
        f"proj_out is drawn")
    del image_eps, zero_eps

    w = AdaFaceWrapper("text2video", m, wrapper.id2ada_prompt_encoder, guidance_scale=6.0,
                       num_inference_steps=VIDEO_STEPS, motion=motion)
    prompt = REQUESTS[0][1]
    w.prepare_adaface_embeddings(images=faces["a"])
    t0 = time.perf_counter()
    w(prompt, num_frames=f, num_inference_steps=2, generator=torch.Generator("cuda").manual_seed(400))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    decode_plan = A.flash_plan(torch.bfloat16, *FLASH_VIDEO_CASES[-1][1:], sms)
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with gn_census(unet) as seen_unet, gn_census(motion) as seen_motion, \
            gn_census(m.vae) as seen_vae:
        t0 = time.perf_counter()
        ada = w.prepare_adaface_embeddings(images=faces["a"])
        clip = w(prompt, num_frames=f, generator=torch.Generator("cuda").manual_seed(401))
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if ada is None or tuple(ada.shape) != (16, 768):
        raise AssertionError(f"video: ada embeddings {ada}")
    seen = seen_unet + seen_motion
    expect_census(seen, video=VIDEO_STEPS)
    decodes = -(-f // VIDEO_DECODE_CHUNK)
    expect_census(seen_vae, decode8=decodes)
    want = collections.Counter({A.FLASH_T: 20 * VIDEO_STEPS, A.FLASH_STD: 10 * VIDEO_STEPS,
                                A.FLASH_WIDE: decodes,
                                A.FLASH_COMBINE: decodes * (decode_plan.nsplit > 1)})
    want.update(gn_expected_from(seen) + gn_expected_from(seen_vae))
    want = {k: v for k, v in want.items() if v}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"video clip: launches {counts}, expected {want}")
    frames = clip[0]
    if tuple(clip.shape) != (1, f, 3, 512, 512) or not torch.isfinite(clip).all():
        raise AssertionError(f"video clip {tuple(clip.shape)} not finite or misshaped")
    if clip.min() < 0.0 or clip.max() > 1.0:
        raise AssertionError("video clip outside [0, 1]")
    steps_apart = (frames[1:] - frames[:-1]).abs().mean(dim=(1, 2, 3))
    if not (steps_apart > 0).all():
        raise AssertionError(f"video clip: consecutive frames equal: {steps_apart.tolist()}")
    # the GIF stays for `eval_videos`, which reads it and removes its folder
    gif_path = w.pipeline.to_gif(frames, os.path.join(tempfile.mkdtemp(), "clip.gif"))
    gif_bytes = os.path.getsize(gif_path)
    frames_u8 = (frames.float().cpu().numpy() * 255).astype(np.uint8).transpose(0, 2, 3, 1)
    gn_by_kernel = {}
    for (shape, eps, silu), n in sorted((seen + seen_vae).items()):
        kernel = GN_FUSED if gn_expected_from({(shape, eps, silu): 1}).get(GN_FUSED) else \
            f"{GN_STATS} + {GN_NORM}"
        gn_by_kernel[f"{shape} eps {eps:g} silu {silu}"] = (n, kernel)
    log(f"video: a 16-frame 512x512 {VIDEO_STEPS}-step clip (UNet batch {2 * f} with CFG, "
        f"decodes of {VIDEO_DECODE_CHUNK} frames: the D 512 flash at B{VIDEO_DECODE_CHUNK} "
        f"{decode_plan.variant} splits {decode_plan.nsplit}): latency {latency * 1e3:.1f} ms "
        f"(2-step warm-up clip {warm_s:.1f} s), peak memory {peak:.2f} GiB; frames "
        f"{tuple(frames.shape)} in [{clip.min().item():.4f}, {clip.max().item():.4f}], mean "
        f"|frame i+1 - frame i| {steps_apart.min().item():.4f}..{steps_apart.max().item():.4f} "
        f"(mean {steps_apart.mean().item():.4f}); GIF {gif_bytes} bytes; launches {counts}")
    log("video: GroupNorms of the clip by shape (calls, kernel): "
        + "; ".join(f"{k}: {n} {kern}" for k, (n, kern) in gn_by_kernel.items()))

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w(prompt, num_frames=f, generator=torch.Generator("cuda").manual_seed(402))
        torch.cuda.synchronize()
    ops, dev = profile_report(prof, f"text2video {f}x512x512 clip", top=12)
    breakdown = motion_breakdown(motion, gen)
    with torch.inference_mode():
        xb = torch.randn((2 * f, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
        tb = torch.full((2 * f,), 501, dtype=torch.long, device="cuda")
        cb = torch.randn((2 * f, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
        # in turns: video, image, image, video
        turns = [median_ms(lambda: unet(xb, tb, cb, **kw), reps=3, warmup=1)
                 for kw in (dict(motion=motion, num_frames=f), {}, {},
                            dict(motion=motion, num_frames=f))]
    secs = time.perf_counter() - t_phase
    log(f"video: a UNet call at batch {2 * f} {min(turns[0], turns[3]):.1f} ms with its motion "
        f"modules, {min(turns[1], turns[2]):.1f} ms without; a clip {dev:.1f} ms of device time in "
        f"{ops} operations, its motion modules {VIDEO_STEPS * breakdown['per_call']['module']:.1f}"
        f" ms (temporal attentions {VIDEO_STEPS * breakdown['per_call']['attention']:.1f}, their "
        f"plain attention {VIDEO_STEPS * breakdown['per_call']['sdpa']:.1f}, LayerNorms "
        f"{VIDEO_STEPS * breakdown['per_call']['layer_norm']:.1f}); card {card}; the phase "
        f"{secs:.1f} s")
    out = dict(counts=counts, latency_ms=latency * 1e3, peak_gib=peak, device_ms=dev,
               operations=ops, gif_bytes=gif_bytes, gif_path=gif_path, frames_u8=frames_u8,
               frame_step=steps_apart.tolist(),
               modules=checks, call={k: v for k, v in call.items() if k != "seen"},
               moved=moved, unet_ms=turns, breakdown=breakdown, seconds=secs)
    del w, motion, clip, frames
    gc.collect()
    torch.cuda.empty_cache()
    return out


EVAL_VIDEO_FRAMES = 8  # frames sampled a clip: `eval_videos.py`'s default


def eval_videos(video: dict, faces, card: str) -> dict:
    """`scripts/eval_videos_torch.py` on the GIF `serve_video` wrote (16
    frames at 512x512): the host library's GIF decoder
    (`utils/image.read_gif_frames`) gives the writer's palette quantization
    of the frames the pipeline produced, bit for bit, each channel within
    half a palette level of them; `sample_frames` picks by motion; their
    face similarity to subject a's photos is scored on the card (RetinaFace
    + ArcFace, random weights from their seed, the detector's BN statistics
    fitted to the photos as in `evaluate_and_tools`) and its row written as
    the script writes it; the host ms of the decode and the seconds of the
    scoring."""
    import csv
    import shutil

    from adaface_tpu_torch import native
    from adaface_tpu_torch.evaluation.eval_utils import append_score_row
    from adaface_tpu_torch.evaluation.face_sim import compare_face_images, make_face_backend
    from adaface_tpu_torch.utils.image import (GIF_LEVELS, _gif_indices, gif_palette,
                                               read_gif_frames)

    t_phase = time.perf_counter()
    path, produced = video["gif_path"], video["frames_u8"]
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import eval_videos_torch

        t0 = time.perf_counter()
        native.load_library()  # built at first use
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = read_gif_frames(path)
        decode_ms = (time.perf_counter() - t0) * 1e3
        want = gif_palette()[np.stack([_gif_indices(f) for f in produced])]
        err = np.abs(decoded.astype(np.int16) - produced.astype(np.int16)).max(axis=(0, 1, 2))
        half = [255.0 / (n - 1) / 2 for n in GIF_LEVELS]
        if decoded.shape != (VIDEO_FRAMES, 512, 512, 3) or not np.array_equal(decoded, want) \
                or any(e > h + 0.5 for e, h in zip(err.tolist(), half)):
            raise AssertionError(f"eval videos: decoded {decoded.shape}, per-channel error "
                                 f"{err.tolist()} (half a level {half})")
        t0 = time.perf_counter()
        sampled = eval_videos_torch.sample_frames(path, EVAL_VIDEO_FRAMES)
        sample_ms = (time.perf_counter() - t0) * 1e3
        if not 1 <= len(sampled) <= EVAL_VIDEO_FRAMES:
            raise AssertionError(f"eval videos: {len(sampled)} frames sampled")
        face = make_face_backend("retinaface_arcface", "cuda",
                                 torch.Generator(device="cuda").manual_seed(SEED + 24))
        photos = np.stack([im[..., ::-1].astype(np.float32) - face.client.BGR_MEAN
                           for im in faces["a"]])
        calibrate_batch_norms(face.client.model, torch.from_numpy(
            np.ascontiguousarray(photos.transpose(0, 3, 1, 2))).to("cuda"))
        t0 = time.perf_counter()
        scores = compare_face_images(sampled, faces["a"], face)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        csv_path = os.path.join(os.path.dirname(path), "scores.csv")
        append_score_row(csv_path, {"video": os.path.basename(path), **scores})
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        sim = scores["face_sim"]
        if scores["n_faces_b"] == 0 or len(rows) != 1 or (
                scores["n_faces_a"] and not -1.0 <= sim <= 1.0):
            raise AssertionError(f"eval videos: scores {scores}, CSV rows {rows}")
    finally:
        sys.path.remove(str(REPO / "scripts"))
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"eval videos: the {video['gif_bytes']}-byte GIF decoded to {decoded.shape} in "
        f"{decode_ms:.1f} ms of host (the host library loaded in {build_s:.1f} s), the writer's "
        f"palette quantization of the clip bit for bit (per-channel error {err.tolist()}, half "
        f"a level {[round(h, 2) for h in half]}); {len(sampled)} frames sampled by motion in "
        f"{sample_ms:.1f} ms; face similarity {sim} ({scores['n_faces_a']} / "
        f"{scores['n_faces_b']} faces) scored in {score_s:.2f} s on the card; card {card}; the "
        f"phase {secs:.1f} s")
    return dict(decode_ms=decode_ms, sample_ms=sample_ms, score_s=score_s, scores=scores,
                err=err.tolist(), seconds=secs)


# one SD1.5 request of a fresh server (`build_server` from SEED, subject a's
# photos, the first prompt, generator seed 100, 512x512, 25 steps: the
# request of `chip_compare.py --sd15-bits`): the SHA-256 of its fp32 pixels
# as the tree before the video path gave them (the parent of the commit that
# added the motion branch, `chip_compare.py --sd15-bits` on one H100), and
# where
SD15_BITS = dict(sha256="504fd39b3c6f9882f5efb448cc43083585ee2a52baa21172968108e19231d4a2",
                 torch="2.11.0+cu128", cuda="12.8", card="NVIDIA H100 80GB HBM3")


def check_sd15_bits(card: str) -> dict:
    """That request's bits against SD15_BITS, where torch, CUDA and the card
    are the recorded ones (elsewhere the digest is printed, not compared)."""
    import hashlib

    w, faces = build_server(torch.Generator(device="cuda").manual_seed(SEED))
    w.prepare_adaface_embeddings(images=faces["a"])
    img = w(REQUESTS[0][1], generator=torch.Generator("cuda").manual_seed(100))
    digest = hashlib.sha256(img.float().cpu().numpy().tobytes()).hexdigest()
    env = dict(torch=torch.__version__, cuda=torch.version.cuda,
               card=torch.cuda.get_device_name(0))
    same_env = all(SD15_BITS[k] == v for k, v in env.items())
    log(f"sd15 bits: the request's SHA-256 {digest}; the parent's {SD15_BITS['sha256']} "
        f"({'compared' if same_env else 'NOT COMPARED: recorded under ' + str(SD15_BITS)}; "
        f"here {env}); card {card}")
    if same_env and digest != SD15_BITS["sha256"]:
        raise AssertionError(f"the SD1.5 request's bits differ from the parent's: {digest}")
    del w
    gc.collect()
    torch.cuda.empty_cache()
    # in the kernels line too, so that a check left uncompared shows there
    return dict(compared=same_env, sha256=digest, parent_sha256=SD15_BITS["sha256"],
                recorded_under={k: SD15_BITS[k] for k in env}, here=env)


def run_tools(card: str) -> dict:
    """The host tools' twins once on the card: `scripts/flow_tool_torch.py`
    (the random GMA between a 256x256 photo and itself shifted by 4 pixels,
    6 iterations) and `scripts/ckpt_tool_torch.py check` on a state dict of
    the flow written as `.safetensors`."""
    import tempfile

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "scripts"))
    try:
        import ckpt_tool_torch
        import flow_tool_torch
    finally:
        sys.path.pop(0)
    from adaface_tpu_torch.tools.ckpt_lib import save_state_dict
    from adaface_tpu_torch.utils.image import write_png

    t0 = time.perf_counter()
    img = np.random.RandomState(SEED).randint(0, 256, (256, 260, 3)).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        write_png(os.path.join(d, "a.png"), img[:, :256])
        write_png(os.path.join(d, "b.png"), img[:, 4:])
        flow = flow_tool_torch.main([os.path.join(d, "a.png"), os.path.join(d, "b.png"), "--out",
                                     os.path.join(d, "flow.png"), "--size", "256"])
        save_state_dict({"flow": flow}, os.path.join(d, "flow.safetensors"))
        ckpt_tool_torch.main(["check", os.path.join(d, "flow.safetensors")])
    if flow.shape != (256, 256, 2) or not np.isfinite(flow).all():
        raise AssertionError(f"flow tool: flow {flow.shape} not finite or misshaped")
    secs = time.perf_counter() - t0
    log(f"tools: flow_tool_torch and ckpt_tool_torch check on the card in {secs:.1f} s; card "
        f"{card}")
    return dict(seconds=secs)


# ---------------------------------------------------------------------------
# the evaluation harness, the face-mask, face-parsing and makeup tools and
# the demo server on the SD1.5 serving path
# ---------------------------------------------------------------------------

EVAL_PROMPTS = 2  # the first dreambench prompts
EVAL_SAMPLES = 4  # images a prompt: UNet batch 8 with CFG
EVAL_STEPS = 25
SCORE_TOL = 1e-4  # each cosine score, card against CPU (fp32, TF32 off on both)
MAKEUP = {"hair": (100, 200, 100), "upper_lip": (230, 50, 20), "lower_lip": (230, 50, 20)}
APP_IMAGES = 2  # images asked of the demo's POST


def rebatched_census(path: str, batch: int, calls: int) -> dict:
    """GN_CASES' GroupNorms of `calls` calls of `path` (one batch-2 UNet
    call, one batch-1 decode) with the batch dimension set to `batch`."""
    want = collections.Counter()
    for _, shape, _, eps, silu, by_path in GN_CASES:
        if by_path.get(path):
            want[((batch,) + shape[1:], eps, silu)] += by_path[path] * calls
    return dict(want)


class CropRecorder:
    """RetinaFace + ArcFace on the card, each call's face crop (or None)
    kept: the crops the CPU's ArcFace then embeds."""

    def __init__(self, backend):
        self.backend = backend
        self.crops: list = []

    def detect_and_embed(self, image_np):
        faces = self.backend.client.detect_faces(image_np)
        crop = None
        if faces:
            x0, y0, x1, y1 = (int(v) for v in faces[0]["bbox"])
            crop = image_np[max(y0, 0):y1, max(x0, 0):x1]
            crop = crop if crop.size else None
        self.crops.append(crop)
        return None if crop is None else self.backend.arc.detect_and_embed(crop)


def post_multipart(port: int, files: list, fields: dict) -> tuple[int, str]:
    """POST /generate of the demo with `files` [(name, bytes)] and `fields`."""
    import http.client

    boundary = "----chip-smoke-boundary"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="images"; filename="{n}"'
             f"\r\nContent-Type: application/octet-stream\r\n\r\n".encode() + data + b"\r\n"
             for n, data in files]
    parts += [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
              .encode() for k, v in fields.items()]
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/generate", body=body,
                 headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    resp = conn.getresponse()
    out = resp.status, resp.read().decode()
    conn.close()
    return out


def evaluate_and_tools(wrapper, faces, card: str) -> dict:
    """The evaluation harness and the tools on the phase-5 SD1.5 wrapper:
    one UNet call at the eval batch (8: 4 samples with CFG) kernels against
    plain; `txt2img_eval_torch`'s generation of EVAL_PROMPTS dreambench
    prompts × EVAL_SAMPLES samples at 512x512, 25 steps, held to the
    launches of 50 UNet calls at batch 8 and 2 decodes at batch 4, the PNGs
    read back; its scores (CLIP-T / CLIP-I on ViT-B/32, DINO ViT-S/16, face
    similarity on RetinaFace + ArcFace, random from their seeds) against
    subject a's photos with the CSV written; the same evaluators copied to
    the CPU scoring the same PNGs, each cosine within SCORE_TOL (face
    similarity on the card's face crops: detection is held in
    `serve_joint`); `gen_face_masks_torch` on a folder of JPEG and PNG
    photos; BiSeNet parsing and `apply_makeup` (pixels off the recoloured
    parts equal to the input, and `makeup_demo_torch` giving the same
    image); the demo server of `app_torch` on a free port in a thread: GET
    / and a POST of two photos answered with APP_IMAGES 512x512 PNGs."""
    import base64
    import csv
    import http.client
    import shutil
    import tempfile
    import threading

    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import app_torch
        import gen_face_masks_torch
        import makeup_demo_torch
        import txt2img_eval_torch
    finally:
        del sys.path[:2]
    from adaface_tpu_torch import native
    from adaface_tpu_torch.evaluation.clip_eval import CLIPEvaluator
    from adaface_tpu_torch.evaluation.dino_eval import DINOEvaluator
    from adaface_tpu_torch.evaluation.eval_utils import compare_folders
    from adaface_tpu_torch.evaluation.face_sim import (calc_faces_similarities,
                                                       load_folder_images, make_face_backend)
    from adaface_tpu_torch.id2ada.face_backends import ArcFaceBackend
    from adaface_tpu_torch.models.bisenet import load_bisenet
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.utils.image import (decode_png, encode_png, read_image, to_rgb,
                                               write_png)
    from adaface_tpu_torch.utils.makeup import MAKEUP_PARTS, apply_makeup

    t_phase = time.perf_counter()
    secs = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    m = wrapper.pipeline.m
    b = 2 * EVAL_SAMPLES
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        # the kernels at the eval batch: one UNet call against its plain version
        t0 = time.perf_counter()
        x = torch.randn((b, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
        t = torch.full((b,), 501, dtype=torch.long, device="cuda")
        ctx = torch.randn((b, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
        call = check_module_call(m.unet, (x, t, ctx), {}, f"eval UNet call batch {b} 64x64")
        want = collections.Counter({A.FLASH_T: 20, A.FLASH_STD: 10}) + gn_expected_from(
            call["seen"])
        if {k: v for k, v in call["counts"].items() if v} != dict(want):
            raise AssertionError(f"eval UNet call: launches {call['counts']}, expected {want}")
        if dict(call["seen"]) != rebatched_census("unet", b, 1):
            raise AssertionError(f"eval UNet call: GroupNorms {dict(call['seen'])}")
        del x, t, ctx
        secs["unet call"] = time.perf_counter() - t0

        # the eval run: generation through txt2img_eval_torch's functions
        subject = os.path.join(root, "subject_a")
        os.makedirs(subject)
        for i, im in enumerate(faces["a"]):
            write_png(os.path.join(subject, f"{i}.png"), im)
        prompts = txt2img_eval_torch.select_prompts("dreambench", f"0-{EVAL_PROMPTS - 1}")
        wrapper.prepare_adaface_embeddings(images=faces["a"])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        decode_plan = A.flash_plan(torch.bfloat16, EVAL_SAMPLES, 1, 4096, 4096, 512, sms)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with gn_census(m.unet) as seen_unet, gn_census(m.vae) as seen_vae:
            dirs = txt2img_eval_torch.generate(wrapper, prompts, os.path.join(root, "out"),
                                               EVAL_SAMPLES, 512, SEED, EVAL_STEPS)
        torch.cuda.synchronize()
        secs["generate"] = time.perf_counter() - t0
        counts = launch_counts()
        calls = EVAL_PROMPTS * EVAL_STEPS
        if dict(seen_unet) != rebatched_census("unet", b, calls):
            raise AssertionError(f"eval run: UNet GroupNorms {dict(seen_unet)}")
        if dict(seen_vae) != rebatched_census("decode", EVAL_SAMPLES, EVAL_PROMPTS):
            raise AssertionError(f"eval run: decoder GroupNorms {dict(seen_vae)}")
        want = collections.Counter({A.FLASH_T: 20 * calls, A.FLASH_STD: 10 * calls,
                                    A.FLASH_WIDE: EVAL_PROMPTS,
                                    A.FLASH_COMBINE: EVAL_PROMPTS * (decode_plan.nsplit > 1)})
        want.update(gn_expected_from(seen_unet) + gn_expected_from(seen_vae))
        want = {k: v for k, v in want.items() if v}
        if {k: v for k, v in counts.items() if v} != want:
            raise AssertionError(f"eval run: launches {counts}, expected {want}")
        t0 = time.perf_counter()
        for d, _ in dirs:
            back = load_folder_images(d)
            check_images([torch.from_numpy(im).permute(2, 0, 1).float() / 255 for im in back],
                         EVAL_SAMPLES, 512, f"eval PNGs {d}")
        secs["read back"] = time.perf_counter() - t0
        log(f"eval: {EVAL_PROMPTS} dreambench prompts x {EVAL_SAMPLES} samples, 512x512, "
            f"{EVAL_STEPS} steps (UNet batch {b} with CFG, decodes at batch {EVAL_SAMPLES}: the "
            f"D 512 flash {decode_plan.variant} splits {decode_plan.nsplit}): "
            f"{secs['generate']:.2f} s, {EVAL_PROMPTS * EVAL_SAMPLES / secs['generate']:.3f} "
            f"imgs/sec; PNGs written and read back; launches {counts}")

        # the scores on the card, the CSV written
        t0 = time.perf_counter()
        clip_ev = CLIPEvaluator("cuda", torch.Generator(device="cuda").manual_seed(SEED + 21))
        dino_ev = DINOEvaluator("cuda", torch.Generator(device="cuda").manual_seed(SEED + 22))
        face = make_face_backend("retinaface_arcface", "cuda",
                                 torch.Generator(device="cuda").manual_seed(SEED + 23))
        photos = np.stack([im[..., ::-1].astype(np.float32) - face.client.BGR_MEAN
                           for im in faces["a"]])
        calibrate_batch_norms(face.client.model, torch.from_numpy(
            np.ascontiguousarray(photos.transpose(0, 3, 1, 2))).to("cuda"))
        recorder = CropRecorder(face)
        csv_path = os.path.join(root, "scores.csv")
        rows, crops = [], []
        for d, prompt in dirs:
            recorder.crops = []
            rows += txt2img_eval_torch.score([(d, prompt)], "a", subject, subject, clip_ev,
                                             dino_ev, recorder, csv_path)
            crops.append(recorder.crops)
        torch.cuda.synchronize()
        secs["score card"] = time.perf_counter() - t0
        with open(csv_path) as f:
            table = list(csv.DictReader(f))
        cols = ["subject", "prompt", "dir", "n_samples", "n_gt", "clip_t", "clip_i", "dino",
                "face_sim", "n_faces_a", "n_faces_b"]
        if len(table) != EVAL_PROMPTS or list(table[0]) != cols:
            raise AssertionError(f"eval CSV: {len(table)} rows, columns {list(table[0])}")
        for row in table:
            log(f"eval CSV: {row['prompt']!r}: CLIP-T {row['clip_t']}, CLIP-I {row['clip_i']}, "
                f"DINO {row['dino']}, face sim {row['face_sim']} ({row['n_faces_a']} / "
                f"{row['n_faces_b']} faces)")
            scores = [float(row[k]) for k in ("clip_t", "clip_i", "dino")]
            if not all(-1.0 <= s <= 1.0 for s in scores):
                raise AssertionError(f"eval CSV: scores {scores} outside [-1, 1]")

        # the same PNGs scored on the CPU by the same weights
        t0 = time.perf_counter()
        clip_cpu, dino_cpu = clip_ev.to("cpu"), dino_ev.to("cpu")
        arc_cpu = ArcFaceBackend(on_cpu(face.arc.arcface))
        worst = {}
        for (d, prompt), row, crop_list in zip(dirs, rows, crops):
            cpu = compare_folders(d, subject, prompt=prompt, clip_evaluator=clip_cpu,
                                  dino_evaluator=dino_cpu)
            embs = [None if c is None else arc_cpu.detect_and_embed(c) for c in crop_list]
            ea = [e for e in embs[:row["n_samples"]] if e is not None]
            eb = [e for e in embs[row["n_samples"]:] if e is not None]
            cpu["face_sim"] = calc_faces_similarities(
                np.stack(ea) if ea else np.zeros((0, 512)), np.stack(eb) if eb else
                np.zeros((0, 512)))
            for k in ("clip_t", "clip_i", "dino", "face_sim"):
                if math.isnan(row[k]) and math.isnan(cpu[k]):
                    continue
                worst[k] = max(worst.get(k, 0.0), abs(row[k] - cpu[k]))
        secs["score cpu"] = time.perf_counter() - t0
        log(f"eval: card against CPU on the same PNGs and weights (fp32, TF32 off): largest "
            f"|score difference| {', '.join(f'{k} {v:.3e}' for k, v in worst.items())} "
            f"(bound {SCORE_TOL:g}; face similarity on the card's face crops)")
        if len(worst) < 3 or not max(worst.values()) <= SCORE_TOL:
            raise AssertionError(f"eval scores card against CPU: {worst}")
        del clip_cpu, dino_cpu, arc_cpu

        # the face-mask tool on a folder of JPEG and PNG photos
        t0 = time.perf_counter()
        folder = os.path.join(root, "masks")
        os.makedirs(folder)
        for p in sorted((FIXTURES / "face_parser" / "images").glob("*.jpg")):
            shutil.copy(p, folder)
        for i, im in enumerate(faces["b"] + faces["c"]):
            write_png(os.path.join(folder, f"photo{i}.png"), im)
        n_photos = len(os.listdir(folder))
        masks = gen_face_masks_torch.main(["--in_dir", folder, "--trash_dir",
                                           os.path.join(root, "trash")])
        if len(masks["masks"]) + len(masks["filtered"]) != n_photos:
            raise AssertionError(f"face masks: {masks} of {n_photos} photos")
        for path in masks["masks"]:  # every photo is 512x512
            mask = read_image(path)
            if mask.shape != (512, 512) or not set(np.unique(mask)) <= {0, 255}:
                raise AssertionError(f"face mask {path}: {mask.shape}, values {np.unique(mask)}")
        secs["face masks"] = time.perf_counter() - t0
        log(f"face masks: {len(masks['masks'])} written, {len(masks['filtered'])} trashed of "
            f"{n_photos} photos (random BiSeNet; face fractions "
            f"{', '.join(f'{v:.3f}' for v in masks['face_frac'].values())}) in "
            f"{secs['face masks']:.1f} s")

        # BiSeNet parsing and the makeup recolour
        t0 = time.perf_counter()
        src = str(FIXTURES / "face_parser" / "images" / "0.jpg")
        image = native.resize_pil(to_rgb(read_image(src)), (512, 512), "lanczos")
        parser = load_bisenet(None, "cuda", torch.Generator(device="cuda").manual_seed(0))
        parsing = gen_face_masks_torch.parse_image(parser, image)
        out = apply_makeup(image, parsing, MAKEUP)
        off = ~np.isin(parsing, [MAKEUP_PARTS[p] for p in MAKEUP])
        if not np.array_equal(out[off], image[off]):
            raise AssertionError("makeup: pixels off the recoloured parts changed")
        demo = makeup_demo_torch.main(["--image", src, "--out", os.path.join(root, "makeup.png"),
                                       *[a for p, c in MAKEUP.items()
                                         for a in (f"--{p}", ",".join(map(str, c)))]])
        if not np.array_equal(demo, out):
            raise AssertionError("makeup_demo_torch differs from parsing + apply_makeup")
        secs["makeup"] = time.perf_counter() - t0
        log(f"makeup: BiSeNet parsing of a 512x512 LANCZOS photo ({len(np.unique(parsing))} "
            f"classes), {int((~off).sum())} pixels recoloured ({', '.join(MAKEUP)}), the other "
            f"{int(off.sum())} equal to the input bit for bit; makeup_demo_torch the same image")

        # the demo server: GET / and a POST of two photos
        t0 = time.perf_counter()
        server = app_torch.make_server(app_torch.DemoBackend(wrapper, EVAL_STEPS), 0, "127.0.0.1")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
            conn.request("GET", "/")
            resp = conn.getresponse()
            page = resp.read().decode()
            conn.close()
            if resp.status != 200 or "multipart/form-data" not in page:
                raise AssertionError(f"demo GET: {resp.status}")
            status, page = post_multipart(server.server_address[1], [
                ("a.png", encode_png(faces["a"][0])),
                ("b.jpg", (FIXTURES / "face_parser" / "images" / "1.jpg").read_bytes())],
                {"prompt": "portrait at the beach", "style": "realistic",
                 "n": str(APP_IMAGES), "gs": "5.0"})
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        pngs = re.findall(r'<img src="data:image/png;base64,([^"]+)">', page)
        if status != 200 or len(pngs) != APP_IMAGES:
            raise AssertionError(f"demo POST: {status}, {len(pngs)} images: {page[:200]}")
        for p in pngs:
            img = decode_png(base64.b64decode(p))
            if img.shape != (512, 512, 3) or img.std() == 0:
                raise AssertionError(f"demo POST: image {img.shape}")
        secs["demo"] = time.perf_counter() - t0
        log(f"demo: app_torch on a free port: GET / 200; POST of a PNG and a JPEG photo, "
            f"{APP_IMAGES} images asked: 200 with {len(pngs)} 512x512 PNGs in {secs['demo']:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = time.perf_counter() - t_phase
    log(f"eval and tools: seconds by part {', '.join(f'{k} {v:.1f}' for k, v in secs.items())}; "
        f"card {card}; the phase {total:.1f} s")
    return dict(counts=counts, call={k: v for k, v in call.items() if k != "seen"},
                rows=table, worst=worst, masks=masks, seconds=secs, total=total)


# ---------------------------------------------------------------------------
# the host data path without PIL: decoding, the native item pipeline,
# the face parser on a folder of JPEGs; data-parallel training; sync-BN
# ---------------------------------------------------------------------------

REPO = pathlib.Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "data" / "images"
FOLDER_STEPS = 3  # face-parser train steps from the JPEG folder
# (do_flip, scale, dy, dx): the item pipeline's decisions, native against numpy
PREPARE_CASES = [(False, 1.0, 0, 0), (True, 0.75, 5, -3), (False, 0.93, -64, 40),
                 (True, 0.4, 17, -9)]
RESIZE_SIDES = (384, 640, 1024)  # 512x512 at the face parser's scales 0.75, 1.25, 2
DP_RANKS = 2
DP_MICRO_STEPS = 4  # 2 updates at the Stage-1 config's accumulation of 2
DP_TIMEOUT_S = 600  # the fit processes, built and run
# the 2-rank fit against one process on the same global batch of 4: both bf16
# through the UNet, at UNet batches 4-8 a rank against 8-16. The largest
# relative difference of a micro-step's loss and gradient norm, and the
# SubjBasisGenerator's update (after - before) relative L2. Each bound sits
# between the sound fit's reading and those of two planted faults of the
# gradients' all-reduce, averaged or left out (`chip_compare.py --dp-faults`
# on an H100 80GB HBM3 at 700 W): losses 4.2e-5 against 6.2e-4 and 6.3e-4,
# gradient norms 7.8e-4 against 0.50 and 0.54, the update 2.3e-3 against 0.34
# and 0.39.
DP_LOSS_REL = 2e-4
DP_GRAD_NORM_REL = 1e-2
DP_UPDATE_REL_L2 = 3e-2
# the adversarial recon iteration (`adv_bs` ADV_BS), 2 ranks against one
# process, on an H100 80GB HBM3 at 700 W. The loss: 3.7e-6-2.6e-4 apart over
# seven runs (bf16 rounding at the ranks' UNet and decode batches); a fault
# of the branch's reductions moves it by only 6e-6-2e-5 (2 CPU ranks), so
# DP_ADV_LOSS_REL holds the loss's own reductions, not the branch's. The
# attacked noise, over the attack's largest value (`chip_compare.py
# --dp-adv-faults`): against the single process's attack with the gradient
# taken on the ranks' row groups (their decode batches) the sound ranks read
# 0.75-1.1% in bf16 and 3.5e-5 in fp32, the max of each rank's own rows
# 6.5-9.3% and the mean of each rank's own rows 29%; against the whole
# batch's attack the sound ranks read 12-18% in bf16 (0.5% in fp32: the
# decode's rounding at each batch size), the max fault 14-19%, the mean
# fault 29%, so DP_ADV_WHOLE_REL tells the mean fault only
DP_ADV_LOSS_REL = 1e-3
DP_ADV_NOISE_REL = 3e-2
DP_ADV_WHOLE_REL = 0.25
SYNC_BN_CASES = BN_CASES[:7]  # the first seven of the face parser's BN shapes
SYNC_BN_TOL = 1e-4  # fp32: half the rows a rank against all of them on one


def sha256_of(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def decode_images(card: str) -> dict:
    """Every committed fixture of `tests/data/images/` decoded by the port's
    reader (PNG; JPEG, BMP and WebP through the host library), held to the
    SHA-256 of Pillow's pixels recorded beside it; the item pipeline native
    against numpy at 512x512, bit for bit; the host times of both, a 512x512
    JPEG's beside the 512x512 WebP's, palette PNG's and CMYK JPEG's."""
    from adaface_tpu_torch import native
    from adaface_tpu_torch.data.personalized import augment_numpy
    from adaface_tpu_torch.utils.image import read_image, resize_pil, to_grey, to_rgb

    t0 = time.perf_counter()
    native.load_library()
    log(f"decode: host library {native.library_path().name} built or loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    digests = json.loads((FIXTURES / "digests.json").read_text())
    equal, decode_ms = 0, {}
    for name, want in sorted(digests.items()):
        path = FIXTURES / name
        ms = median_ms(lambda: read_image(path), reps=5, warmup=1)
        px = read_image(path)
        px = to_grey(px) if len(want["shape"]) == 2 else to_rgb(px)
        if list(px.shape) != want["shape"] or sha256_of(px) != want["sha256"]:
            raise AssertionError(f"decode: {name} {px.shape} differs from Pillow's digest")
        equal += 1
        decode_ms[name] = ms
    jpeg512 = statistics.mean(v for k, v in decode_ms.items() if k.startswith("face_parser/im"))
    at512 = {"jpeg": jpeg512, **{k: decode_ms[f] for k, f in (
        ("webp", "timing_512_q80.webp"), ("palette_png", "timing_512_palette.png"),
        ("cmyk_jpeg", "timing_512_cmyk.jpg"))}}
    log(f"decode: {equal} of {len(digests)} fixtures equal to Pillow's pixels (SHA-256); host "
        f"ms at 512x512: " + ", ".join(f"{k} {v:.2f}" for k, v in at512.items())
        + f"; the others {min(decode_ms.values()):.3f}-{max(decode_ms.values()):.3f} ({card})")

    rs = np.random.RandomState(SEED)
    img = rs.randint(0, 256, (512, 512, 3)).astype(np.uint8)
    fg = (rs.rand(512, 512) > 0.5).astype(np.float32)
    for case in PREPARE_CASES:
        got = native.prepare_item(img, fg, 512, *case)
        want = augment_numpy(img.copy(), fg.copy(), 512, *case)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"prepare_item native against numpy differs at {case}")
    native_ms = median_ms(lambda: native.prepare_item(img, fg, 512, *PREPARE_CASES[3]))
    numpy_ms = median_ms(lambda: augment_numpy(img.copy(), fg.copy(), 512, *PREPARE_CASES[3]))
    log(f"decode: prepare_item native equal to numpy at 512x512 in {len(PREPARE_CASES)} cases; "
        f"host ms an item native {native_ms:.3f}, numpy {numpy_ms:.3f} ({card})")
    resize_ms = {}
    for side in RESIZE_SIDES:  # the face parser's scales of a 512x512 photo
        got = native.resize_pil(img, (side, side))
        if not np.array_equal(got, resize_pil(img, (side, side))):
            raise AssertionError(f"resize_pil native against numpy differs at {side}")
        resize_ms[side] = (
            median_ms(lambda: native.resize_pil(img, (side, side))),
            median_ms(lambda: resize_pil(img, (side, side)), reps=3, warmup=1))
    log("decode: Pillow's BILINEAR from 512x512 native equal to numpy; host ms native / numpy "
        + ", ".join(f"{k}: {a:.2f} / {b:.2f}" for k, (a, b) in resize_ms.items()) + f" ({card})")
    return dict(equal=equal, decode_512_ms=at512, decode_ms=decode_ms,
                prepare_native_ms=native_ms, prepare_numpy_ms=numpy_ms, resize_ms=resize_ms)


def train_face_parser_folder(gen) -> dict:
    """The face parser trained from a folder at its published configuration
    (BiSeNet-ResNet18, batch 16, crop 448, fp32): the four 512x512 JPEG
    fixtures and their PNG labels through `FaceMaskDataset.batches` (decode,
    Pillow's BILINEAR / NEAREST resizes, crop, flip, jitter in numpy), as
    `face_parsing_train.main` feeds them; FOLDER_STEPS steps, their losses,
    the host time of a batch, steps/sec and the memory peak."""
    from adaface_tpu_torch.models.bisenet import build_bisenet
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.train.face_parsing_train import (
        FaceMaskDataset, FaceParsingTrainConfig, make_face_parsing_optimizer,
        make_face_parsing_train_step)

    cfg = FaceParsingTrainConfig()
    ds = FaceMaskDataset(str(FIXTURES / "face_parser"), crop_size=cfg.crop_size, seed=SEED)
    model = build_bisenet("cuda", gen)
    step = make_face_parsing_train_step(cfg, model, make_face_parsing_optimizer(cfg, model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, secs, data_secs = [], [], []
    batches = ds.batches(cfg.batch_size, FOLDER_STEPS)
    for _ in range(FOLDER_STEPS):
        t0 = time.perf_counter()
        images, labels = next(batches)
        t1 = time.perf_counter()
        metrics = step(torch.from_numpy(images).to("cuda"),
                       torch.from_numpy(labels.astype(np.int64)).to("cuda"))
        losses.append(metrics["loss"].item())  # syncs
        data_secs.append(t1 - t0)
        secs.append(time.perf_counter() - t0)
    counts = launch_counts()
    expect_counts(counts, bisenet_forwards=FOLDER_STEPS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rate = FOLDER_STEPS / sum(secs)
    log(f"train folder: {len(ds)} JPEG photos with PNG labels, batch {cfg.batch_size} crop "
        f"{cfg.crop_size}: losses {', '.join(f'{v:.4f}' for v in losses)}; step times "
        f"{', '.join(f'{v * 1e3:.1f}' for v in secs)} ms, of which the batch's host preparation "
        f"{', '.join(f'{v * 1e3:.1f}' for v in data_secs)} ms; {rate:.3f} steps/sec with the "
        f"data; peak device memory {peak_gib:.2f} GiB; launches {counts}")
    if not all(math.isfinite(v) for v in losses) or images.shape != (
            cfg.batch_size, 3, cfg.crop_size, cfg.crop_size):
        raise AssertionError(f"train folder: losses {losses}, batch {images.shape}")
    return dict(counts=counts, losses=losses, secs=secs, data_secs=data_secs,
                steps_per_sec=rate, peak_gib=peak_gib)


def dp_photos(root: str) -> str:
    """One subject folder that mixes formats: the four 512x512 JPEG
    fixtures, two BMP fixtures (24-bit, 8-bit paletted) and two 512x512
    PNGs written by the port."""
    import shutil

    from adaface_tpu_torch.utils.image import write_png

    d = os.path.join(root, "subject0")
    os.makedirs(d)
    for i, src in enumerate(sorted((FIXTURES / "face_parser" / "images").glob("*.jpg"))):
        shutil.copy(src, os.path.join(d, f"jpeg{i}.jpg"))
    for name in ("rgb24.bmp", "paletted8.bmp"):
        shutil.copy(FIXTURES / name, os.path.join(d, name))
    rs = np.random.RandomState(SEED + 19)
    for i in range(2):
        write_png(os.path.join(d, f"png{i}.png"), rs.randint(0, 256, (512, 512, 3)).astype(np.uint8))
    return root


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


ADV_BS = 3  # the attacked rows span both ranks: global rows 0-1 on rank 0, 2 on rank 1
DP_PROCESSES = ("none0", "nccl0", "gloo0", "gloo1")  # dp_fit's processes, by backend and rank


def adv_faces(img):
    """A foreground and a background face whatever the pixels (512x512)."""
    return [(np.array([96, 64, 416, 400], np.float32), 0.9),
            (np.array([0, 240, 192, 496], np.float32), 0.8)]


def wait_for(paths: list, what: str) -> None:
    deadline = time.perf_counter() + DP_TIMEOUT_S
    while not all(os.path.exists(p) for p in paths):
        if time.perf_counter() > deadline:
            raise TimeoutError(f"{what}: waited {DP_TIMEOUT_S} s for {paths}")
        time.sleep(0.2)


def adv_batch(trainer, gen) -> dict:
    """A recon batch of 4 at full width on the card, drawn from `gen`: the
    encoder's random-ID image prompts, random latents, the prompts of the
    subject and the class at the trainer's placeholder width, masks, input
    pixels and their faces (the last undetected, outside the first ADV_BS)."""
    from adaface_tpu_torch.train.prompt_batch import build_4block_prompt_batch
    from adaface_tpu_torch.utils.tensor import Draws

    b, dev = 4, torch.device("cuda")
    pad = ", " * (trainer.cfg.num_vectors_per_subj_token - 1)
    subj = [f"a photo of z{pad}", f"a portrait of z{pad}, smiling"] * 2
    cls = [f"a photo of a person{pad}", f"a portrait of a person{pad}, smiling"] * 2
    pb = build_4block_prompt_batch(trainer.em, subj, subj, cls, cls)
    _, _, prompts, _ = trainer.encoder.get_img_prompt_embs(id_batch_size=b, rng=Draws(gen))
    img_mask = torch.ones((b, 1, 64, 64), device=dev)
    img_mask[1, :, :, -6:] = 0.0
    alpha = np.asarray(trainer.cfg.clip_skip_weights, np.float64)
    return {
        **adv_image_fields(gen),
        "img_prompt_embs": prompts.float(),
        **{k: torch.as_tensor(np.asarray(pb[k]), device=dev,
                              dtype=torch.float32 if k == "prompt_emb_mask" else torch.int64)
           for k in ("prompt_ids", "splice_map", "prompt_emb_mask", "uncond_ids")},
        "clip_skip_weights": torch.as_tensor(alpha / alpha.sum(), dtype=torch.float32,
                                             device=dev),
        "img_mask": img_mask,
        "recon_attn_lora_gate": torch.tensor(0.0, device=dev),
    }


def adv_image_fields(gen) -> dict:
    """The fields of `adv_batch` that the adversarial branch reads: latents
    and input pixels drawn from `gen` (in that order), the foreground masks,
    the face boxes and their detection flags. Rank 0's attacked rows have
    their foreground inside the face box, rank 1's the whole map, so that
    the fg-masked means of the ranks' rows differ: a rank that took its own
    rows' mean would scale its attack by a fifth off."""
    b, dev = 4, torch.device("cuda")
    fg = torch.zeros((b, 1, 64, 64), device=dev)
    fg[:2, :, 16:48, 16:40] = 1.0
    fg[2:] = 1.0
    x_start = torch.randn((b, 4, 64, 64), generator=gen, device=dev)
    return {
        "x_start": x_start, "fg_mask": fg,
        "ref_images": (torch.rand((b, 3, 512, 512), generator=gen, device=dev) * 2 - 1),
        "ref_face_bboxes": torch.tensor([[96, 64, 416, 400], [64, 96, 448, 480],
                                         [128, 80, 400, 432], [80, 80, 432, 432]],
                                        dtype=torch.float32, device=dev),
        "ref_face_detected": torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev),
    }


def dp_adv_iteration(trainer, sbg0) -> dict:
    """One recon iteration with the adversarial branch (`adv_bs` ADV_BS) of
    the trainer's Stage-1 towers, `sbg0` trained, at a global batch of 4:
    this process's slice of it on the trainer's mesh (the whole batch
    without one), through `make_train_step` (lr 0); its loss and metrics,
    host seconds, one more step's device time and operations and the
    launches; then `_adv_attacked_noise` alone on the same inputs: this
    process's rows of the attacked next-step noise."""
    from torch.profiler import ProfilerActivity, profile

    from adaface_tpu_torch.core.params import build, init_fan_in_
    from adaface_tpu_torch.models.arcface import ArcFace, init_arcface_weights_
    from adaface_tpu_torch.models.vae import SD_VAE, VAEDecoder
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.parallel.collectives import data_parallel
    from adaface_tpu_torch.parallel.mesh import shard_batch, shard_train_batch
    from adaface_tpu_torch.train import optimizers as O
    from adaface_tpu_torch.train import recon_step as R
    from adaface_tpu_torch.train import train_step as S
    from adaface_tpu_torch.train.face_detect import HostFaceDetector

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED + 26)
    decoder = build(lambda: VAEDecoder(SD_VAE), dev, torch.bfloat16, init_fan_in_, gen)
    arcface = build(lambda: ArcFace(), dev, torch.float32, init_arcface_weights_, gen)
    frozen = dict(trainer.frozen, vae=decoder, arcface=arcface)
    batch = adv_batch(trainer, gen)
    noise = torch.randn(batch["x_start"].shape, generator=gen, device=dev)
    rand = {"adv_dropout_u": torch.rand((ADV_BS, 512), generator=gen, device=dev),
            "adv_uniform": 0.37}
    mesh = trainer.mesh if trainer.mesh is not None and trainer.mesh.dp > 1 else None
    params = {"sbg": sbg0.to(dev)}
    opt = O.make_optimizer("cadamw", S.trainable_parameters(params), 0.0, warmup_steps=0,
                           total_steps=10)
    rcfg = R.ReconStepConfig(do_adv_attack=True, adv_bs=ADV_BS)
    step = S.make_train_step(R.make_recon_loss_fn(rcfg, HostFaceDetector(detector_fn=adv_faces)),
                             frozen, trainer.schedule, trainer.tcfg, mesh=mesh)
    local = batch if mesh is None else shard_train_batch(batch, mesh)
    state = S.init_state(params, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, local, torch.Generator(dev).manual_seed(SEED + 27))
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    counts = launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, local, torch.Generator(dev).manual_seed(SEED + 27))
        torch.cuda.synchronize()
    kernels = [e.us for e in device_events(prof) if e.name != "Memset (Device)"]
    rows, nz = batch, noise
    if mesh is not None:
        rows = shard_batch(batch, mesh.dp_rank, mesh.dp)
        nz = shard_batch(noise, mesh.dp_rank, mesh.dp)
    with data_parallel(mesh):
        attacked = R._adv_attacked_noise(frozen, rows, rand, nz, rcfg, 64)
    out = dict(metrics={k: float(v) for k, v in metrics.items()}, host_s=host_s,
               device_ms=sum(kernels) / 1e3, operations=len(kernels), counts=counts,
               peak=torch.cuda.max_memory_allocated(), noise=attacked.float().cpu(),
               noise_in=nz.float().cpu())
    if mesh is None:
        # the same attack with the gradient taken in the ranks' row groups
        # (their decode batches), in this process: the ranks' arithmetic
        # without the collectives, and the bf16 envelope of the decode's batch
        from adaface_tpu_torch.train.face_detect import map_bboxes_to_latent
        from adaface_tpu_torch.train.recon_multistep import calc_arcface_adv_grad

        half = batch["x_start"].shape[0] // DP_RANKS
        bb_px = batch["ref_face_bboxes"][:ADV_BS]
        bb_lat = map_bboxes_to_latent(bb_px, batch["ref_images"].shape[-1], 64)

        def grad(a, b):
            return calc_arcface_adv_grad(arcface, decoder, batch["x_start"][a:b], bb_lat[a:b],
                                         bb_px[a:b], rand["adv_dropout_u"][a:b], dropout_p=0.3,
                                         count=ADV_BS * 512).detach()

        groups = [(a, min(a + half, ADV_BS)) for a in range(0, ADV_BS, half)]
        whole = adv_noise_of(grad(0, ADV_BS), batch, rand, noise, rcfg)
        split = adv_noise_of(torch.cat([grad(a, b) for a, b in groups]), batch, rand, noise, rcfg)
        out.update(noise_whole=whole.float().cpu(), noise_split=split.float().cpu())
    return out


def adv_noise_of(adv, batch: dict, rand: dict, noise, rcfg):
    """`_adv_attacked_noise`'s scaling of a given gradient `adv` of the
    global batch's first rows, in one process: the plain arithmetic the
    ranks' collectives stand in for."""
    nb = adv.shape[0]
    fg = batch["fg_mask"][:nb]
    fg_mean = (adv.abs() * fg).sum() / (fg.sum() * adv.shape[1] + 1e-6)
    mag = torch.sqrt(adv.abs().max() * fg_mean)
    lo, hi = rcfg.recon_adv_mod_mag_range
    scale = torch.clamp((lo + (hi - lo) * float(rand["adv_uniform"])) / (mag + 1e-6), max=10.0)
    ok = batch["ref_face_detected"][:nb].prod()
    return torch.cat([noise[:nb] - adv * scale * ok, noise[nb:]])


def dp_fit(rank: int, world: int, backend: str | None, port: int, data: str, out: str,
           sync_bn: str) -> None:
    """One process of `train_dp`: the Stage-1 fit of TRAIN_CONFIG on `data`
    over DP_MICRO_STEPS micro-steps, as rank `rank` of `world` over
    `backend` with `trainer.dp=world`, or without a process group (backend
    None); its losses and gradient norms (after the ranks' sum), the
    SubjBasisGenerator before and after, the peak memory, the fit's seconds
    and the launches, saved to `out`. The gloo
    ranks first run `sync_bn_rank` on their group (results to
    `sync_bn`.rankN, then `sync_bn`.done); the other processes wait for it,
    so that its device times are the card's alone."""
    import datetime
    import tempfile

    import torch.distributed as dist

    import train_torch
    from adaface_tpu_torch.ops import _build

    torch.cuda.set_device(0)
    if backend:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        dist.init_process_group(backend, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    if backend == "gloo":
        sync_bn_rank(rank, world, f"{sync_bn}.rank{rank}")
        if rank == 0:
            pathlib.Path(f"{sync_bn}.done").touch()
    else:
        deadline = time.perf_counter() + DP_TIMEOUT_S
        while not os.path.exists(f"{sync_bn}.done") and time.perf_counter() < deadline:
            time.sleep(0.2)
    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=str(REPO)) as tmp:
        argv = ["--base", str(REPO / TRAIN_CONFIG), "--data_roots", data, "--log_dir", tmp,
                "--max_steps", str(DP_MICRO_STEPS), "trainer.ckpt_every=0"]
        cfg, args = train_torch.parse_args(argv + ([f"trainer.dp={world}"] if backend else []))
        trainer, dataset, start = train_torch.build_trainer(cfg, args)
        before = [p.detach().float().cpu().clone() for p in trainer.state.optimizer.params]
        losses, grad_norms = [], []
        post = trainer._post_step

        def watch(step, flags, metrics):
            losses.append(float(metrics["loss"]))
            grad_norms.append(float(metrics["grad_norm"]))
            post(step, flags, metrics)

        trainer._post_step = watch
        # the adversarial iteration's SubjBasisGenerator: the one every process starts from
        sbg0 = copy.deepcopy(trainer.state.params["sbg"]).cpu()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit(dataset, num_steps=DP_MICRO_STEPS, start_step=start)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        after = [p.detach().float().cpu().clone() for p in trainer.state.optimizer.params]
        res = dict(losses=losses, grad_norms=grad_norms, before=before, after=after,
                   fit_s=fit_s, peak=torch.cuda.max_memory_allocated(), counts=launch_counts(),
                   batch=trainer.cfg.batch_size,
                   dp=None if trainer.mesh is None else trainer.mesh.dp)
        # the adversarial recon iteration once every fit is done: the process
        # without a group first, then the two gloo ranks (the NCCL one has
        # none). It runs here, ordered by marker files, so that it reuses the
        # full-width Stage-1 towers this process has built and the gloo group
        # that is up; a second `run_processes` call would build both again.
        # A process that dies ends the wait at once: `run_processes` polls the
        # exit codes and stops the others.
        name = f"{backend or 'none'}{rank}"
        pathlib.Path(f"{sync_bn}.fit.{name}").touch()
        if backend != "nccl":
            trainer.state = None  # the fit's optimizer state: not the iteration's
            gc.collect()
            torch.cuda.empty_cache()
            wait_for([f"{sync_bn}.fit.{n}" for n in DP_PROCESSES], "train dp")
            if backend == "gloo":
                wait_for([f"{sync_bn}.adv.none0"], "train dp")
            res["adv"] = dp_adv_iteration(trainer, sbg0)
            if backend is None:
                pathlib.Path(f"{sync_bn}.adv.none0").touch()
        torch.save(res, out)
    if backend:
        dist.destroy_process_group()


def run_processes(target, args_list: list, timeout_s: float) -> None:
    """Start one spawned process per argument tuple, wait for all; a failed
    or late one stops the others and raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args_list]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.perf_counter() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise AssertionError(f"processes failed or ran out of time (index, exit code): {bad}")


def update_rel_l2(res: dict, ref: dict) -> float:
    num = sum(((a - a0) - (b - b0)).pow(2).sum() for a, a0, b, b0 in
              zip(res["after"], res["before"], ref["after"], ref["before"]))
    den = sum((b - b0).pow(2).sum() for b, b0 in zip(ref["after"], ref["before"]))
    return (num / den).sqrt().item()


def dp_distance(res: dict, ref: dict) -> tuple[float, float, float]:
    """A rank's fit against the single process's: the largest relative
    difference of a micro-step's loss and of its gradient norm, and the
    update's relative L2."""
    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    return (rel(res["losses"], ref["losses"]), rel(res["grad_norms"], ref["grad_norms"]),
            update_rel_l2(res, ref))


def adv_against_plain(adv: dict, card: str) -> dict:
    """`train_dp`'s adversarial recon iteration: the two gloo ranks' loss
    and metrics equal, their loss within DP_ADV_LOSS_REL of the single
    process's; their attacked noise rows (concatenated) against the single
    process's attack with the gradient taken in the ranks' row groups (their
    decode batches) within DP_ADV_NOISE_REL of the attack's largest value,
    and against the single process's own within DP_ADV_WHOLE_REL (the row
    groups' distance from the whole batch is printed beside it); the first
    ADV_BS rows moved and the others not."""
    plain, r0, r1 = adv["plain"], adv["rank0"], adv["rank1"]
    ref = plain["metrics"]["loss"]
    loss_rel = max(abs(r["metrics"]["loss"] - ref) / abs(ref) for r in (r0, r1))
    noise = torch.cat([r0["noise"], r1["noise"]])
    attack = (plain["noise"] - plain["noise_in"]).abs()

    def rel(a, b):
        return ((a - b).abs().max() / attack.max()).item()

    noise_rel, split_rel = rel(noise, plain["noise"]), rel(noise, plain["noise_split"])
    envelope, whole_rel = rel(plain["noise_split"], plain["noise_whole"]), rel(
        plain["noise_whole"], plain["noise"])
    moved = attack.flatten(1).amax(1)
    for name, r in adv.items():
        log(f"train dp: adversarial recon iteration, {name}: loss {r['metrics']['loss']:.6e}, "
            f"identity loss {r['metrics'].get('loss_arcface_align_recon', float('nan')):.6e}; "
            f"{r['host_s']:.2f} s on the host's clock, device {r['device_ms']:.2f} ms in "
            f"{r['operations']} operations; peak {r['peak'] / 2**30:.2f} GiB; launches "
            f"{dict(sorted(r['counts'].items()))}")
    log(f"train dp: adversarial recon iteration (adv_bs {ADV_BS}, global batch 4): 2 ranks "
        f"against one process: loss {loss_rel:.3e} relative (bound {DP_ADV_LOSS_REL:g}); "
        f"attacked noise, over the attack's largest value {attack.max().item():.4e}: against "
        f"the process's attack on the ranks' row groups {split_rel:.3e} (bound "
        f"{DP_ADV_NOISE_REL:g}), against its own {noise_rel:.3e} (bound {DP_ADV_WHOLE_REL:g}; the "
        f"row groups' attack {envelope:.3e} from the whole batch's; the whole batch's "
        f"recomputed {whole_rel:.3e} from the step's); rows moved by the attack "
        f"{moved.tolist()}; device time a rank {r0['device_ms']:.2f} / {r1['device_ms']:.2f} ms "
        f"against {plain['device_ms']:.2f} ms in one process ({card})")
    if r0["metrics"] != r1["metrics"] or not math.isfinite(ref):
        raise AssertionError(f"train dp: adversarial iteration: ranks {r0['metrics']} and "
                             f"{r1['metrics']}")
    if loss_rel > DP_ADV_LOSS_REL or split_rel > DP_ADV_NOISE_REL or noise_rel > DP_ADV_WHOLE_REL \
            or not ((moved[:ADV_BS] > 0).all() and (moved[ADV_BS:] == 0).all()):
        raise AssertionError(f"train dp: adversarial iteration: loss {loss_rel}, noise "
                             f"{split_rel} / {noise_rel}, rows moved {moved.tolist()}")
    return dict(loss_rel=loss_rel, noise_rel=noise_rel, noise_split_rel=split_rel,
                noise_envelope=envelope,
                device_ms={k: r["device_ms"] for k, r in adv.items()},
                host_s={k: r["host_s"] for k, r in adv.items()},
                counts=r0["counts"])


def train_dp(card: str) -> dict:
    """Data-parallel Stage-1 training on the card (its two gloo ranks run
    `check_sync_bn`'s work first): the fit of TRAIN_CONFIG
    (global batch 4, accumulation 2) on a subject folder of JPEG, BMP and
    PNG photos read through the native item pipeline, DP_MICRO_STEPS
    micro-steps, in four processes on cuda:0 at once: without a process
    group; as two ranks over gloo (`trainer.dp=2`: NCCL refuses two ranks on
    one device), each on half of every global batch; as one rank over NCCL
    (`trainer.dp=1`). The ranks hold equal parameters; the 2-rank fit is held
    to the plain one within DP_LOSS_REL (losses) and DP_UPDATE_REL_L2 (the
    SubjBasisGenerator's update), the NCCL fit bit for bit; each process's
    peak memory and fit time."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=str(REPO)) as tmp:
        data = dp_photos(os.path.join(tmp, "photos"))
        outs = {name: os.path.join(tmp, f"{name}.pt")
                for name in ("plain", "nccl1", "rank0", "rank1")}
        gloo, nccl = free_port(), free_port()
        sync = os.path.join(tmp, "sync_bn")
        t0 = time.perf_counter()
        run_processes(dp_fit, [(0, 1, None, 0, data, outs["plain"], sync),
                               (0, 1, "nccl", nccl, data, outs["nccl1"], sync),
                               (0, DP_RANKS, "gloo", gloo, data, outs["rank0"], sync),
                               (1, DP_RANKS, "gloo", gloo, data, outs["rank1"], sync)],
                      DP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        res = {k: torch.load(v, weights_only=False) for k, v in outs.items()}
        sync_ranks = [torch.load(f"{sync}.rank{r}", weights_only=False)
                      for r in range(DP_RANKS)]
    plain, nccl1, r0, r1 = res["plain"], res["nccl1"], res["rank0"], res["rank1"]
    for name, r in res.items():
        log(f"train dp: {name}: dp {r['dp']}, batch {r['batch']}, losses "
            f"{', '.join(f'{v:.6e}' for v in r['losses'])}, gradient norms "
            f"{', '.join(f'{v:.6e}' for v in r['grad_norms'])}; fit {r['fit_s']:.2f} s; peak "
            f"memory {r['peak'] / 2**30:.2f} GiB; launches {dict(sorted(r['counts'].items()))}")
    ranks_equal = r0["losses"] == r1["losses"] and all(
        torch.equal(a, b) for a, b in zip(r0["after"], r1["after"]))
    loss_rel, gnorm_rel, upd = dp_distance(r0, plain)
    moved = sum((a - b).pow(2).sum() for a, b in zip(plain["after"], plain["before"])).item()
    nccl_equal = nccl1["losses"] == plain["losses"] and all(
        torch.equal(a, b) for a, b in zip(nccl1["after"], plain["after"]))
    log(f"train dp: four fits at once in {wall:.1f} s ({card}); the two gloo ranks equal: "
        f"{ranks_equal}; 2 ranks against one process: losses {loss_rel:.3e} relative at most "
        f"(bound {DP_LOSS_REL:g}), gradient norms {gnorm_rel:.3e} (bound {DP_GRAD_NORM_REL:g}), "
        f"the SubjBasisGenerator's update relative L2 {upd:.3e} (bound {DP_UPDATE_REL_L2:g}); one "
        f"NCCL rank against no process group: equal bit for bit {nccl_equal}")
    if len(plain["losses"]) != DP_MICRO_STEPS or not all(
            math.isfinite(v) for r in res.values() for v in r["losses"]):
        raise AssertionError(f"train dp: losses {[r['losses'] for r in res.values()]}")
    if not ranks_equal or not nccl_equal or moved == 0:
        raise AssertionError(f"train dp: ranks equal {ranks_equal}, NCCL fit equal "
                             f"{nccl_equal}, moved {moved}")
    if not (loss_rel <= DP_LOSS_REL and gnorm_rel <= DP_GRAD_NORM_REL
            and upd <= DP_UPDATE_REL_L2):
        raise AssertionError(f"train dp: 2 ranks against one process: losses {loss_rel}, "
                             f"gradient norms {gnorm_rel}, update {upd}")
    adv = adv_against_plain({k: res[k]["adv"] for k in ("plain", "rank0", "rank1")}, card)
    return dict(loss_rel=loss_rel, grad_norm_rel=gnorm_rel, update_rel_l2=upd, wall_s=wall,
                sync_bn_ranks=sync_ranks, adv=adv,
                fits={k: {key: r[key] for key in ("losses", "grad_norms", "fit_s", "peak",
                                                  "counts", "dp")}
                      for k, r in res.items()})


def sync_bn_rank(rank: int, world: int, out: str) -> None:
    """One rank of `check_sync_bn`, in a gloo group of `world` ranks that is
    up: at each SYNC_BN_CASES shape, this rank's
    half of a batch through `fused_bn_act(group=)` forward and backward with
    the launches counted (and, on rank 0, the whole batch through the
    kernels without a group); then `bn_stats_sums` against
    `bn_sums_chunked` and the times of both, the library's and the bound."""
    import torch.distributed as dist

    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import fused_norm as N

    _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    cases = []
    for label, r, c, slope, dtype, _ in SYNC_BN_CASES:
        x = (torch.randn(r, c, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        g = torch.randn(r, c, generator=gen, device="cuda").to(dtype)
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        bias = torch.randn(c, generator=gen, device="cuda") * 0.3
        cases.append((label, x, g, scale, bias, slope))
    torch.cuda.synchronize()
    dist.barrier()
    _build.reset_launch_counts()
    mine = []
    for label, x, g, scale, bias, slope in cases:  # the sync-BN path
        n = x.shape[0] // world
        xl = x[rank * n:(rank + 1) * n].clone().requires_grad_(True)
        s, b = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        y = N.fused_bn_act(xl, s, b, slope, group=dist.group.WORLD)
        y.backward(g[rank * n:(rank + 1) * n])
        mine.append(dict(y=y.detach().cpu(), dx=xl.grad.cpu(), dscale=s.grad.cpu(),
                         dbias=b.grad.cpu()))
    torch.cuda.synchronize()
    counts = launch_counts()
    whole, sums = [], {}
    for (label, x, g, scale, bias, slope), m in zip(cases, mine):
        n = x.shape[0] // world
        xl = x[rank * n:(rank + 1) * n]
        if rank == 0:  # the whole batch on one rank, the kernels without a group
            xf = x.clone().requires_grad_(True)
            s, b = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
            y = N.fused_bn_act(xf, s, b, slope)
            y.backward(g)
            whole.append(dict(y=y.detach().cpu(), dx=xf.grad.cpu(), dscale=s.grad.cpu(),
                              dbias=b.grad.cpu()))
        plan = N.plan_for(xl)
        kernel, plain = N.bn_stats_sums(xl), N.bn_sums_chunked(xl, plan)
        sums[label] = dict(
            equal=bool(torch.equal(kernel, plain)), abs=(kernel - plain).abs().max().item(),
            graph_ms=graph_ms(lambda: N.bn_stats_sums(xl)),
            plain_ms=median_ms(lambda: N.bn_sums_chunked(xl, plan)),
            library_ms=median_ms(lambda: torch.batch_norm_stats(xl, BN_EPS)),
            bound_ms=bound(xl.numel() * xl.element_size() + 2 * 8 * xl.shape[1])[0],
            rows=xl.shape[0], c=xl.shape[1])
    torch.save(dict(mine=mine, whole=whole, sums=sums, counts=counts), out)
    dist.barrier()


def check_sync_bn(card: str, ranks: list) -> dict:
    """Sync-BN on the card: `fused_bn_act(group=)` forward and backward over
    2 gloo ranks on cuda:0, each on half the batch, at the first seven of the
    face parser's BN shapes, against the whole batch on one rank (y and dx
    per element within SYNC_BN_TOL of the output's scale, the ranks' scale
    and bias gradients summed); the launches of the path (one
    `bn_stats[sums]` and one `bn_norm_act` a shape); `bn_stats_sums`
    against its plain version (`bn_sums_chunked`: the same fp32 chunk sums
    and fp64 fold), its device time against the plain version's and
    `torch.batch_norm_stats`'s. `ranks`: what `sync_bn_rank` saved in each
    of `train_dp`'s two gloo ranks, which run it before their fit."""
    from adaface_tpu_torch.ops.fused_norm import BN_NORM_ACT, BN_STATS_SUMS

    worst = 0.0
    for i, (label, *_) in enumerate(SYNC_BN_CASES):
        got = {k: torch.cat([ranks[0]["mine"][i][k], ranks[1]["mine"][i][k]])
               for k in ("y", "dx")}
        got.update({k: ranks[0]["mine"][i][k] + ranks[1]["mine"][i][k]
                    for k in ("dscale", "dbias")})
        for k, ref in ranks[0]["whole"][i].items():
            err = (got[k].float() - ref.float()).abs().max().item() / max(
                1.0, ref.float().abs().max().item())
            worst = max(worst, err)
            if not err <= SYNC_BN_TOL:
                raise AssertionError(f"sync-BN {label} {k}: {err} of the scale")
    want = {BN_STATS_SUMS: len(SYNC_BN_CASES), BN_NORM_ACT: len(SYNC_BN_CASES)}
    for r, res in enumerate(ranks):
        if {k: v for k, v in res["counts"].items() if v} != want:
            raise AssertionError(f"sync-BN rank {r}: launches {res['counts']}, expected {want}")
        for label, s in res["sums"].items():
            if not s["equal"]:
                raise AssertionError(f"bn_stats sums mode {label}: {s['abs']} from plain")
    sums = ranks[0]["sums"]
    for label, s in sums.items():
        log(f"sync-BN {label} R{s['rows']} C{s['c']} a rank: bn_stats[sums] {s['graph_ms']:.4f} "
            f"ms (graph), plain {s['plain_ms']:.4f} ms, torch.batch_norm_stats "
            f"{s['library_ms']:.4f} ms, bound {s['bound_ms']:.3g} ms; equal to plain")
    log(f"sync-BN: {len(SYNC_BN_CASES)} shapes over {DP_RANKS} gloo ranks against the whole "
        f"batch on one: y, dx, dscale, dbias within {worst:.3e} of the scale (bound "
        f"{SYNC_BN_TOL:g}); launches a rank {ranks[0]['counts']} ({card})")
    return dict(counts=ranks[0]["counts"], worst=worst, sums=sums)


# ---------------------------------------------------------------------------
# tensor parallelism (`parallel/mesh.py` make_mesh(dp, tp), shard_params)
# ---------------------------------------------------------------------------

TP_WORLD = 4  # gloo ranks sharing cuda:0 (NCCL refuses two ranks a card): dp 2 x tp 2
TP_TIMEOUT_S = 900
TP_HEADS = 4  # SD1.5's 8 heads at tp 2
# the phase's images: 256x256 (32x32 latents), the full width at a quarter of
# the 512x512 activations, so that the gloo reductions through the host (a
# tp micro-step's cost on one card) and the fp32 witness stay short
TP_IMAGE_SIZE = 256
TP_DISTILL_BATCH = 2  # global: UNet batch 2 at tp 2, 1 a dp rank at dp 2 x tp 2
TP_RECON_BATCH = 1
TP_COMP_BATCH = 1  # the comp UNet's conditional call at batch 4 (ss, sc, sc_rep, mix)
TP_COMP_STEPS = (1, 1)  # priming, denoising steps of the comp micro-step
TP_RECON_STEPS = 1  # denoising steps of the recon micro-step (on images)
TP_BIAS_STD = 0.1  # the towers' projection biases drawn off their 0: a bias added twice shows
# fp32 plain, TF32 off: the ranks' loss and gradients (relative L2) against one
# process (PERF.md §6, tensor parallelism: loss ≤ 1.1e-7, gradients 6.3e-7-1.7e-6)
TP_FP32_REL = 1e-5
# bf16 through the kernels (PERF.md §6, tensor parallelism: loss 1.9e-5-1.8e-4, gradients
# 3.6e-3-6.0e-3; the planted faults', `chip_compare.py --tp-faults`: loss
# 2.8e-2-4.2e-2, gradients 0.16-0.79)
TP_BF16_LOSS_REL = 1e-3
TP_BF16_GRAD_REL_L2 = 1.5e-2
TP_CASES = ("unet-distill tp 2", "unet-distill dp 2 x tp 2", "recon tp 2", "comp tp 2")
# the flash kernels at the tp ranks' shapes: the UNet's attentions at 4 heads
# on TP_IMAGE_SIZE's 32x32 and 16x16 maps (the 8x8 level's 64 tokens take the
# plain version) at the batches the phase gives them (1, 2 and 4), and the
# recon's self-attentions under its face mask
TP_LEVELS = (("32x32", 1024, 40), ("16x16", 256, 80))
TP_FLASH_CASES = ([(f"unet {hw} {kind} tp 2 batch {b}", b, TP_HEADS, s,
                    s if kind == "self" else 77, d)
                   for b in (1, 2, 4) for hw, s, d in TP_LEVELS for kind in ("self", "cross")]
                  + [(f"recon masked {hw} self tp 2 batch {b}", b, TP_HEADS, s, s, d)
                     for b in (1, 2, 4) for hw, s, d in TP_LEVELS])


def check_flash_tp(gen) -> dict:
    """The flash forward and backward at the tensor-parallel phase's shapes
    (TP_FLASH_CASES: H 4), each against its plain version (the SDPA in fp32
    logits; `flash_bwd_chunked`), with the plans they take, device times (20
    launches as a CUDA graph), the plain versions' and the library's, and
    their bounds."""
    from adaface_tpu_torch.ops import attention as A

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, b, h, sq, sk, d in TP_FLASH_CASES:
        q, k, v = flash_inputs(gen, label, b, h, sq, sk, d)
        mask = face_mask(b, math.isqrt(sk)) if "masked" in label else None
        scale = 1.0 / math.sqrt(d)
        with torch.no_grad():
            o, stats = A._flash_cuda(q, k, v, mask, False, scale, with_stats=True)
            err, mag = max_err(o, A.scaled_dot_product_attention(q, k, v, kv_mask=mask))
            g = torch.randn((b, sq, h * d), generator=gen, device="cuda").to(q.dtype)
            g = g.reshape(b, sq, h, d).transpose(1, 2)
            got = A.flash_bwd(q, k, v, mask, o, g, False, scale, stats=stats)
            ref = A.flash_bwd_chunked(q, k, v, mask, o, g, False, scale)
            berr = max((max_err(x, r) for x, r in zip(got, ref)), key=lambda em: em[0] / em[1])
            del got, ref
            fwd_ms = graph_ms(lambda: A._flash_cuda(q, k, v, mask, False, scale))
            bwd_ms = graph_ms(lambda: A.flash_bwd(q, k, v, mask, o, g, False, scale,
                                                  stats=stats))
            plain_ms = median_ms(lambda: A.scaled_dot_product_attention(q, k, v, kv_mask=mask),
                                 reps=2, warmup=0)
            plain_bwd_ms = median_ms(lambda: A.flash_bwd_chunked(q, k, v, mask, o, g, False,
                                                                 scale), reps=1, warmup=0)
            attn_mask = None if mask is None else (mask > 0)[:, None, None, :]
            library_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                         attn_mask=attn_mask))
        bound_ms, bound_by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                                   4.0 * b * h * sq * sk * d)
        bwd_bound_ms, bwd_bound_by = bound(2 * (4 * q.numel() + 4 * k.numel()),
                                           5 * 2.0 * b * h * sq * sk * d)
        plan = A.plan_for(q, k, v)
        bwd_plan = A.flash_bwd_plan(q.dtype, b, h, sq, sk, d, sms)
        log(f"flash tp {label:38s} B{b} H{h} Sq{sq} Sk{sk} D{d}: forward {plan.variant} rows "
            f"{plan.block_rows}, max_abs_err {err:.3e} (bound {BF16_TOL * mag:.3e}), dev "
            f"{fwd_ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, least "
            f"{bound_ms:.4f} by {bound_by}; backward {bwd_plan.variant} rows "
            f"{bwd_plan.query_block}/{bwd_plan.key_block}, max_abs_err {berr[0]:.3e} (bound "
            f"{BF16_TOL * berr[1]:.3e}), dev {bwd_ms:.4f} ms, plain {plain_bwd_ms:.4f} ms, least "
            f"{bwd_bound_ms:.4f} by {bwd_bound_by}")
        if err > BF16_TOL * mag or berr[0] > BF16_TOL * berr[1]:
            raise AssertionError(f"flash tp {label}: forward {err}, backward {berr}")
        out[label] = dict(err=err, bwd_err=berr[0], graph_ms=fwd_ms, bwd_graph_ms=bwd_ms,
                          plain_ms=plain_ms, bwd_plain_ms=plain_bwd_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bwd_bound_ms=bwd_bound_ms,
                          rows=(plan.block_rows, bwd_plan.query_block, bwd_plan.key_block))
        del q, k, v, o, g, stats
        torch.cuda.empty_cache()
    return out


def tp_shapes_recorder(seen: set):
    """A context in which every flash call records (B, H, Sq, Sk, D, masked)."""
    from adaface_tpu_torch.ops import attention as A

    real = A.flash_attention

    def record(q, k, v, kv_mask=None, causal=False, scale=None):
        seen.add((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
                  kv_mask is not None))
        return real(q, k, v, kv_mask=kv_mask, causal=causal, scale=scale)

    return mock.patch.object(A, "flash_attention", record)


def draw_biases_(modules, seed: int) -> None:
    """Every projection bias of `modules` drawn at TP_BIAS_STD from a seed
    (the same on every process), so that where a row-split projection's bias
    is added shows in the outputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in modules:
            for mod in m.modules():
                if isinstance(mod, torch.nn.Linear) and mod.bias is not None:
                    mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen, device="cuda")
                                   * TP_BIAS_STD)


def broadcast_tree(tree, group, src: int) -> bool:
    """Every tensor of a batch (nested dicts) replaced by rank `src`'s copy,
    over the host (gloo); → whether this rank's copy was equal already."""
    import torch.distributed as dist

    equal = True
    for key, val in tree.items():
        if isinstance(val, dict):
            equal &= broadcast_tree(val, group, src)
        elif isinstance(val, torch.Tensor):
            wide = val.detach().cpu()
            wide = wide.float() if wide.dtype in (torch.bfloat16, torch.float16) else (
                wide.to(torch.uint8) if wide.dtype == torch.bool else wide).contiguous()
            ref = wide.clone()
            dist.broadcast(ref, src=src, group=group)
            equal &= torch.equal(ref, wide)
            tree[key] = ref.to(device=val.device, dtype=val.dtype)
    return equal


def weights_digest(modules) -> torch.Tensor:
    """Each parameter's fp64 sum, in order: equal on two processes that
    built the same weights."""
    return torch.stack([p.detach().double().sum() for m in modules for p in m.parameters()]).cpu()


def tp_step(trainer, loss_fn, batch: dict, flags, mesh) -> dict:
    """One micro-step through `make_train_step(mesh=)` (this rank's slice of
    `batch` where `mesh` is given; the whole batch in one process where it
    is None), the optimizer's update replaced by a copy of the gradients it
    is handed: → loss, metrics, gradients (fp32, on the host) and their
    SHA-256, seconds."""
    import hashlib

    from adaface_tpu_torch.parallel.mesh import shard_train_batch
    from adaface_tpu_torch.train.train_step import make_train_step

    opt = trainer.state.optimizer
    grads = []
    opt.step = lambda: grads.extend(  # an instance attribute: the class's step is untouched
        p.grad.detach().float().cpu() if p.grad is not None else torch.zeros(p.shape)
        for p in opt.params)
    try:
        step = make_train_step(loss_fn, trainer.frozen, trainer.schedule, trainer.tcfg,
                               mesh=mesh)
        part = batch if mesh is None else shard_train_batch(batch, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(trainer.state, part, trainer.draws_for(flags, loss=True))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        del opt.step
    digest = hashlib.sha256()
    for g in grads:
        digest.update(g.numpy().tobytes())
    return dict(loss=float(metrics["loss"]), metrics={k: float(v) for k, v in metrics.items()},
                grads=grads, digest=digest.hexdigest(), secs=secs)


def cast_towers_(trainer, dtypes) -> dict:
    """The frozen UNet (and the decoder) in `dtypes` (one dtype, or one a
    module), the UNet's frequency tables refilled in fp32 → the dtypes they
    had."""
    had = {}
    for key in ("unet", "vae"):
        if key in trainer.frozen:
            module = trainer.frozen[key]
            had[key] = next(module.parameters()).dtype
            module.to(dtypes[key] if isinstance(dtypes, dict) else dtypes)
    trainer.frozen["unet"].reset_buffers()
    return had


def tp_variants(trainer, loss_fns: dict, batch: dict, flags, mesh, seen: set) -> dict:
    """The micro-step in bf16 through the kernels (its launches counted, its
    flash shapes recorded) and in fp32 with every kernel's plain version and
    TF32 off (the towers cast and cast back: their weights are bf16 values,
    so both casts are exact)."""
    from adaface_tpu_torch.ops import _build

    _build.reset_launch_counts()
    with tp_shapes_recorder(seen):
        bf16 = tp_step(trainer, loss_fns["bf16"], batch, flags, mesh)
    bf16["counts"] = launch_counts()
    had = cast_towers_(trainer, torch.float32)
    try:
        with plain_versions(), deterministic_fp32():
            fp32 = tp_step(trainer, loss_fns["fp32"], batch, flags, mesh)
    finally:
        cast_towers_(trainer, had)
    gc.collect()
    torch.cuda.empty_cache()
    return {"bf16": bf16, "fp32": fp32}


def tp_trainer(config: str, data: str, tmp: str, batch_size: int, overrides=()):
    """`train_torch.build_trainer` on `config` at `batch_size` and
    TP_IMAGE_SIZE with a detector of one central face."""
    import train_torch
    from adaface_tpu_torch.train.face_detect import HostFaceDetector

    cfg, args = train_torch.parse_args([
        "--base", str(REPO / config), "--data_roots", data, "--log_dir", tmp,
        "--max_steps", "1", "trainer.ckpt_every=0", f"trainer.batch_size={batch_size}",
        f"trainer.image_size={TP_IMAGE_SIZE}", *overrides])
    trainer, dataset, _ = train_torch.build_trainer(cfg, args)
    trainer.host_detector = HostFaceDetector(detector_fn=central_face)
    return trainer, dataset


def tp_case(trainer, dataset, flags, loss_fns: dict, meshes: dict, group, rank: int,
            seen: set, fault=None) -> dict:
    """One iteration's batch (rank 0's, broadcast over `group`), its step in
    one process on rank 0 (the reference), then the towers cut by
    `shard_params` over `meshes`' first mesh and the step on each mesh
    (bf16 and fp32) → {name: variants}, each with its gradients' digest and
    on rank 0 its distance from the reference (`tp_distance`), with whether
    this rank's own batch and weights equalled rank 0's."""
    import torch.distributed as dist

    from adaface_tpu_torch.parallel.mesh import shard_params

    examples = [dataset[i % len(dataset)] for i in range(trainer.cfg.batch_size)]
    batch = trainer._prepare_batch(examples, flags, trainer.draws_for(flags))
    same_batch = broadcast_tree(batch, group, 0)
    towers = [trainer.frozen[k] for k in ("unet", "text_encoder")]
    draw_biases_(towers, SEED + 23)
    digests = [torch.zeros_like(d) for d in [weights_digest(towers)] for _ in range(
        dist.get_world_size(group))]
    dist.all_gather(digests, weights_digest(towers), group=group)
    same_weights = all(torch.equal(d, digests[0]) for d in digests)
    out = dict(same_batch=same_batch, same_weights=same_weights)
    plain = tp_variants(trainer, loss_fns, batch, flags, None, set()) if rank == 0 else None
    planted = contextlib.nullcontext()
    if fault is not None:  # `chip_compare.py --tp-faults`
        import chip_compare

        planted = chip_compare.tp_fault(fault)
    with planted:
        first = next(iter(meshes.values()))
        for tower in towers:
            shard_params(tower, first)
        for name, mesh in meshes.items():
            if mesh is not None:
                out[name] = tp_variants(trainer, loss_fns, batch, flags, mesh, seen)
                for v, res in out[name].items():  # the gradients stay in the process
                    if plain is not None:
                        res["distance"] = tp_distance(res, plain[v])
                        res["plain_s"] = plain[v]["secs"]
                    del res["grads"]
    return out


def tp_process(rank: int, world: int, port: int, data: str, out: str, fault=None) -> None:
    """One gloo rank of `train_tp` on cuda:0. World TP_WORLD: the Stage-1
    unet-distill micro-step at dp 2 x tp 2 (all ranks) and at tp 2 (ranks
    0-1, on the same cut towers: both meshes' tp groups are {0, 1}), then
    the recon and the comp micro-steps at tp 2 on ranks 0-1; rank 0 also
    runs each in one process first. World 2 (`chip_compare.py --tp-faults`,
    `fault` "sound" or one of its TP_FAULTS): the unet-distill micro-step at
    tp 2 alone, with the fault planted."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from adaface_tpu_torch.parallel.mesh import Mesh, make_mesh
    from adaface_tpu_torch.train.comp_step import make_comp_loss_fn
    from adaface_tpu_torch.train.recon_step import make_recon_loss_fn
    from adaface_tpu_torch.train.train_step import unet_distill_loss_fn

    torch.cuda.set_device(0)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    res, seen = {}, set()
    grid = make_mesh(world // 2, 2)
    pair = Mesh(1, rank, 0, grid.device, 2, None, grid.tp_group) if rank < 2 else None
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=str(REPO)) as tmp:
        trainer, dataset = tp_trainer(TRAIN_CONFIG, data, tmp, TP_DISTILL_BATCH)
        flags = dataclasses.replace(trainer.planner.plan(0), num_denoising_steps=1)
        fns = {"bf16": unet_distill_loss_fn, "fp32": unet_distill_loss_fn}
        meshes = ({"dp 2 x tp 2": grid, "tp 2": pair} if fault is None else {"tp 2": pair})
        res["distill"] = tp_case(trainer, dataset, flags, fns, meshes, dist.group.WORLD, rank,
                                 seen, fault)
        res["build_s"] = time.perf_counter() - t0
        del trainer, dataset
        gc.collect()
        torch.cuda.empty_cache()
        if rank < 2 and fault is None:
            trainer, dataset = tp_trainer(FINETUNE_CONFIG, data, tmp, TP_RECON_BATCH,
                                          ["trainer.unfreeze_unet=false"])
            flags = trainer.planner.plan(0)
            flags = dataclasses.replace(flags, normal_recon_on_pure_noise=False,
                                        do_adv_attack=False)
            rcfg = dataclasses.replace(trainer.cfg.recon_cfg, on_pure_noise=False,
                                       num_denoising_steps=TP_RECON_STEPS)
            fns = {"bf16": make_recon_loss_fn(rcfg, trainer.host_detector),
                   "fp32": make_recon_loss_fn(dataclasses.replace(rcfg, compute_dtype="float32"),
                                              trainer.host_detector)}
            res["recon"] = tp_case(trainer, dataset, flags, fns, {"tp 2": pair}, grid.tp_group,
                                   rank, seen)
            del trainer, dataset, fns
            gc.collect()
            torch.cuda.empty_cache()
            trainer, dataset = tp_trainer(STAGE2_CONFIG, data, tmp, TP_COMP_BATCH)
            add_adapters(trainer, torch.Generator(device="cuda").manual_seed(SEED + 24))
            prime, steps = TP_COMP_STEPS
            flags = dataclasses.replace(trainer.planner.plan(0), num_priming_steps=prime)
            if flags.iter_type != "comp_distill":
                raise AssertionError(f"train tp: step 0 of {STAGE2_CONFIG} is {flags.iter_type}")
            ccfg = dataclasses.replace(trainer.comp_cfg, num_priming_steps=prime,
                                       num_denoising_steps=steps)
            fns = {"bf16": make_comp_loss_fn(ccfg, trainer.host_detector),
                   "fp32": make_comp_loss_fn(dataclasses.replace(ccfg, compute_dtype="float32"),
                                             trainer.host_detector)}
            res["comp"] = tp_case(trainer, dataset, flags, fns, {"tp 2": pair}, grid.tp_group,
                                  rank, seen)
            del trainer, dataset
    res["shapes"] = seen
    res["peak"] = torch.cuda.max_memory_allocated()
    res["secs"] = time.perf_counter() - t0
    torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


def tp_distance(got: dict, ref: dict) -> tuple[float, float]:
    """(the loss's relative difference, the gradients' relative L2 over every
    trainable tensor) of a rank's micro-step against one process's."""
    num = sum(((a - b) ** 2).sum() for a, b in zip(got["grads"], ref["grads"]))
    den = sum((b ** 2).sum() for b in ref["grads"])
    return abs(got["loss"] - ref["loss"]) / abs(ref["loss"]), (num / den).sqrt().item()


def tp_equal(a: dict, b: dict) -> bool:
    return a["metrics"] == b["metrics"] and a["digest"] == b["digest"]


def tp_readings(ranks: list, card: str, label: str = "train tp") -> dict:
    """Every case of `tp_process`' results: the tp ranks equal bit for bit,
    each mesh's rank 0 against the one process in bf16 (kernels) and fp32
    (plain, TF32 off), the batch and weights each rank built against rank
    0's; logged → {case: {variant: (loss rel, grad rel L2), ...}}."""
    out = {}
    for it in ("distill", "recon", "comp"):
        if it not in ranks[0]:
            continue
        holders = [r for r in ranks if it in r]
        for mesh in (m for m in holders[0][it] if m not in ("same_batch", "same_weights")):
            members = [r[it][mesh] for r in holders if mesh in r[it]]
            row = {}
            for v in ("bf16", "fp32"):
                row[v] = members[0][v]["distance"]  # rank 0's
                row[f"{v}_equal"] = all(tp_equal(m[v], members[0][v]) for m in members)
                row[f"{v}_s"] = members[0][v]["secs"]
                row[f"{v}_plain_s"] = members[0][v]["plain_s"]
            row["counts"] = members[0]["bf16"]["counts"]
            row["loss"] = members[0]["bf16"]["loss"]
            row["same_batch"] = all(r[it]["same_batch"] for r in holders)
            row["same_weights"] = all(r[it]["same_weights"] for r in holders)
            out[f"{it} {mesh}"] = row
            log(f"{label}: {it} at {mesh} ({len(members)} ranks, {card}): ranks equal bit for "
                f"bit bf16 {row['bf16_equal']} fp32 {row['fp32_equal']}; against one process: "
                f"bf16 (kernels) loss {row['bf16'][0]:.3e}, gradients {row['bf16'][1]:.3e} "
                f"relative L2; fp32 plain (TF32 off) loss {row['fp32'][0]:.3e}, gradients "
                f"{row['fp32'][1]:.3e}; loss {row['loss']:.6e}; a rank's micro-step "
                f"{row['bf16_s']:.2f} s bf16 / {row['fp32_s']:.2f} s fp32 against "
                f"{row['bf16_plain_s']:.2f} / {row['fp32_plain_s']:.2f} s in one process; each "
                f"rank's own batch equal to rank 0's {row['same_batch']}, weights "
                f"{row['same_weights']}; launches {dict(sorted(row['counts'].items()))}")
    return out


def train_tp(card: str) -> dict:
    """Tensor parallelism on the card at full SD1.5 width (TP_IMAGE_SIZE):
    TP_WORLD gloo ranks on cuda:0 (`tp_process`) run the Stage-1 unet-distill
    micro-step (TRAIN_CONFIG, batch TP_DISTILL_BATCH, one teacher step) at
    dp 2 x tp 2 and at tp 2, the recon micro-step of FINETUNE_CONFIG (its
    UNet frozen and cut: JAX cuts only the frozen towers) at tp 2 and the
    comp micro-step of STAGE2_CONFIG with the rank-192 adapters
    (TP_COMP_STEPS) at tp 2, each in bf16 through the kernels and in fp32
    plain with TF32 off, held to the same micro-step in one process: the tp
    ranks equal bit for bit, fp32 within TP_FP32_REL, bf16 within
    TP_BF16_LOSS_REL / TP_BF16_GRAD_REL_L2;
    every flash shape the ranks ran is one of TP_FLASH_CASES (phase 3 holds
    them)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=str(REPO)) as tmp:
        data = write_train_photos(os.path.join(tmp, "photos"))
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(TP_WORLD)]
        port = free_port()
        t0 = time.perf_counter()
        run_processes(tp_process, [(r, TP_WORLD, port, data, outs[r]) for r in range(TP_WORLD)],
                      TP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        ranks = [torch.load(o, weights_only=False) for o in outs]
    rows = tp_readings(ranks, card)
    # the UNet's attentions (the VAE decoder's D 512 ones are not split: the
    # finetuning and Stage-2 phases' shapes)
    shapes = {s for r in ranks for s in r["shapes"] if s[4] < 512}
    held = {(b, h, sq, sk, d, "masked" in label) for label, b, h, sq, sk, d in TP_FLASH_CASES}
    peaks = ", ".join(f"{r['peak'] / 2**30:.2f}" for r in ranks)
    log(f"train tp: {TP_WORLD} processes in {wall:.1f} s ({card}); rank 0 {ranks[0]['secs']:.1f} "
        f"s (its Stage-1 case, the stack built, {ranks[0]['build_s']:.1f} s); peak memory a rank "
        f"{peaks} GiB; flash shapes run {sorted(shapes)}")
    bad = [k for k, r in rows.items() if not (
        r["bf16_equal"] and r["fp32_equal"] and r["same_weights"]
        and r["fp32"][0] <= TP_FP32_REL and r["fp32"][1] <= TP_FP32_REL
        and r["bf16"][0] <= TP_BF16_LOSS_REL and r["bf16"][1] <= TP_BF16_GRAD_REL_L2
        and math.isfinite(r["loss"]))]
    if sorted(rows) != sorted(("distill dp 2 x tp 2", "distill tp 2", "recon tp 2",
                               "comp tp 2")) or bad:
        raise AssertionError(f"train tp: cases {sorted(rows)}, failing {bad}: "
                             f"{[rows[k] for k in bad]}")
    if not shapes <= held:
        raise AssertionError(f"train tp: flash shapes phase 3 does not hold: {shapes - held}")
    return dict(rows=rows, wall_s=wall, peak=[r["peak"] for r in ranks],
                counts=rows["distill tp 2"]["counts"])


def kernel_record(flash: dict, gn: dict, bn: dict, ln: dict, flash_bwd: dict, gn_bwd: dict,
                  int8: dict, counts: dict, paths: dict, sync_bn: dict) -> dict:
    """The per-kernel record. `launches` are those of the path that first ran
    the kernel (the 3 requests of phase 5, the train steps, the fused-LN UNet
    call); `launches_by_path` has the later serving paths' beside them
    (`paths`: name → launch counts). Each flash kernel counts its launches under
    keys of its own, so an entry's `launches` are those of the kernel in its
    `source`: the wgmma kernel's two entries, the wide kernel's (whose
    `max_abs_err` also covers the tensors off the path that it takes: the
    misaligned case and the masked ones at D 64 and D 200) and the combine
    kernel's. The fp32 CUDA-core kernel is on no path and has no entry; its
    masked case is held against plain above. `ms`, `plain_ms`, `library_ms`
    (one stock PyTorch call that computes the same function, else null) and
    `bound_ms` are those of the shape named in `shape`; the flash entries
    also list every path shape under `shapes`. The one-launch GroupNorm
    kernel stands for both TPU GroupNorm kernels (`replaces`, `replaces_also`)
    and has `F.group_norm` (+ `F.silu`) in the same memory format as its
    library call; its `shapes` hold every path shape it takes, `per_request`
    the sums over all GroupNorms of a request. The split GroupNorm pair and
    BatchNorm are two kernels for what the library's fused op does in one
    call: the statistics kernels have `torch.var_mean` and
    `torch.batch_norm_stats` as their library call, the normalize kernels
    none, and all four carry the pair's times (`pair_ms`, `pair_library_ms`).
    `graph_ms` is the device time of a launch (20 launches in a CUDA graph),
    `launch_floor_ms` that of an empty kernel's launch. The `bn_stats` and
    `layer_norm` entries list every path shape under `shapes`, with its
    launches a train step or a fused-LN request, and the sums over them
    (`per_step`, `per_request`). The backward kernels' `launches` are those
    of the Stage-1 fit (the D 512 flash kernels' and the GroupNorm split
    pair's: the finetuning fit's); each one's `ms` is its own device time (20
    launches in a CUDA graph) and `bound_ms` its own work's, at the shape
    named (the split pair's `floor_ms`: the 5 passes it cannot do without);
    `plain_ms` and `library_ms` are those of the whole backward it is a
    part of (`flash_bwd_chunked` and the autograd backward of
    `F.scaled_dot_product_attention`'s flash backend; the closed-form VJP and
    that of `F.group_norm` + `F.silu`), beside the whole backward's own
    times and bound (`function_*`), and every path shape under `shapes`.
    The int8 kernels' `launches` are those of the int8 mode's SPEED_REQUESTS requests;
    each one's `ms` is its own device time (5 launches in a CUDA graph) at
    `JSON_INT8`; `int8_conv_igemm`'s `plain_ms` is the plain fp64-sum layer's
    (quantization included) and it has no library call (PyTorch has no
    eager int8 convolution on CUDA): cuDNN's bf16 convolution and im2col +
    `torch._int_mm` stand beside it as yardsticks (`cudnn_bf16_ms`,
    `int_mm_ms`), with the whole layer's times (`layer_*`: three launches, no
    memset); `quant_act` has no library call (`torch.linalg.vector_norm(x,
    inf)` is its first pass only). Every int8 shape is under `shapes`, the sums a UNet call under
    `per_call`."""
    from adaface_tpu_torch.ops.attention import (FLASH_BWD_DELTA, FLASH_BWD_DELTA_WIDE,
                                                 FLASH_BWD_DKDV_WG, FLASH_BWD_DKDV_WIDE,
                                                 FLASH_BWD_DQ_WG, FLASH_BWD_DQ_WIDE,
                                                 FLASH_COMBINE, FLASH_STD, FLASH_T, FLASH_WIDE)
    from adaface_tpu_torch.ops.fused_gn import (GN_BWD_DX, GN_BWD_FUSED, GN_BWD_REDUCE, GN_FUSED,
                                                GN_NORM, GN_STATS)
    from adaface_tpu_torch.ops.fused_ln import LAYER_NORM
    from adaface_tpu_torch.ops.fused_norm import BN_NORM_ACT, BN_STATS, BN_STATS_SUMS
    from adaface_tpu_torch.ops.quant import INT8_CONV, QUANT_ACT

    def entry(name, source, replaces, err, shape, ms, plain_ms, library_ms, bound_ms,
              bound_by="bytes", **extra):
        return {"name": name, "route": "cuda", "source": f"adaface_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": counts[name],
                "launches_by_path": {path: c[name] for path, c in paths.items() if c.get(name)},
                "max_abs_err": err,
                "shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, **extra}

    def flash_entry(name, source, replaces, errs, shape, labels):
        r = flash[shape]
        shapes = {label: {"ms": flash[label]["ms"], "run_ms": flash[label]["run_ms"],
                          "plain_ms": flash[label]["plain_ms"],
                          "library_ms": flash[label]["stock_ms"],
                          "library_run_ms": flash[label]["stock_run_ms"],
                          "graph_ms": flash[label]["graph_ms"],
                          "library_graph_ms": flash[label]["stock_graph_ms"],
                          "host_us": flash[label]["host_us"],
                          "library_host_us": flash[label]["stock_host_us"],
                          "bound_ms": flash[label]["bound_ms"],
                          "bound_by": flash[label]["bound_by"]} for label in labels}
        return entry(name, source, replaces, max(errs), shape, r["ms"], r["plain_ms"],
                     r["stock_ms"], r["bound_ms"], r["bound_by"], shapes=shapes)

    path = {label: d for (label, *_, d) in (FLASH_CASES + FLASH_CASES_B16 + FLASH_TEACHER_CASES
                                            + FLASH_JOINT_TEACHER_CASES + FLASH_XL_CASES
                                            + FLASH_VIDEO_CASES)}
    short = [label for label, d in path.items() if flash[label]["variant"] == "wg" and d < 128]
    long_ = [label for label, d in path.items() if flash[label]["variant"] == "wg" and d >= 128]
    wide = [label for label in path if flash[label]["variant"] == "wide"]
    # off the path: the contiguous case counts as FLASH_T, the masked and
    # causal ones as FLASH_STD, whatever the wide kernel takes as FLASH_WIDE
    off_path = {k: r for k, r in flash.items() if k not in path and k not in ("combine", "stats")}
    short_off = [r["err"] for k, r in off_path.items()
                 if r["variant"] == "wg" and not k.startswith("masked")]
    long_off = [r["err"] for k, r in off_path.items()
                if r["variant"] == "wg" and k.startswith("masked")]
    wide_off = [r["err"] for r in off_path.values() if r["variant"] == "wide"]
    g, gs, b_, l_, c = gn[JSON_GN], gn[JSON_GN_SPLIT], bn[JSON_BN], ln[JSON_LN], flash["combine"]
    sb = sync_bn["sums"][JSON_BN]
    gn_keys = ("ms", "graph_ms", "plain_ms", "stock_ms", "stock_graph_ms", "host_us",
               "stock_host_us", "bound_fn", "launches")
    gn_shapes = {kind: {case[0]: {k.replace("stock", "library"): gn[case[0]][k] for k in gn_keys}
                        for case in GN_CASES if gn[case[0]]["kernel"] == kind}
                 for kind in ("fused", "split")}
    gn_errs = lambda kind, key: max(r[key] for r in gn.values()
                                    if isinstance(r, dict) and r.get("kernel") == kind)
    gn_pair = dict(pair_ms=gs["ms"], pair_library_ms=gs["stock_ms"], pair_graph_ms=gs["graph_ms"],
                   pair_library_graph_ms=gs["stock_graph_ms"], shapes=gn_shapes["split"])
    bn_pair = dict(pair_ms=b_["ms"], pair_library_ms=b_["stock_ms"], pair_graph_ms=b_["graph_ms"],
                   pair_library_graph_ms=b_["stock_graph_ms"], per_step=bn["per step"])
    bn_cases = {case[0]: bn[case[0]] for case in BN_CASES}
    bn_shapes = {label: {"graph_ms": r["graph_stats"], "library_graph_ms": r["stock_graph_stats"],
                         "ms": r["ms_stats"], "library_ms": r["stock_stats"],
                         "host_us": r["host_us"], "library_host_us": r["stock_host_us"],
                         "bound_ms": r["bound_stats"], "launches": r["launches"],
                         "plan": r["plan"]} for label, r in bn_cases.items()}
    ln_cases = {case[0]: ln[case[0]] for case in LN_CASES}
    ln_shapes = {label: {k.replace("stock", "library"): r[k] for k in (
        "graph_ms", "stock_graph_ms", "ms", "stock_ms", "host_us", "stock_host_us", "bound_ms",
        "launches", "plan")} for label, r in ln_cases.items()}
    ln_errs = [r["err"] for r in ln.values() if isinstance(r, dict) and "err" in r]
    fb_path = [case[0] for case in FLASH_BWD_CASES + FLASH_BWD_RECON + FLASH_BWD_STAGE2
               if case[0] in flash_bwd]
    fb = flash_bwd[JSON_FLASH_BWD]
    vae_bwd = [case[0] for case in FLASH_BWD_VAE + FLASH_BWD_STAGE2_VAE if case[0] in flash_bwd]
    is_wide = lambda label: label in vae_bwd or "D512" in label  # noqa: E731
    fb_err = max(r["err"] for k, r in flash_bwd.items() if not is_wide(k))
    i8_cases = {k: r for k, r in int8.items() if not k.startswith("per call")}
    i8 = i8_cases[JSON_INT8]
    fb_wide_err = max(r["err"] for k, r in flash_bwd.items() if is_wide(k))

    def flash_bwd_entry(name, part, json_shape=JSON_FLASH_BWD, labels=fb_path, err=fb_err,
                        source="flash_attn_bwd_wg.cu"):
        r = flash_bwd[json_shape]
        shapes = {label: {"ms": flash_bwd[label][f"{part}_graph_ms"],
                          "bound_ms": flash_bwd[label]["kernel_bounds"][part][0],
                          "bound_by": flash_bwd[label]["kernel_bounds"][part][1],
                          "function_graph_ms": flash_bwd[label]["graph_ms"],
                          "function_bound_ms": flash_bwd[label]["bound_ms"],
                          "plain_ms": flash_bwd[label]["plain_ms"],
                          "library_ms": flash_bwd[label]["library_ms"],
                          "library": flash_bwd[label]["library"]} for label in labels}
        return entry(name, source, "adaface_tpu/ops/attention.py:384", err,
                     json_shape, r[f"{part}_graph_ms"], r["plain_ms"], r["library_ms"],
                     *r["kernel_bounds"][part], function_ms=r["ms"],
                     function_graph_ms=r["graph_ms"], function_bound_ms=r["bound_ms"],
                     function_bound_by=r["bound_by"], library=r["library"], shapes=shapes)

    # the D 512 delta is flash_attn_bwd_wg.cu's kernel at 8 threads a row
    wide_bwd = dict(json_shape=FLASH_BWD_VAE[0][0], labels=vae_bwd, err=fb_wide_err,
                    source="flash_attn_bwd.cu")

    def gn_bwd_entry(name, part, json_shape):
        """`part`'s own device time and bound at `json_shape`, and at every
        shape the plan gave it; `plain_ms` and `library_ms` those of the whole
        backward (the closed form, `F.group_norm` (+ `F.silu`) autograd)."""
        r = gn_bwd[json_shape]
        shapes = {label: {"ms": q[f"{part}_graph_ms"], "bound_ms": q[f"{part}_bound_ms"],
                          "function_graph_ms": q["graph_ms"], "function_bound_ms": q["bound_ms"],
                          "floor_ms": q.get("floor_ms"), "plain_ms": q["plain_ms"],
                          "library_ms": q["library_ms"], "host_us": q["host_us"]}
                  for label, q in gn_bwd.items() if f"{part}_graph_ms" in q}
        errs = [q["err"] for q in gn_bwd.values()
                if q["kernel"] == ("fused" if part == "fused" else "split")]
        return entry(name, "group_norm_silu.cu", "adaface_tpu/ops/fused_gn.py:143", max(errs),
                     json_shape, r[f"{part}_graph_ms"], r["plain_ms"], r["library_ms"],
                     r[f"{part}_bound_ms"], "bytes", function_ms=r["ms"],
                     function_graph_ms=r["graph_ms"], function_bound_ms=r["bound_ms"],
                     floor_ms=r.get("floor_ms"), host_us=r["host_us"], shapes=shapes)

    return {"kernels": [
        flash_entry(FLASH_T, "flash_attn_wgmma.cu", "adaface_tpu/ops/attention.py:165",
                    [flash[k]["err"] for k in short] + short_off, JSON_FLASH_T, short),
        flash_entry(FLASH_STD, "flash_attn_wgmma.cu", "adaface_tpu/ops/attention.py:89",
                    [flash[k]["err"] for k in long_] + long_off, JSON_FLASH_STD, long_),
        flash_entry(FLASH_WIDE, "flash_attn_wide.cu", "adaface_tpu/ops/attention.py:89",
                    [flash[k]["err"] for k in wide] + wide_off, JSON_FLASH_WIDE, wide),
        entry(FLASH_COMBINE, "flash_attn_wide.cu", "adaface_tpu/ops/attention.py:89",
              c["err"], "2 splits of vae mid self", c["ms"], c["plain_ms"], None,
              c["bound_ms"], c["bound_by"]),
        entry(GN_FUSED, "group_norm_silu.cu", "adaface_tpu/ops/fused_gn.py:23",
              gn_errs("fused", "err"), JSON_GN, g["ms"], g["plain_ms"], g["stock_ms"],
              g["bound_fn"], replaces_also="adaface_tpu/ops/fused_gn.py:40",
              graph_ms=g["graph_ms"], library_graph_ms=g["stock_graph_ms"],
              shapes=gn_shapes["fused"], per_request=gn["per request"]),
        entry(GN_STATS, "group_norm_silu.cu", "adaface_tpu/ops/fused_gn.py:23",
              gn_errs("split", "stats_err"), JSON_GN_SPLIT, gs["ms_stats"], gs["plain_stats"],
              gs["stock_stats"], gs["bound_stats"], graph_ms=gs["graph_stats"],
              library_graph_ms=gs["stock_graph_stats"], **gn_pair),
        entry(GN_NORM, "group_norm_silu.cu", "adaface_tpu/ops/fused_gn.py:40",
              gn_errs("split", "norm_err"), JSON_GN_SPLIT, gs["ms_norm"], gs["plain_norm"], None,
              gs["bound_norm"], graph_ms=gs["graph_norm"], **gn_pair),
        entry(BN_STATS, "batch_norm_act.cu", "adaface_tpu/ops/fused_norm.py:31",
              max(r["stats_abs"] for r in bn_cases.values()), JSON_BN, b_["ms_stats"],
              b_["plain_stats"], b_["stock_stats"], b_["bound_stats"],
              graph_ms=b_["graph_stats"], library_graph_ms=b_["stock_graph_stats"],
              launch_floor_ms=bn["launch floor"], shapes=bn_shapes, **bn_pair),
        entry(BN_STATS_SUMS, "batch_norm_act.cu", "adaface_tpu/ops/fused_norm.py:31",
              max(s["abs"] for s in sync_bn["sums"].values()), f"{JSON_BN}, a rank's half",
              sb["graph_ms"], sb["plain_ms"], sb["library_ms"], sb["bound_ms"],
              graph_ms=sb["graph_ms"], library="torch.batch_norm_stats",
              shapes={label: {k: s[k] for k in ("graph_ms", "plain_ms", "library_ms", "bound_ms",
                                                "rows", "c")}
                      for label, s in sync_bn["sums"].items()}),
        entry(BN_NORM_ACT, "batch_norm_act.cu", "adaface_tpu/ops/fused_norm.py:48",
              max(r["norm_err"] for r in bn_cases.values()), JSON_BN, b_["ms_norm"],
              b_["plain_norm"], None, b_["bound_norm"], graph_ms=b_["graph_norm"], **bn_pair),
        entry(LAYER_NORM, "layer_norm.cu", "adaface_tpu/ops/fused_ln.py:25",
              max(ln_errs), JSON_LN, l_["ms"], l_["plain_ms"],
              l_["stock_ms"], l_["bound_ms"], graph_ms=l_["graph_ms"],
              library_graph_ms=l_["stock_graph_ms"], launch_floor_ms=ln["launch floor"],
              shapes=ln_shapes, per_request=ln["per request"]),
        flash_bwd_entry(FLASH_BWD_DELTA, "delta"),
        flash_bwd_entry(FLASH_BWD_DKDV_WG, "dkdv"),
        flash_bwd_entry(FLASH_BWD_DQ_WG, "dq"),
        flash_bwd_entry(FLASH_BWD_DELTA_WIDE, "delta", **{**wide_bwd,
                                                          "source": "flash_attn_bwd_wg.cu"}),
        flash_bwd_entry(FLASH_BWD_DKDV_WIDE, "dkdv", **wide_bwd),
        flash_bwd_entry(FLASH_BWD_DQ_WIDE, "dq", **wide_bwd),
        gn_bwd_entry(GN_BWD_FUSED, "fused", JSON_GN_BWD),
        gn_bwd_entry(GN_BWD_REDUCE, "reduce", JSON_GN_BWD_SPLIT),
        gn_bwd_entry(GN_BWD_DX, "dx", JSON_GN_BWD_SPLIT),
        entry(QUANT_ACT, "int8_conv.cu", "adaface_tpu/ops/quant.py:58", 0.0, JSON_INT8,
              i8["act_graph_ms"], i8["act_plain_ms"], None, i8["act_bound_ms"],
              shapes={k: {"ms": r["act_graph_ms"], "bound_ms": r["act_bound_ms"]}
                      for k, r in i8_cases.items()}),
        entry(INT8_CONV, "int8_conv.cu", "adaface_tpu/ops/quant.py:67",
              max(r["err"] for r in i8_cases.values()), JSON_INT8, i8["igemm_graph_ms"],
              i8["plain_ms"], None, i8["igemm_bound_ms"], i8["igemm_bound_by"],
              replaces_also="adaface_tpu/ops/quant.py:85", cudnn_bf16_ms=i8["cudnn_bf16_graph_ms"],
              int_mm_ms=i8["int_mm_graph_ms"], layer_ms=i8["ms"], layer_graph_ms=i8["graph_ms"],
              layer_bound_ms=i8["bound_ms"], layer_bound_by=i8["bound_by"],
              layer_host_us=i8.get("host_us"), cudnn_bf16_host_us=i8.get("cudnn_bf16_host_us"),
              shapes={k: {key: r[key] for key in (
                  "igemm_graph_ms", "igemm_bound_ms", "igemm_bound_by", "graph_ms", "ms",
                  "plain_ms", "bound_ms", "cudnn_bf16_graph_ms", "int_mm_graph_ms", "calls",
                  "plan", "igemm_unsplit_graph_ms", "layer_kernels", "layer_memsets",
                  "smem_bytes", "blocks_per_sm")}
                  for k, r in i8_cases.items()},
              per_call={k: r for k, r in int8.items() if k.startswith("per call")}),
    ]}


GATE_COSINE_CPU_TOL = 1e-4  # the gate's ArcFace cosine, card against the CPU


def quality_gate(speed: dict, card: str) -> dict:
    """`scripts/bench_quality_torch.compare` on the images `serve_speed_modes`
    made of the same seeds, the default path's and GATE_MODE's (512x512, 25
    steps): the ArcFace cosine of a random seeded resnet_face18, the pixel
    MAE and correlation, on the card and again on the CPU (the cosine within
    GATE_COSINE_CPU_TOL)."""
    sys.path.insert(0, str(REPO / "scripts"))
    import bench_quality_torch as bq

    ref = torch.stack(speed["gate_images"]["default"])
    turbo = torch.stack(speed["gate_images"]["turbo"])
    t0 = time.perf_counter()
    scores = bq.compare(ref, turbo, bq.random_arcface("cuda"))
    secs = time.perf_counter() - t0
    cpu = bq.compare(ref.cpu(), turbo.cpu(), bq.random_arcface("cpu"))
    apart = abs(scores["arcface_cosine"] - cpu["arcface_cosine"])
    log(f"quality gate: default against {GATE_MODE}, {ref.shape[0]} images of the same seeds at "
        f"512x512: ArcFace cosine {scores['arcface_cosine']:.6f} (CPU {cpu['arcface_cosine']:.6f}"
        f", {apart:.2e} apart, bound {GATE_COSINE_CPU_TOL:g}), pixel MAE "
        f"{scores['pixel_mae']:.6f}, correlation {scores['pixel_corr']:.6f}; compared in "
        f"{secs:.2f} s ({card})")
    if not all(math.isfinite(v) for v in scores.values()) or apart > GATE_COSINE_CPU_TOL:
        raise AssertionError(f"quality gate: {scores} on the card, {cpu} on the CPU")
    if not -1.0 <= scores["arcface_cosine"] <= 1.0 + 1e-6 or scores["pixel_mae"] <= 0.0:
        raise AssertionError(f"quality gate: {scores}")
    return dict(scores, cpu_cosine=cpu["arcface_cosine"], seconds=secs)


PROFILE_BATCH = 8


def profile_stages(wrapper, card: str) -> dict:
    """`scripts/profile_pipeline_torch.profile_stages` at PROFILE_BATCH on the
    SD1.5 modules without adapters (stage times between CUDA events and of
    device time, shares, the loop's overhead, the UNet's MFU), then one
    request at that batch held to its launches by kernel."""
    sys.path.insert(0, str(REPO / "scripts"))
    import profile_pipeline_torch as prof

    from adaface_tpu_torch.inference.pipeline import DiffusionPipeline
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A

    pipe = DiffusionPipeline(dataclasses.replace(wrapper.pipeline.m, attn_lora=None,
                                                 ffn_lora=None))
    r = prof.profile_stages(pipe, PROFILE_BATCH)
    log("profile stages:\n" + prof.report(r, card))
    _build.reset_launch_counts()
    with torch.inference_mode():
        images = pipe([prof.PROMPT] * PROFILE_BATCH, negative_prompt=prof.NEGATIVE_PROMPT,
                      num_inference_steps=prof.STEPS, guidance_scale=6.0,
                      generator=torch.Generator("cuda").manual_seed(SEED + 24))
    torch.cuda.synchronize()
    counts = launch_counts()
    check_images(list(images), PROFILE_BATCH, 512, "profile stages")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = A.flash_plan(torch.bfloat16, PROFILE_BATCH, 1, 4096, 4096, 512, sms).nsplit > 1
    want = {A.FLASH_T: 20 * prof.STEPS, A.FLASH_STD: 10 * prof.STEPS, A.FLASH_WIDE: 1,
            A.FLASH_COMBINE: int(split)}
    got = {k: counts.get(k, 0) for k in want}
    gn = sum(v for k, v in counts.items() if k.startswith("gn_"))
    log(f"profile stages: one request at batch {PROFILE_BATCH}, 512x512, 25 steps: launches "
        f"{dict(sorted(counts.items()))}")
    if got != want or gn == 0:
        raise AssertionError(f"profile stages: launches {counts}, flash expected {want}")
    shares = r["shares"]
    if not (0.0 < r["mfu"] < 1.0 and abs(sum(shares.values()) - 1.0) < 1e-6):
        raise AssertionError(f"profile stages: mfu {r['mfu']}, shares {shares}")
    return dict(r, counts=counts)


TEACHER_IMAGES, TEACHER_STEPS = 2, 8


def teacher_sanity(wrapper, card: str) -> dict:
    """`scripts/test_img_prompt_model_torch.teacher_images` (the teacher CLI's
    chain: face ID → image prompts → the simple_unet teacher → decode, no ada
    mapping) on the SD1.5 modules and the Arc2Face encoder: a 256x256,
    2-step run kernels against plain, then TEACHER_IMAGES images at 512x512
    and TEACHER_STEPS steps from the random-ID path, finite, in [0, 1], not
    constant, held to their launches."""
    sys.path.insert(0, str(REPO / "scripts"))
    import test_img_prompt_model_torch as teach

    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.utils.tensor import Draws

    m, enc = wrapper.pipeline.m, wrapper.id2ada_prompt_encoder

    def run(n, steps, hw):
        return teach.teacher_images(enc, m.unet, m.vae, m.schedule,
                                    Draws(torch.Generator("cuda").manual_seed(SEED + 25)),
                                    n, steps, hw)

    _, small_k = run(TEACHER_IMAGES, 2, 256)
    with plain_versions():
        _, small_p = run(TEACHER_IMAGES, 2, 256)
    err = (small_k - small_p).abs().max().item()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    embs, images = run(TEACHER_IMAGES, TEACHER_STEPS, 512)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    check_images(list(images), TEACHER_IMAGES, 512, "teacher sanity")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = A.flash_plan(torch.bfloat16, TEACHER_IMAGES, 1, 4096, 4096, 512, sms).nsplit > 1
    want = {A.FLASH_T: 20 * TEACHER_STEPS, A.FLASH_STD: 10 * TEACHER_STEPS, A.FLASH_WIDE: 1,
            A.FLASH_COMBINE: int(split)}
    got = {k: counts.get(k, 0) for k in want}
    log(f"teacher sanity: image prompts {tuple(embs.shape)}; a 256x256 2-step run kernels "
        f"against plain: image max_abs_err {err:.3e} (bound {IMAGE_TOL:g}); {TEACHER_IMAGES} "
        f"images at 512x512, {TEACHER_STEPS} steps in {secs:.2f} s, std "
        f"{', '.join(f'{im.std().item():.4f}' for im in images)}; launches "
        f"{dict(sorted(counts.items()))} ({card})")
    if err > IMAGE_TOL or got != want:
        raise AssertionError(f"teacher sanity: error {err}, launches {counts}, flash {want}")
    return dict(err=err, seconds=secs, counts=counts)


def toy_dataset(card: str) -> dict:
    """`scripts/make_toy_dataset_torch.py` writes its 2 subjects x 2 images at
    512x512 (PNGs, masks, captions, metainfo.json); an image decodes to the
    pixels its generator makes, and `PersonalizedBase` reads an item of the
    folder."""
    import tempfile

    sys.path.insert(0, str(REPO / "scripts"))
    import make_toy_dataset_torch as toy

    from adaface_tpu_torch.data.personalized import PersonalizedBase
    from adaface_tpu_torch.utils.image import read_image

    with tempfile.TemporaryDirectory(prefix=".toy_", dir=str(REPO)) as tmp:
        t0 = time.perf_counter()
        toy.write_dataset(tmp, n=2, size=512)
        write_s = time.perf_counter() - t0
        img, _ = toy.make_image(np.random.RandomState(1000), 512)
        same = bool(np.array_equal(read_image(os.path.join(tmp, "alice", "0.png")), img))
        ds = PersonalizedBase(tmp, size=512, seed=0)
        t0 = time.perf_counter()
        item = ds[0]
        item_s = time.perf_counter() - t0
    log(f"toy dataset: 2 subjects x 2 images at 512x512 written in {write_s:.2f} s, an image "
        f"read back equal: {same}; PersonalizedBase: {len(ds)} items of {ds.subject_names}, "
        f"item 0 in {item_s * 1e3:.1f} ms: image {item['image'].shape}, fg "
        f"{float(item['fg_mask'].mean()):.3f}, caption {item['caption']!r} ({card})")
    if not same or len(ds) != 4 or item["image"].shape != (512, 512, 3) \
            or not np.isfinite(item["image"]).all() or item["fg_mask"].max() != 1:
        raise AssertionError("toy dataset: the folder or its item is off")
    return dict(write_s=write_s, item_ms=item_s * 1e3)


def timed_phase(name: str, fn, *args):
    """fn(*args), with its seconds logged: where the whole run's time goes."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t0 = time.perf_counter()
    card = require_cuda()
    build_kernels()
    flash, gn, bn, ln, flash_bwd, gn_bwd = timed_phase("check_kernels", check_kernels)
    int8 = timed_phase("check_int8", check_int8,
                       torch.Generator(device="cuda").manual_seed(SEED + 16))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tp_flash = timed_phase("check_flash_tp", check_flash_tp,
                           torch.Generator(device="cuda").manual_seed(SEED + 25))
    timed_phase("check_autograd_functions", check_autograd_functions)
    unet = timed_phase("check_unet", check_unet, gen)
    wrapper, faces = build_server(gen)
    served = timed_phase("serve", serve, wrapper, faces)
    from_files = timed_phase("serve_from_files", serve_from_files, wrapper)
    batched = timed_phase("serve_batched", serve_batched, wrapper, faces)
    timed_phase("batcher_against_pipeline", batcher_against_pipeline, wrapper, faces)
    img2img = timed_phase("serve_img2img", serve_img2img, wrapper, faces)
    sampled = timed_phase("serve_samplers", serve_samplers, wrapper, faces)
    joint = timed_phase("serve_joint", serve_joint, wrapper, faces, gen)
    trained = timed_phase("serve_trained", serve_trained, wrapper, faces, card)
    speed = timed_phase("serve_speed_modes", serve_speed_modes, wrapper, faces, card)
    gate = timed_phase("quality_gate", quality_gate, speed, card)
    del speed["gate_images"]
    stages = timed_phase("profile_stages", profile_stages, wrapper, card)
    teacher = timed_phase("teacher_sanity", teacher_sanity, wrapper, card)
    video = timed_phase("serve_video", serve_video, wrapper, faces, card)
    videos = timed_phase("eval_videos", eval_videos, video, faces, card)
    evaluated = timed_phase("evaluate_and_tools", evaluate_and_tools, wrapper, faces, card)
    encoder = wrapper.id2ada_prompt_encoder
    del wrapper
    gc.collect()
    torch.cuda.empty_cache()
    sdxl = timed_phase("serve_sdxl", serve_sdxl, encoder, faces, card)
    sd3 = timed_phase("serve_sd3", serve_sd3, encoder, faces, card)
    del encoder

    def release():
        # a phase's trainer lives in reference cycles (its patched hooks):
        # collect them, so the next phase's peak memory is its own
        gc.collect()
        torch.cuda.empty_cache()

    release()
    sd15_bits = timed_phase("check_sd15_bits", check_sd15_bits, card)
    timed_phase("run_tools", run_tools, card)
    decoded = timed_phase("decode_images", decode_images, card)
    toy = timed_phase("toy_dataset", toy_dataset, card)
    parser = timed_phase("train_face_parser", train_face_parser, gen)
    release()
    folder = timed_phase("train_face_parser_folder", train_face_parser_folder, gen)
    release()
    stage1 = timed_phase("train_stage1", train_stage1, gen)
    release()
    joint_fit = timed_phase("train_stage1_joint", train_stage1_joint, card)
    release()
    dp = timed_phase("train_dp", train_dp, card)
    sync_bn = timed_phase("check_sync_bn", check_sync_bn, card, dp["sync_bn_ranks"])
    finetune = timed_phase("train_finetune", train_finetune, gen)
    release()
    stage2 = timed_phase("train_stage2", train_stage2, gen)
    release()
    recipes = timed_phase("train_stage2_recipes", train_stage2_recipes, gen, card)
    release()
    tp = timed_phase("train_tp", train_tp, card)
    log(f"card: {card}; whole run {time.perf_counter() - t0:.1f} s")
    # each kernel's launches in the path that runs it
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops.fused_gn import GN_BWD_DX, GN_BWD_FUSED, GN_BWD_REDUCE
    from adaface_tpu_torch.ops.fused_ln import LAYER_NORM
    from adaface_tpu_torch.ops.fused_norm import BN_STATS_SUMS
    from adaface_tpu_torch.ops.quant import INT8_CONV, QUANT_ACT

    counts = {**served["counts"], **parser["counts"], BN_STATS_SUMS: sync_bn["counts"][BN_STATS_SUMS],
              **{k: speed["int8_counts"][k] for k in (QUANT_ACT, INT8_CONV)},
              LAYER_NORM: unet["ln_counts"][LAYER_NORM],
              **{k: stage1["counts"][k] for k in (A.FLASH_BWD_DELTA, A.FLASH_BWD_DKDV_WG,
                                                 A.FLASH_BWD_DQ_WG, GN_BWD_FUSED)},
              **{k: finetune["counts"][k] for k in (A.FLASH_BWD_DELTA_WIDE,
                                                   A.FLASH_BWD_DKDV_WIDE, A.FLASH_BWD_DQ_WIDE,
                                                   GN_BWD_REDUCE, GN_BWD_DX)}}
    paths = {"request from WebP, palette PNG and CMYK JPEG photos": from_files["counts"],
             "batcher": batched["counts"], "img2img": img2img["counts"],
             **{name: r["counts"] for name, r in sampled.items()},
             "joint": joint["counts"], "joint batcher": joint["batch_counts"],
             "adapters": trained["counts"], "adapters batcher": trained["batch_counts"],
             "ensemble": trained["ensemble_counts"],
             "stage-1 fit": stage1["counts"], "stage-1 joint fit": joint_fit["counts"],
             "finetune fit": finetune["counts"],
             "stage-2 fit": stage2["counts"], "stage-2 recipes fit": recipes["counts"],
             "mkv request": recipes["served"]["counts"],
             **{f"speed mode {name}": r["counts"] for name, r in speed["modes"].items()
                if "counts" in r},
             "int8 batcher": speed["drain_counts"],
             "sdxl 2 requests 1024x1024": sdxl["counts"], "sd3 2 requests 1024x1024": sd3["counts"],
             "text2video 16-frame clip": video["counts"],
             f"eval run {EVAL_PROMPTS} prompts x {EVAL_SAMPLES} samples": evaluated["counts"],
             "face-parser folder fit": folder["counts"], "sync-BN a rank": sync_bn["counts"],
             "stage-1 dp fit rank 0": dp["fits"]["rank0"]["counts"],
             f"profile stages batch {PROFILE_BATCH} request": stages["counts"],
             "teacher sanity 2 images 8 steps": teacher["counts"],
             "dp adversarial recon iteration rank 0": dp["adv"]["counts"],
             **{f"{case} rank 0": r["counts"] for case, r in tp["rows"].items()}}
    flash_bwd = {**flash_bwd, **stage2["flash_bwd"]}
    gn_bwd = {**gn_bwd, **stage2["gn_bwd"]}
    record = kernel_record(flash, gn, bn, ln, flash_bwd, gn_bwd, int8, counts, paths, sync_bn)
    record["checks"] = {"sd15_bits": sd15_bits, "decoded_fixtures": decoded["equal"],
                        "decode_512_ms": decoded["decode_512_ms"],
                        "served_from_files": {k: from_files[k] for k in ("load_ms", "request_s")},
                        "joint_reloaded_equal": joint_fit["reloaded_equal"],
                        "video_gif_decode_ms": videos["decode_ms"],
                        "dp_update_rel_l2": dp["update_rel_l2"], "dp_loss_rel": dp["loss_rel"],
                        "dp_adv_loss_rel": dp["adv"]["loss_rel"],
                        "dp_adv_noise_rel": dp["adv"]["noise_rel"],
                        "dp_adv_noise_split_rel": dp["adv"]["noise_split_rel"],
                        "dp_adv_noise_envelope": dp["adv"]["noise_envelope"],
                        "quality_gate": {k: gate[k] for k in ("arcface_cosine", "pixel_mae",
                                                              "pixel_corr", "cpu_cosine")},
                        "profile_stages": {k: stages[k] for k in (
                            "text_ms", "unet_ms", "loop_ms", "decode_ms", "text_device_ms",
                            "unet_device_ms", "loop_device_ms", "decode_device_ms", "mfu",
                            "mfu_device", "loop_overhead_ms")},
                        "teacher_err": teacher["err"], "toy_item_ms": toy["item_ms"],
                        "tp": {case: {"bf16_loss_rel": r["bf16"][0],
                                      "bf16_grad_rel_l2": r["bf16"][1],
                                      "fp32_loss_rel": r["fp32"][0],
                                      "fp32_grad_rel_l2": r["fp32"][1],
                                      "ranks_equal": r["bf16_equal"] and r["fp32_equal"],
                                      "rank_s": r["bf16_s"], "one_process_s": r["bf16_plain_s"]}
                               for case, r in tp["rows"].items()},
                        "tp_flash": tp_flash}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
