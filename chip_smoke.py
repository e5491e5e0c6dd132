#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the VQ-VAE codec's inference path and its training step
(configs.VQVAE_TPU, full published width, random seeded weights), then the
Transformer LM, Glow-TTS's serving and training paths and VQ-TTS's training
path, through the entry points a user calls, with every kernel built from
csrc/ in this checkout:

  1. device: torch/CUDA versions, the card's name and power limit;
  2. build: nvcc for sm_90a, one process per source, with ptxas's register
     and shared-memory report, B1's resident blocks per SM, and no B1 kernel
     spilling; the same for B3's and B6's tensor-core forward and backward
     kernels (their registers and spills; the backwards' resident blocks
     and dynamic shared memory), and B5's (the forward's and the
     backward's instances, none spilling; the resident blocks of its
     192-column LayerNorm tile, its 64 x 128 and 64 x 64 tiles and its
     weight-gradient slices), and B2's forward's and B4's instances, none
     spilling;
  3. each GatedHiFi block shape of the path (batch 16, W=64), forward kernel
     against its plain PyTorch version in fp32 (TF32 off), with both times
     and the kernel's over 50 back-to-back calls (p=0);
  4. the inference path at batch 16 x 66048 samples: encode, decode and the
     eval forward, counting kernel launches (7 per encode, 7 per decode, 14
     per forward);
  5. the same model on the CPU (plain path) on a 2 x 22016 subset: codes,
     reconstruction and losses;
  6. encode + decode wall time and peak memory at batch 16 x 66048;
  7. each block shape, backward kernels (tile passes and weight-gradient
     reduction) against plain autograd, at p=0 and at p=0.1: dx and every
     weight gradient, two calls bitwise equal, both times; the tile passes
     and the reduction over 50 back-to-back calls, beside the reduction's
     products as one torch.mm each (the library yardstick);
  8. the dropout law on the card: the kernel's masks (read from its
     backward buffers) equal the plain version's bit for bit, keep rates
     within 5 sigma of 0.9, one seed reproduces and another differs, and the
     train-mode forward equals the plain version;
  9. the training path at batch 16 x 66048: lazy codebook init, then 5 train
     steps (dropout 0.1, Adam, codebook and parameter EMA), 14 forward and
     14 backward launches per step, step time and mel-frames/s;
 10. one train step on the card against the CPU (plain path) on a
     2 x 22016 subset, dropout 0 and no codebook revival: losses, and grads
     as close to the same step in fp64 as the CPU's fp32 grads are.

Then the Transformer LM (configs.TRANSFORMER_LM_TPU, 12 layers, d_model
512, 16 heads of 32, seeded flax-default weights) over the frozen codec of
phases 4-6, grafted with load_vqvae_into_lm:

 11. the small-T attention kernels against their plain versions at
     (B, T) = (8, 258), (64, 258) and (8, 1024), H=16, D=32, ragged lengths,
     at p=0 and p=0.1: the forward, dq/dk/dv of the recompute backward, two
     forward and two backward calls bitwise equal, both times; the forward
     and the backward also over 50 back-to-back calls, beside SDPA's
     forward and backward back to back (p=0); the kernel's dropout masks
     read back bit for bit against the plain version's, keep rate within
     5 sigma of 0.9, one seed reproduces and another differs;
 12. the LM training path at batch 8 x 258 and 64 x 258 tokens (dropout
     0.1, Adam with the LM's warm-up, parameter EMA, the codec frozen): 5
     steps each, 12 attention forward and 12 backward launches per step and
     no GatedHiFi launch, every trainable parameter moves and the codec and
     codebook stay bitwise unchanged; step time and tokens/s;
 13. the val step on the EMA parameters: 12 attention forward launches and
     one codec decode's GatedHiFi launches, audio of the argmax codes;
 14. KV-cached sampling of 344 codes at batch 4 and 16, then the codec
     decode: no attention launch, one decode's GatedHiFi launches, tokens/s
     and the decode's share; the cached decode's logits against a full
     teacher-forced forward over the sampled prefix;
 15. one LM train step on the card against the CPU (plain path) on a
     2 x 64 subset at dropout 0: losses and gradients.

Then Glow-TTS (configs.GLOW_TTS_TPU with configs.LJSPEECH_TPU: encoder 6
layers of 192, 2 heads of 96, window 4; decoder 12 flow blocks over 160
squeezed channels, WN hidden 192, 4 layers, k=5; seeded JAX initializers
with the zero-init leaves drawn from the seed):

 16. the coupling-conditioner kernel (B3, 3xTF32 on the tensor cores)
     against its plain version at (B, squeezed T) = (8, 384), (1, 512),
     (8, 512) and (3, 7), ragged lengths, 1e-5 of max|ref| at valid frames,
     two calls bitwise equal; both times, at (8, 384) also over 50
     back-to-back calls, and the bounds; then at B3_OTHER_SHAPES (phase
     22's), p=0 and 0.05, with the same tolerance and bitwise repeats;
 17. the encoder-layer kernel (B5, its products 3xTF32 on the tensor cores)
     against its plain version at (B, T) = (8, 256), (1, 160), (8, 512),
     (3, 3) and (4, 64) (VQ-TTS's train step on B5's encoder route), ragged
     lengths, 1e-4 of max|ref| at valid rows; both times and
     the bounds, and at (8, 256) the forward over 50 back-to-back calls;
 18. the MAS kernel (B4) against its plain version bit for bit at
     [8, 256, 768] and [8, 512, 1024], ragged masks, and with exact ties,
     then at MAS_EDGE_SHAPES ([3, 77, 301], [2, 1024, 1024], batch 1, more
     valid tokens than frames, [8, 256, 1536]); one call and 50 back-to-back
     calls, and the chain's ns per frame: the slope of the back-to-back
     time between 768 and 1536 frames at t_x = 256;
 19. the val step (make_val_step, EMA parameters) at batch 8: 768 frames of
     seeded audio (the mel computed on the card) and 256 tokens, ragged;
     launches (B5, B3, B4, B6) = (6, 24, 1, 0) per step, finite losses, step
     time;
 20. synthesis through GlowTTSSynthesizer.synthesize_ids at batch 1 and 8,
     100-256 tokens, max_frames 1024, 32 Griffin-Lim iterations: the flow
     cache built once and equal to the uncached path, (6, 12, 0, 0) launches per
     call, the median of 5 of the mel and text-to-waveform times, seconds of
     audio per second;
 21. the eval forward on the card against the CPU on 2 sequences: losses
     1e-4 relative, yh 1e-4 of max|yh| with the same noise, and MAS run on
     the CPU on the card's log-prior table equal to the card's path;
 22. B3's backward kernels against its plain backward at the shapes of
     phase 16, p=0 and the decoder's 0.05: dx0 1e-4 of max|ref| at valid
     frames, every weight gradient 1e-3 of its leaf's max|ref| (floored at
     3e-4 of the largest leaf's), two calls bitwise equal, the train-mode
     forward against the plain one; the kernels' masks, read back from the
     recompute's conv outputs (biases of 10 make them all positive), equal
     the plain version's bit for bit, keep rate within 5 sigma, one seed
     reproduces and another differs; both times and the bound, and at
     (8, 384), p=0.05 the backward over 50 back-to-back calls; then the
     backward at the other taps, rates and widths of B3_OTHER_SHAPES (k=3
     at rate 2 with Glow's widths; k=5 at rate 3 and k=1 at widths that are
     not multiples of 4, x0 a view at an odd stride and offset) with the
     same tolerances and two calls bitwise equal;
 23. the same for B5 at the shapes of phase 17, p=0 and the encoder's 0.1,
     the plain backward taken at the kernel's own FFN relu decisions (every
     flip a near-tie), the masks of all four sites read back from the
     backward's buffers (the attention's on the band, every pair at T=3);
     at (8, 256), p=0.1 the backward over 50 back-to-back calls;
 24. the Glow-TTS training path at batch 8 x 768 frames of seeded audio
     (the mel on the card) and 256 tokens, ragged: ddi_init (each ActNorm's
     output then has mean 0 and variance 1 at valid frames), then 10 train
     steps with dropout, AdamW + Noam and the parameter EMA; launches (B5
     fwd, B5 bwd, B3 fwd, B3 bwd, B4, B6 fwd, B6 bwd) = (6, 6, 12, 12, 1, 0,
     0) per step, every parameter a finite nonzero gradient, finite losses;
     step time (median of steps 4-10), mel-frames/s and peak memory;
 25. one train step (p=0) on the card against the CPU on 2 sequences:
     losses 1e-4 relative, and the card's and the CPU's gradients each
     against the same step in fp64 on the CPU: the card's median parameter
     within 20x the CPU's and its worst within 10x.

Then the whole-flow-step route (B6, GLOW_TTS_TPU with fused_flow_step: true,
the override glow_tts_tpu.yaml names):

 26. the flow-step kernels (B6: ActNorm + InvConvNear + the coupling
     conditioner) against their plain versions at the shapes of phase 16,
     p=0 and 0.05, on the first flow step's weights (ActNorm drawn, the
     InvConvNear a rotation, the end conv drawn): xc and out 1e-5 of max|ref|
     at valid frames, two forward calls bitwise equal, at (8, 384), p=0.05
     the forward also over 50 back-to-back calls; dx, daln, dalb, dmt and
     every conditioner gradient at phase 22's tolerances and floor; two
     backward calls bitwise equal; the
     B3 route (plain ActNorm and InvConvNear, B3's kernels) through autograd
     against the B6 route: outputs and the prefix's gradients; the kernels'
     masks read back bit for bit against the B3 plain version's; the times
     of both routes, the plain versions and the bounds, and at (8, 384),
     p=0.05 the backward over 50 back-to-back calls; the forward (as in
     phase 16) and the backward (as in phase 22) at B3_OTHER_SHAPES;
 27. phase 24 on the B6 route in the same process (the same model seed,
     batch and dropout draws): ddi_init (B3), then 10 train steps; launches
     (6, 6, 0, 0, 1, 12, 12) per step, every parameter (each ActNorm's and
     InvConvNear's included) a finite nonzero gradient, step 1's loss
     within 1e-3 of phase 24's; the A/B of step time (median of steps
     4-10), mel-frames/s and peak memory, then 20 more steps of each route
     in turns (B3, B6, B6, B3, ...); then the val step on the B6 route:
     launches (B5, B3, B4, B6) = (6, 12, 1, 12) per step;
 28. phase 25 on the B6 route.

Then VQ-TTS (configs.VQTTS_TPU with configs.LJSPEECH_TPU: the codec at
width 64 and depth 3, 256x down; the text encoder 6 layers of 192; the
grouped codebook of 149 x 512 codes of 128; seeded initializers with the
zero-init leaves drawn; batch 4 x 2 s, 44032 samples, 64 tokens, ragged, the
JAX package's A/B shape):

 29. B1 at VQ-TTS's eight depth-3 block shapes (batch 4, T = 22016 ...
     172): the forward against its plain version at p=0 (phase 3's checks
     and times) and p=0.1 (two calls bitwise equal), the backward's masks
     read back bit for bit at every shape (keep rates within 5 sigma), and
     the tile passes and the reduction at p=0 and 0.1 (phase 7's checks);
 30. 10 train steps with dropout at every site, Adam and the codebook and
     parameter EMAs, the codebook's lazy init inside step 1, on the config's
     encoder route (fused_encoder: false, the plain layer) and on B5's:
     launches (B1 fwd, B1 bwd, B1 red, B4, B5 fwd, B5 bwd) = (16, 16, 16, 1,
     0, 0) and (16, 16, 16, 1, 6, 6) a step, no op that waits for the card
     after step 1 (torch.cuda's sync debug mode), every gradient finite;
     step time (median of steps 2-10), audio seconds per second and peak
     memory, then 20 more steps of each route in turns;
 31. the val step on the EMA parameters: (24, 0, 0, 1, 0, 0) launches (the
     decoder runs twice in eval), finite losses and yh, q_acc;
 32. one train step (p=0, revival off, the codebook drawn once on the card
     from other audio) on the card against the CPU on 2 sequences, each
     against the same step in fp64, on the config's encoder route and then
     on B5's (the card's step launching B5 (6, 6) times there, (0, 0) on the
     config's): the MAS path and the codes first (equal to the CPU's, and B4
     on the card's own value table bit for bit equal to the plain MAS), the
     losses within 1e-4, and the card's gradients within 20x (median
     parameter) and 10x (worst) the CPU fp32 step's distance from fp64.

Then B1's bf16 mode and the VQ-VAE's bf16 mixed-precision train step (the
JAX package's shipped training configuration, train.py --bf16; bf16
products outside the kernels sum in fp32: allow_bf16_reduced_precision_
reduction off from phase 1 on, as TF32 is):

 33. whether the bf16 MMA's fp32 accumulation truncates (bf16_mma_probe: an
     accumulator of +-1 plus one product of 0.75 of its ulp), and the same
     for wgmma (wgmma_probe, which also holds both operand layouts B1's bf16
     backward reads, K-major and MN-major, exact on a product of small
     integers: it decides the reduction's 1,024-frame flush);
 34. B1's bf16 forward (csrc/gated_hifi_fwd_bf16.cu: the bf16 backward's
     expand stage, a conv stage with fp32 sums a k-slice, then zp, the gate
     and u Wg in one stage, on TMA-fed wgmma) against its plain bf16 version at each block shape
     of phase 3 (batch 16), p=0 (times: 50 back-to-back calls, one call,
     the plain version) and p=0.1: at least 99% of the valid elements
     within one bf16 ulp of their own magnitude and every one within 2^-6
     of max|ref|, exact zeros past the lengths, two calls bitwise equal;
     the bf16 backward kernels' dropout masks read back bit for bit at
     every shape, keep rates within 5 sigma; the forward's device time by
     kernel at the largest shape (torch.profiler) beside the bytes a frame
     its design moves;
 35. B1's bf16 tile passes and reduction (csrc/gated_hifi_bwd_bf16.cu:
     TMA-fed wgmma, bf16 cotangents and fp32 bias partials) against the
     plain bf16 backward at each shape, p=0 and 0.1, taken at the kernel's
     own relu and dropout decisions (each flip within 2^-9 of max|value| of
     0, one bf16 ulp of an operand's reach): dx as in phase 34, every
     weight gradient within 2^-7 relative L2 and 2^-6 of max|ref| (sums
     over up to 528K frames), the reduction alone on the plain version's
     buffers the same, two calls bitwise equal; at p=0.1 the times and the
     reduction's products as bf16 torch.mm with fp32 outputs, and the
     bytes a frame both move by design;
 36. the bf16 train step at batch 16 x 66048 (harness.make_train_step_for
     with train: {bf16: true}; AdamW, codebook and parameter EMA, dropout
     0.1), in turns with the fp32 step (information, no claim): launches
     (fp32 fwd, bwd, red, bf16 fwd, bwd, red) = (0, 0, 0, 14, 14, 14) a
     bf16 step and (14, 14, 14, 0, 0, 0) an fp32 one, masters and codebook
     fp32, finite losses; the median of steps 2-9 of each, a JSON line with
     vqvae_train_mel_frames_per_sec_per_chip, the peak memory a step, one
     bf16 step's device-busy share under torch.profiler;
 37. one bf16 train step (SGD, p=0, revival off) on the card and on the
     CPU on a 2 x 11008 subset, each against the same step in fp64: losses
     within 2^-8, and the card's update error (median over the parameters
     and over all of them at once) within 2x the CPU bf16 step's.

Then the bf16 modes of B3, B5, B6 and B2 and the bf16 train steps of
Glow-TTS (both decoder routes), VQ-TTS (both encoder routes) and the LM:
B3's and B6's bf16 kernels at B3_SHAPES and B3_OTHER_SHAPES and B5's at
B5_SHAPES (and at B5_SWEEP's kernel sizes and windows) against their plain
bf16 versions (relative L2 2^-7, 2^-6 of
max|ref|; B3 and B6 also each conditioner layer at the backward's own
recomputed x_in and the end conv on its skip sum, 99% within one ulp, their
masks read back bit for bit, and the backward by launch kind with its bytes
a frame by design; B3's, B5's and B6's forwards are their backward's
recompute launches, their buffers held to the backward's bit for bit, and
timed by launch kind), B1's at
VQ-TTS's shapes, B2's bf16 kernels at ATTN_SHAPES and ATTN_BF16_EDGES, p=0
and 0.1 (beside bf16 SDPA, by launch kind, masks read back at every shape);
each bf16 step with its ms, peak,
busy share and launches; and one bf16 SGD step of Glow-TTS on each route,
VQ-TTS on each route and the LM, on the card and the CPU against fp64,
within 2.5x the CPU's error, a control (the card's update x 1.2) failing.

Last, phase_cli_pipeline drives the training CLI and the tokenizer as a user
runs them (scripts/train.py, scripts/generate_vq_dataset.py, in process) in
a temporary directory, at published widths: a seeded corpus of 42 clips of
2-6 s (scripts/make_synth_dataset.py); the codec (vqvae_tpu on ljspeech,
full clips, batch 8, --bf16 --ema, 2 epochs of 4 steps, checkpoints every 4
steps, val every epoch); a resume from ckpt.4, restored at step 4, that
trains on to step 8 with its schedule; the tokenizer on ckpt.last (42
pickles, metadata, each pickle's audio equal to the loader's, two clips'
codes encoded again on the CPU); the LM (transformer_lm_tpu through the
grafted codec, batch 8, --bf16 --ema, 1 epoch and val) on those tokens;
Glow-TTS (glow_tts_tpu with ddi: true, on ljspeech_tpu, batch 8, --bf16, 1
epoch and val: DDI, ckpt.0, Griffin-Lim audio). Each run prints its wall
time, steps, median step time (each step synced) and peak memory; the
kernels line gains each kernel's launches over these runs (cli_launches).

Every phase raises on failure, so the script exits non-zero; there is no CPU
fallback. The line before the last is the kernels' JSON summary; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import ctypes
import functools
import json
import logging
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Optional

import numpy as np
import torch

from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.device import cuda_device
from speech_masters_thesis_tpu_torch.inference import GlowTTSSynthesizer
from speech_masters_thesis_tpu_torch.models.base import spect_from_audio
from speech_masters_thesis_tpu_torch.models.ema import default_mu
from speech_masters_thesis_tpu_torch.models.glow_tts import flows as glow_flows
from speech_masters_thesis_tpu_torch.models.glow_tts import model as glow_model_module
from speech_masters_thesis_tpu_torch.models.glow_tts.model import GlowTTS
from speech_masters_thesis_tpu_torch.models.vqtts import bottleneck as vqtts_bottleneck
from speech_masters_thesis_tpu_torch.models.vqtts import model as vqtts_model
from speech_masters_thesis_tpu_torch.models.vqtts.model import VQTTS
from speech_masters_thesis_tpu_torch.models.vqvae.blocks import GatedHiFiBlock
from speech_masters_thesis_tpu_torch.models.transformer_lm.model import (
    BOS,
    OFFSET,
    PAD,
    load_vqvae_into_lm,
)
from speech_masters_thesis_tpu_torch.models.vqvae.model import compression_factor
from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops import attention as att
from speech_masters_thesis_tpu_torch.ops import enc_layer as enc_ops
from speech_masters_thesis_tpu_torch.ops import flow_step as fs_ops
from speech_masters_thesis_tpu_torch.ops import gated_hifi as gh
from speech_masters_thesis_tpu_torch.ops import mas as mas_ops
from speech_masters_thesis_tpu_torch.ops import wn_coupling as wn_ops
from speech_masters_thesis_tpu_torch.data.ljspeech import LJSpeech
from speech_masters_thesis_tpu_torch.scripts import generate_vq_dataset
from speech_masters_thesis_tpu_torch.scripts import train as train_cli
from speech_masters_thesis_tpu_torch.scripts.make_synth_dataset import write_corpus
from speech_masters_thesis_tpu_torch.train import checkpoint, harness
from speech_masters_thesis_tpu_torch.train.loop import make_train_step, make_val_step, raise_if_not_finite
from speech_masters_thesis_tpu_torch.train.optim import build_optimizer
from speech_masters_thesis_tpu_torch.train.state import TrainState
from speech_masters_thesis_tpu_torch.utils.config import load_config
from speech_masters_thesis_tpu_torch.utils.registry import get_model
from speech_masters_thesis_tpu_torch.utils.scalars import read_scalars

BATCH = 16
SAMPLES = 66048                # 3 s at 22.05 kHz, a multiple of 128
BLOCK_TS = [33024, 16512, 8256, 4128, 2064, 1032, 516]  # every block length on the path
SUBSET = (2, 22016)            # the CPU comparison's batch and samples
KERNEL_RTOL = 1e-4             # of max|ref|: fp32, but another summation order
RECON_RTOL = 1e-4              # of max|y|: 14 blocks and 16 convs, fp32, TF32 off
LOSS_RTOL = 1e-4
CODE_AGREEMENT = 0.999
DX_RTOL = 1e-4                 # of max|ref|: fp32, another summation order
WGRAD_RTOL = 1e-3              # of each leaf's max|ref|: sums over up to 528K frames
FLIP_RTOL = 1e-5               # a relu decision may flip only within this of max|value| of 0
P_DROP = 0.1                   # the JAX package's default (models/vqvae/model.py)
TRAIN_STEPS = 5
TRAIN_SEED = 6
STEP_LOSS_RTOL = 1e-4          # card vs CPU train step: fp32, other summation orders
STEP_GRAD_MEDIAN_ATOL = 1e-4   # phase 10: card's gradient error against fp64, beyond 2x the
STEP_GRAD_WORST_ATOL = 1e-3    # CPU fp32's (median and worst parameter; relu decisions may flip)
HOP = 256                      # samples per mel frame (the JAX package's data config)
SOURCE_DIR = "speech_masters_thesis_tpu_torch/csrc/"
PALLAS = "speech_masters_thesis_tpu/ops/pallas/gated_hifi.py"
PALLAS_ATTENTION = "speech_masters_thesis_tpu/ops/pallas/attention.py"
# the Transformer LM
ATTN_SHAPES = ((8, 258), (64, 258), (8, 1024))  # (B, T): the LM's train shapes and the route's bound
ATTN_BF16_EDGES = ((3, 1), (3, 3), (3, 63), (3, 65), (2, 257))  # B2 bf16's odd T (lens T, ..., 1)
ATTN_HEADS, ATTN_DIM = 16, 32
ATTN_FWD_RTOL = 1e-5           # of max|ref|: fp32, an online softmax against a two-pass one
ATTN_GRAD_RTOL = 2e-5          # of each gradient's max|ref|: sums over up to 1024 rows, other order
LM_BATCHES = (8, 64)
LM_T = 258                     # BOS + 256 codes, padded (the JAX package's LM train shape)
LM_STEPS = 5
LM_SEED = 11
SAMPLE_BATCHES = (4, 16)
SAMPLE_STEPS = 344             # 2 s of audio, the JAX bench's length (benchmarks/run_benchmarks.py:57)
KV_RTOL = 1e-4                 # of max|logit|: 12 layers, cached single-row attention vs the kernel
LM_SUBSET = (2, 64)
LM_LOSS_RTOL = 1e-5            # card vs CPU LM step: fp32, other summation orders
LM_GRAD_MEDIAN_RTOL = 1e-5     # relative L2 per parameter, denominator floored at 1e-4 of the
LM_GRAD_WORST_RTOL = 1e-3      # global gradient norm (the key bias's true gradient is zero)
# Glow-TTS
PALLAS_WN = "speech_masters_thesis_tpu/ops/pallas/wn_coupling.py"
PALLAS_MAS = "speech_masters_thesis_tpu/ops/pallas/mas.py"
PALLAS_ENC = "speech_masters_thesis_tpu/ops/pallas/enc_layer.py"
# (B, squeezed frames): the val step's, a synthesis call's, the route's bound, one shorter than a tile
B3_SHAPES = ((8, 384), (1, 512), (8, 512), (3, 7))
# (B, T, half, hidden, taps, rate, layers): the backwards' other taps, rates and widths (not multiples of 4)
B3_OTHER_SHAPES = ((3, 64, 80, 192, 3, 2, 4), (3, 64, 10, 30, 5, 3, 3), (2, 48, 6, 9, 1, 1, 2))
# (B, tokens): the val step's, one utterance, the route's bound, one shorter than the window, VQ-TTS's
# train step's (fused_encoder: true)
B5_SHAPES = ((8, 256), (1, 160), (8, 512), (3, 3), (4, 64))
# phase_bf16_enc_layer's sweep of the bf16 layer's other kernel sizes and
# windows (k, window), at one ragged shape: the smallest and largest window
# (band widths 1 and 17) at kernel sizes 1 and 5
B5_SWEEP_SHAPE, B5_SWEEP = (4, 64), ((1, 0), (1, 8), (5, 0), (5, 8))
MAS_SHAPES = ((8, 256, 768), (8, 512, 1024))  # [B, t_x, t_y]
# B4's edge shapes: t_x and t_y off the kernel's multiples of 32 and of its chunk, t_x at the wrapper's
# limit, one sequence, more valid tokens than frames, and twice the frames of MAS_SHAPES[0] (the slope)
MAS_EDGE_SHAPES = ((3, 77, 301), (2, 1024, 1024), (1, 256, 768), (2, 256, 96), (8, 256, 1536))
MAS_INSTANCES = 6              # mas_kernel<KW> for KW = 1, 2, 4, ..., 32 tokens a lane
B3_RTOL = 1e-5                 # of max|ref| at valid frames: fp32, other summation orders
B5_RTOL = 1e-4                 # of max|ref| at valid rows: fp32, an online softmax and other orders
GLOW_BATCH, GLOW_FRAMES, GLOW_TOKENS = 8, 768, 256
SYNTH_BATCHES = (1, 8)
SYNTH_MIN_TOKENS = 100           # token lengths 100-256
SYNTH_MAX_FRAMES = 1024
SYNTH_REPS = 5
GL_ITERS = 32
GLOW_VS_CPU = 2
GLOW_LOSS_RTOL = 1e-4          # card vs CPU eval losses: fp32, 24 flow steps, other orders
GLOW_YH_RTOL = 1e-4            # of max|yh|
GLOW_SEED = 13
B3_DROP = 0.05                 # the decoder's p_dropout (glow_tts_tpu.yaml)
GLOW_TRAIN_STEPS = 10          # the step time still falls after 5 steps
GLOW_STEADY_FROM = 4           # the step time is the median of steps 4-10
GLOW_AB_ROUNDS = 20            # then 20 more steps of each route, in turns B3, B6, B6, B3, ...
ROUTE_LOSS_RTOL = 1e-3         # step 1's loss, B6 route vs B3 route: the same function and masks; MAS may
                               # flip a near-tie
B5_DROP = 0.1                  # the encoder's
# phases 25 and 28: the card's gradient error against the fp64 step, at most these multiples of the
# CPU fp32 step's. The worst parameter: recorded runs 1.6-2.8x, so 10x. The median: the parameters'
# errors are bimodal (B5's near 6e-7, most of the decoder's near 6e-6, 12-13x the CPU's median, since
# B3's and B6's 3xTF32 kernels), and the median has landed at 2.2-6.9x; a variant without the
# tensor-core kernels' per-k-step fp32 add gave 33x: 20x lies between
GLOW_GRAD_WORST_MULTIPLE = 10
GLOW_GRAD_MEDIAN_MULTIPLE = 20
GRAD_FLOOR = 3e-4              # a gradient leaf's tolerance scale is at least this of the largest leaf's
# VQ-TTS (configs.VQTTS_TPU): the JAX package's A/B shape (vqtts_tpu.yaml, benchmarks/run_benchmarks.py:
# build_vqtts_step): batch 4 x 2 s, 44032 samples (a multiple of 512), 172 code frames, 64 tokens
VQTTS_BATCH, VQTTS_SAMPLES, VQTTS_TOKENS = 4, 44032, 64
VQTTS_DEPTH = 3                # depth 3 x multipliers[-1] 1: branches of kernels 3, 5, 7 and dilations 1, 3, 9
VQTTS_BLOCK_TS = (22016, 11008, 5504, 2752, 1376, 688, 344, 172)  # every block length on the path
VQTTS_SEED = 21
VQTTS_STEPS = 10
VQTTS_STEADY_FROM = 2          # the step time is the median of steps 2-10
VQTTS_AB_ROUNDS = 20           # then 20 more steps of each encoder route, in turns
VQTTS_VS_CPU = 2
VQTTS_LOSS_KEYS = ("loss", "loss_recon", "loss_stft", "loss_commit", "loss_dur", "loss_align", "loss_ce")
# phase 32: the card's gradient error against the fp64 step, at most these multiples of the CPU fp32
# step's (median and worst parameter), phases 25 and 28's multiples: B1's kernels run the same 3xTF32
# engine with an fp32 add a k-step (a flush every 1,024 frames in the reduction)
VQTTS_GRAD_MEDIAN_MULTIPLE = 20
VQTTS_GRAD_WORST_MULTIPLE = 10
# the card's published peaks (NVIDIA H100 SXM data sheet): fp32 on the CUDA cores and HBM3
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12             # dense TF32 on the tensor cores; 3xTF32 takes 3 products per fp32 product
PEAK_BYTES = 3.35e12
DEVICE_REPS = 50               # back-to-back calls per device_ms timing
PEAK_BF16 = 989e12             # dense bf16 on the tensor cores (H100 SXM)
# bf16 (B1's bf16 mode against its plain bf16 version, tests/test_torch_bf16_gated_hifi.py's
# tolerance): an fp32 intermediate within rounding of a bf16 boundary may round one ulp apart
# before the next product, and the output rounds once more
BF16_ULP_SHARE = 0.99          # of elements within one bf16 ulp of their own magnitude
BF16_MAX_RTOL = 2.0 ** -6      # of max|ref|, every element
# a relu decision may flip only within this of max|value| of 0: one bf16 ulp of an operand
# moves a pre-activation by about 2^-8 of one term
BF16_FLIP_RTOL = 2.0 ** -9
# a weight gradient sums up to 528K frames: operands that rounded one ulp apart upstream add an
# error that is absolute, so its elements far below max|ref| miss the per-element ulp; such a
# sum is held by its relative L2 error (and every element by BF16_MAX_RTOL)
BF16_SUM_RTOL = 2.0 ** -7
BF16_TRAIN_ROUNDS = 8          # after one step of each: 8 more of each in turns
BF16_SUBSET = (2, 11008)       # the card-vs-CPU bf16 step's batch and samples
BF16_DATA_SEED = 9             # its audio (bf16_seeds.py runs others)
BF16_SGD = {"name": "sgd", "lr": 1e-3, "momentum": 0.0, "weight_decay": 0.0}
BF16_LOSS_RTOL = 2.0 ** -8     # card vs CPU bf16 step losses
BF16_VS_CPU_MULTIPLE = 2       # the card's bf16 update error against fp64, within this x the CPU bf16 step's (0.6x measured)
# phase 37 without the log-magnitude STFT term: the card's bf16 update error against fp64 within
# this x the CPU bf16 step's (median, all parameters, worst parameter); 0.81-2.03x measured over
# data seeds 9-16, 1.22-1.27x at seed 9. The control, the card's update made 20% too large, must fail it
BF16_LIN_MULTIPLE = 2.5
BF16_CONTROL_SCALE = 1.2
BF16_TRAIN_STEPS = 10          # Glow-TTS's and VQ-TTS's bf16 steps: the median of steps 2-10


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def randomize(module: torch.nn.Module, seed: int) -> None:
    """Seeded random parameters: every weight lecun-normal (std 1/sqrt(fan_in),
    the JAX package's kernel initializer), the zero-initialised gate and
    branch 1x1s included; every bias N(0, 0.1^2). Uniform +-1/sqrt(fan_in)
    weights made the encodings nearly constant across frames (std 0.06
    against a norm of 1.05), so 40% of frames had top-2 code distances
    within 1e-5 and the codes compared near-ties, not the port."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p[0].numel()))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)


def audio_batch(batch: int, samples: int, seed: int):
    rng = np.random.RandomState(seed)
    audio = rng.uniform(-0.5, 0.5, (batch, samples)).astype(np.float32)
    lengths = rng.randint(samples // 2, samples + 1, (batch,)).astype(np.int64)
    lengths[0] = samples
    return torch.from_numpy(audio), torch.from_numpy(lengths)


def bound(flops: float, nbytes: float) -> tuple:
    """(least ms the card could take, "operations" or "bytes"): the larger of
    the operations over the fp32 peak and the bytes over the memory rate."""
    ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def tf32_bound_ms(flops: float, nbytes: float) -> float:
    """The least ms at the 3xTF32 rate: the larger of 3 x the operations over
    the TF32 tensor-core peak and the bytes over the memory rate. Every
    product kernel carries it beside ``bound``'s fp32 CUDA-core bound."""
    return max(3 * flops / PEAK_TF32, nbytes / PEAK_BYTES) * 1e3


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n: int = DEVICE_REPS, warmup: int = 3) -> float:
    """Device time of one call of ``fn()`` in ms: one CUDA-event pair around
    ``n`` back-to-back calls after ``warmup``, over ``n``. While the host
    issues calls faster than the card runs them, this is the card's time
    alone; a call whose host work outlasts its kernels shows the host's."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_device() -> str:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False: this script needs a GPU")
    cuda_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products outside the kernels sum in fp32, as the JAX package's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)} count {torch.cuda.device_count()}")
    print(card)
    return card


KERNEL_NAMES = ("enc_attention_bwd_dq_kernel", "enc_attention_bwd_dkdv_kernel", "enc_attention_kernel",
                "attention_bf16_fwd_kernel", "attention_bf16_dq_kernel", "attention_bf16_dkdv_kernel",
                "attention_fwd_kernel", "attention_bwd_dq_kernel", "attention_bwd_dkdv_kernel",
                "tile_expand_kernel", "tile_conv_kernel", "tile_branch_kernel", "tile_out_kernel",
                "tile_gate_kernel", "tile_dc_kernel", "tile_convt_kernel", "tile_dx_kernel",
                "wgrad_partial_kernel", "wgrad_reduce_kernel", "mas_kernel", "conv_mma_kernel",
                "pack_weights_kernel", "wgrad_mma_kernel", "wgrad_mma_reduce_kernel", "enc_pack_kernel",
                "tile_kernel", "gate16_kernel", "wgrad16_kernel", "wgrad16_reduce_kernel", "bias16_kernel",
                "wgmma_probe_kernel", "branch_conv_kernel", "branch_gate_kernel", "transpose_weights_kernel",
                "wn16_gemm_kernel", "wn16_wsum_kernel", "wn16_wsum_reduce_kernel", "wn16_bias_kernel",
                "wn16_pack_kernel", "enc16_gemm_kernel", "enc16_rows_kernel", "enc16_att_fwd_kernel",
                "enc16_att_dq_kernel", "enc16_att_dkdv_kernel")
# B1's kernels in the order gated_hifi_{fwd,bwd}_blocks_per_sm report them
B1_FWD_KERNELS = ("tile_expand_kernel", "tile_conv_kernel", "tile_branch_kernel", "tile_out_kernel")
B1_BWD_KERNELS = ("tile_expand_kernel", "tile_conv_kernel", "tile_branch_kernel", "tile_gate_kernel",
                  "tile_dc_kernel", "tile_convt_kernel", "tile_dx_kernel", "wgrad_partial_kernel",
                  "wgrad_reduce_kernel")
# B1's bf16 backward (csrc/gated_hifi_bwd_bf16.cu): gated_hifi_bwd_bf16_blocks_per_sm's order (tile_kernel<S>
# for the stages S = 1 ... 7, the gate's elementwise pass, then the reduction's two), and its kernels' names in
# the ptxas report
B1_BF16_BWD_STAGES = ("tile_kernel<1 expand>", "tile_kernel<2 conv>", "tile_kernel<3 branch>",
                      "tile_kernel<4 du>", "tile_kernel<5 dc>", "tile_kernel<6 convt>", "tile_kernel<7 dx>",
                      "gate16_kernel", "wgrad16_kernel", "wgrad16_reduce_kernel")
B1_BF16_BWD_KERNELS = ("tile_kernel", "gate16_kernel", "wgrad16_kernel", "wgrad16_reduce_kernel", "bias16_kernel")
# B1's bf16 forward (csrc/gated_hifi_fwd_bf16.cu): gated_hifi_fwd_bf16_blocks_per_sm's order (the backward's
# stage 1, then its own conv and gate stages; its weights' transpose is a plain grid-stride loop)
B1_BF16_FWD_STAGES = ("tile_kernel<1 expand>", "branch_conv_kernel", "branch_gate_kernel")
B3_B6_KERNELS = ("conv_mma_kernel", "pack_weights_kernel", "wgrad_mma_kernel", "wgrad_mma_reduce_kernel")
# B3's and B6's bf16 forwards and backwards (csrc/wn_coupling_bf16.cu): the product kernel's instances
# (wn16_gemm_kernel<EPI>, EPI as WN16_EPILOGUES names them), the weight sums and their reduction,
# the bias sums and the packing
WN16_KERNELS = ("wn16_gemm_kernel", "wn16_wsum_kernel", "wn16_wsum_reduce_kernel", "wn16_bias_kernel",
                "wn16_pack_kernel")
WN16_EPILOGUES = ("start", "gate", "res/skip", "dskip", "gate bwd", "conv^T", "dx0", "dxc", "xc", "dx1", "end")
WN16_INSTANCES = 15
WN16_SOURCES = ("wn_coupling_bf16.cu", "bf16_engine.cuh", "bf16_engine.cu")
# B5's bf16 forward and backward (csrc/enc_layer_bf16.cu, on bf16_engine.cuh's ring, weight sums and bias
# sums, which WN16_KERNELS count): the product kernel's instances (enc16_gemm_kernel<EPI>, EPI as
# ENC16_EPILOGUES names them), the LayerNorm rows (enc16_rows_kernel<MODE>, ENC16_ROWS: the forward ends in
# "ln2 fwd") and attention's three (<DROP>)
ENC16_KERNELS = ("enc16_gemm_kernel", "enc16_rows_kernel", "enc16_att_fwd_kernel", "enc16_att_dq_kernel",
                 "enc16_att_dkdv_kernel")
ENC16_EPILOGUES = ("qkv", "part", "ffn1", "drelu", "doh", "dx")
ENC16_ROWS = ("ln1 fwd", "ln2 fwd+bwd", "ln1 bwd", "ln2 fwd")
ENC16_INSTANCES = 16
ENC16_SOURCES = ("enc_layer_bf16.cu", "bf16_engine.cuh", "bf16_engine.cu")
# B5's kernels on the tensor cores and its packing (their tags name the layer: LayerFwdTag, LayerBwdTag)
B5_KERNELS = ("conv_mma_kernel", "enc_pack_kernel", "wgrad_mma_kernel", "wgrad_mma_reduce_kernel")
B2_FWD_B4_KERNELS = ("attention_fwd_kernel", "mas_kernel")
# B2's bf16 forward and backward (csrc/attention_bf16.cu, cp.async stages and ldmatrix fragments): <DROP> each
B2_BF16_KERNELS = ("attention_bf16_fwd_kernel", "attention_bf16_dq_kernel", "attention_bf16_dkdv_kernel")
B2_BF16_SOURCES = ("attention_bf16.cu", "attention_common.cuh", "bf16_mma.cuh", "tf32_mma.cuh", "hash.cuh")


def ptxas_summary(report: str) -> list:
    """One line per compiled kernel: its name (with the template tag of the
    mangled name), registers, barriers, shared memory and spills."""
    lines, name, spills = [], None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in KERNEL_NAMES if k in mangled), mangled)
            tag = re.search(r"_kernelI(\w+?)E", mangled)
            name += f"<{tag.group(1)}>" if tag else ""
        elif "spill stores" in line:
            spills = line.strip()
        elif "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}, {spills}")
            name = None
    return lines


def phase_build() -> None:
    t0 = time.perf_counter()
    report = _build.compile_library(_build.library_path())
    _build.build()
    ptxas = ptxas_summary(report)
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} -> {_build.library_path().name} "
          f"in {time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(ptxas)}")
    for name in KERNEL_NAMES:
        require(any(line.startswith(name) for line in ptxas), f"ptxas reports no {name}")
    lib = _build.build()
    launches = (("fwd fp32", B1_FWD_KERNELS, lib.gated_hifi_fwd_blocks_per_sm, "256"),
                ("fwd bf16", B1_BF16_FWD_STAGES, lib.gated_hifi_fwd_bf16_blocks_per_sm, "384; 256 conv and gate"),
                ("bwd fp32", B1_BWD_KERNELS, lib.gated_hifi_bwd_blocks_per_sm, "256"),
                ("bwd bf16", B1_BF16_BWD_STAGES, lib.gated_hifi_bwd_bf16_blocks_per_sm,
                 "384; 256 the gate's pass and the reduce"))
    for what, names, query, threads in launches:
        blocks = (ctypes.c_int * len(names))()
        rc = query(blocks)
        require(rc == 0 and min(blocks) >= 1, f"B1 {what}: blocks per SM {list(blocks)} (cudaError {rc})")
        print(f"[build] B1 {what}: resident blocks per SM ({threads} threads, at the launch's shared memory): "
              + ", ".join(f"{n} {b}" for n, b in zip(names, blocks)))
    b1 = [line for line in ptxas if line.split(":")[0].split("<")[0] in B1_BWD_KERNELS + B1_FWD_KERNELS]
    require(all("0 bytes spill stores" in line for line in b1), f"a B1 kernel spills: {b1}")
    # 13 fp32 instances (the shared three stages twice, RN and not; B5's and B6's reductions share two of
    # the names under their own tags); the bf16 forward's mma.sync instances are gone
    own = [line for line in b1 if "Tag>" not in line.split(":")[0]]
    require(len(own) == 13, f"B1 has {len(own)} instances of the fp32 design, not 13: {own}")
    b1_bf16 = [line for line in ptxas if line.split(":")[0].split("<")[0] in B1_BF16_BWD_KERNELS]
    print("[build] B1 bf16 backward on TMA and wgmma (ptxas: registers, shared memory, spills): " + " | ".join(b1_bf16))
    require(len(b1_bf16) == 11 and all("0 bytes spill stores" in line for line in b1_bf16),
            f"a B1 bf16 backward kernel is missing or spills: {b1_bf16}")
    b1_fwd16 = [line for line in ptxas
                if line.startswith(("branch_conv_kernel", "branch_gate_kernel", "transpose_weights_kernel"))]
    print("[build] B1 bf16 forward's own kernels, the conv and gate stages on TMA and wgmma and the weights' "
          "transpose (ptxas: registers, shared memory, spills): " + " | ".join(b1_fwd16))
    require(len(b1_fwd16) == 3 and all("0 bytes spill stores" in line for line in b1_fwd16),
            f"a B1 bf16 forward kernel is missing or spills: {b1_fwd16}")
    # B3's and B6's kernels on the tensor cores: the forwards' instances (their tags
    # end in FwdTag), and the backwards' (the same instances under each tag)
    mma = [line for line in ptxas if line.split(":")[0].split("<")[0] in B3_B6_KERNELS
           and "LayerFwdTag" not in line and "LayerBwdTag" not in line]
    fwd = [line for line in mma if "FwdTag" in line.split(":")[0]]
    bwd = [line for line in mma if line not in fwd]
    print("[build] B3/B6 forward, tensor-core kernels (ptxas: registers, shared memory, spills): " + " | ".join(fwd))
    print("[build] B3/B6 backward, tensor-core kernels (ptxas: registers, shared memory, spills): "
          + " | ".join(bwd))
    require(len(fwd) >= 4 and all("0 bytes spill stores" in line for line in fwd),
            f"a B3/B6 forward kernel is missing or spills: {fwd}")
    first_form = [line for line in ptxas if "BfloatWnFwdTag" in line or "BfloatFlowFwdTag" in line]
    require(not first_form, f"the bf16 forwards' mma.sync instances are back: {first_form}")
    blocks, smem = (ctypes.c_int * 3)(), (ctypes.c_longlong * 3)()
    rc = lib.wn_coupling_bwd_blocks_per_sm(blocks, smem)
    names = ("conv_mma_kernel (gate, 64 rows x 128)", "conv_mma_kernel (transposed conv, 64 x 64)",
             "wgrad_mma_kernel (64 x 128)")
    print("[build] B3/B6 backward: resident blocks per SM (256 threads) at the launch's dynamic shared memory: "
          + ", ".join(f"{n} {b} at {m} B" for n, b, m in zip(names, blocks, smem)))
    require(rc == 0 and min(blocks) >= 1, f"B3/B6 backward: blocks per SM {list(blocks)} (cudaError {rc})")
    require(len(bwd) >= 2 * len(B3_B6_KERNELS) and all("0 bytes spill stores" in line for line in bwd),
            f"a B3/B6 backward kernel is missing or spills: {bwd}")
    wn16 = [line for line in ptxas if line.split(":")[0].split("<")[0] in WN16_KERNELS]
    print("[build] B3/B6 bf16 forward and backward on TMA and wgmma (ptxas: registers, shared memory, spills): "
          + " | ".join(wn16))
    require(len(wn16) == WN16_INSTANCES and all("0 bytes spill stores" in line for line in wn16),
            f"a B3/B6 bf16 kernel is missing or spills: {wn16}")
    enc16 = [line for line in ptxas if line.split(":")[0].split("<")[0] in ENC16_KERNELS]
    print("[build] B5 bf16 forward and backward on TMA and wgmma, attention on bf16 mma.sync (ptxas: registers, "
          "shared memory, spills): " + " | ".join(enc16))
    require(len(enc16) == ENC16_INSTANCES and all("0 bytes spill stores" in line for line in enc16),
            f"a B5 bf16 kernel is missing or spills: {enc16}")
    first_form = [line for line in ptxas if "BfloatLayerFwdTag" in line]
    require(not first_form, f"B5's bf16 forward's mma.sync instances are back: {first_form}")
    b5 = {side: [line for line in ptxas if line.split(":")[0].split("<")[0] in B5_KERNELS
                 and f"Layer{side}Tag" in line.split(":")[0]] for side in ("Fwd", "Bwd")}
    for side, lines in b5.items():
        print(f"[build] B5 {side.lower()}, tensor-core kernels and packing (ptxas: registers, shared memory, "
              "spills): " + " | ".join(lines))
        require(len(lines) >= 2 and all("0 bytes spill stores" in line for line in lines),
                f"a B5 {side.lower()} tensor-core kernel is missing or spills: {lines}")
    blocks, smem = (ctypes.c_int * 4)(), (ctypes.c_longlong * 4)()
    rc = lib.enc_layer_bwd_blocks_per_sm(blocks, smem)
    names = ("conv_mma_kernel (LayerNorm, 16 rows x 192, k=3)", "conv_mma_kernel (FFN conv, 64 x 128, k=3)",
             "conv_mma_kernel (1x1, 64 x 64)", "wgrad_mma_kernel (64 x 128)")
    print("[build] B5 backward: resident blocks per SM (256 threads) at the launch's dynamic shared memory: "
          + ", ".join(f"{n} {b} at {m} B" for n, b, m in zip(names, blocks, smem)))
    require(rc == 0 and min(blocks) >= 1, f"B5 backward: blocks per SM {list(blocks)} (cudaError {rc})")
    b2b4 = [line for line in ptxas if line.split(":")[0].split("<")[0] in B2_FWD_B4_KERNELS]
    print("[build] B2 forward (tensor cores, <DROP>) and B4 (<tokens a lane>) (ptxas: registers, shared memory, "
          "spills): " + " | ".join(b2b4))
    require(len(b2b4) == 2 + MAS_INSTANCES and all("0 bytes spill stores" in line for line in b2b4),
            f"a B2 forward or B4 instance is missing or spills: {b2b4}")
    b2 = [line for line in ptxas if line.split(":")[0].split("<")[0] in B2_BF16_KERNELS]
    print("[build] B2 bf16 forward, dq and dk/dv (<DROP>) (ptxas: registers, shared memory, spills): "
          + " | ".join(b2))
    require(len(b2) == 2 * len(B2_BF16_KERNELS) and all("0 bytes spill stores" in line for line in b2),
            f"a B2 bf16 instance is missing or spills: {b2}")


def phase_kernel(device: torch.device, card: str, block_ts, batch: int, depth: int = 4, tag: str = "[kernel]") -> dict:
    """Kernel against its plain version at each block shape of the path."""
    w = block_weights(device, seed=1, depth=depth)
    max_err, ms_total, plain_total, dev_total, flops, nbytes = 0.0, 0.0, 0.0, 0.0, 0, 0
    with torch.inference_mode():
        for i, T in enumerate(block_ts):
            rng = np.random.RandomState(100 + i)
            lens_np = rng.randint(T // 2, T + 1, (batch,)).astype(np.int32)
            lens_np[0] = T
            valid = torch.from_numpy(np.arange(T)[None, :] < lens_np[:, None]).to(device)
            x = torch.from_numpy(rng.uniform(-1, 1, (batch, T, 64)).astype(np.float32)).to(device)
            x = x * valid[..., None]
            lens = torch.from_numpy(lens_np).to(device)
            ref = gh.gated_hifi_reference(x, lens, w)
            out = gh.gated_hifi(x, lens, w)
            torch.cuda.synchronize()
            scale = ref[valid].abs().max().item()
            err = (out - ref)[valid].abs().max().item()
            zeros = bool((out[~valid] == 0).all().item())
            tol = KERNEL_RTOL * scale
            ms = cuda_ms(lambda: gh.gated_hifi(x, lens, w))
            plain = cuda_ms(lambda: gh.gated_hifi_reference(x, lens, w))
            dev = device_ms(lambda: gh.gated_hifi(x, lens, w))
            print(f"{tag} B={batch} T={T} W=64 depth {depth}: max_abs_err {err:.3e} (tol {tol:.3e} = "
                  f"{KERNEL_RTOL:g} * max|ref| {scale:.3e}), exact zeros past lens {zeros}; "
                  f"kernel {ms:.3f} ms, plain {plain:.3f} ms (median of 10); kernel {dev:.3f} ms over "
                  f"{DEVICE_REPS} back-to-back calls [{card}]")
            require(np.isfinite(err) and err <= tol, f"kernel disagrees at T={T}: {err} > {tol}")
            require(zeros, f"kernel output not zero past lens at T={T}")
            max_err = max(max_err, err)
            ms_total += ms
            plain_total += plain
            dev_total += dev
            flops += batch * T * block_flops_per_frame(w)
            nbytes += 4 * (2 * x.numel() + sum(t.numel() for t in w.tensors().values()))
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"{tag} sum over the {len(block_ts)} block shapes: kernel {ms_total:.3f} ms, "
          f"plain {plain_total:.3f} ms; kernel {dev_total:.3f} ms over {DEVICE_REPS} back-to-back calls; "
          f"bound {bound_ms:.3f} ms by {bound_by} ({tf32_bound_ms(flops, nbytes):.3f} at the 3xTF32 rate; "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) [{card}]")
    return {"max_abs_err": max_err, "ms": dev_total, "call_ms": ms_total, "plain_ms": plain_total,
            "bound_ms": bound_ms, "bound_by": bound_by, "tf32_ms": tf32_bound_ms(flops, nbytes)}


def block_flops_per_frame(w: gh.GatedHiFiWeights) -> int:
    """The forward's multiply-adds per frame, times 2: the expand, each
    branch's conv and 1x1, the gate."""
    return 2 * (w.wall.numel() + sum(k.numel() for k in w.ks) + w.w1.numel() + w.wg.numel())


def build_model(device: torch.device, audio: torch.Tensor, lengths: torch.Tensor):
    """The vqvae_tpu codec with seeded weights; the codebook is 512 seeded
    draws (with replacement) of valid encoder outputs of ``audio`` plus
    0.01/sqrt(C) noise, as the JAX package's first-batch init does. The
    batches encoded later are other audio, so codes are not self-matches."""
    model = get_model(copy.deepcopy(configs.VQVAE_TPU), device=device)
    randomize(model, seed=2)
    model.eval()
    gen = torch.Generator().manual_seed(3)
    with torch.inference_mode():
        mask = (torch.arange(audio.shape[1])[None, :] < lengths[:, None]).float()
        h, h_mask = model.encoders[0](audio.to(device)[..., None], mask.to(device)[..., None])
        rows = h[h_mask[..., 0] > 0].cpu()
        bn = model.bottleneck.level_blocks[0]
        pick = torch.randint(0, rows.shape[0], (bn.k_bins,), generator=gen)
        noise = torch.randn(bn.k_bins, rows.shape[1], generator=gen) * (0.01 / np.sqrt(rows.shape[1]))
        bn.k.copy_((rows[pick] + noise).to(device))
    return model


def phase_slice(model, device, audio, lengths, card: str) -> tuple:
    """encode -> decode and the eval forward on the card; returns the launches
    and those of one decode."""
    x, n = audio.to(device), lengths.to(device)
    mask = (torch.arange(x.shape[1], device=device)[None, :] < n[:, None]).float()
    gh.gated_hifi.launches = 0
    with torch.inference_mode():
        codes, code_mask = model.encode(x, mask)
        torch.cuda.synchronize()
        n_encode = gh.gated_hifi.launches
        y = model.decode(codes, code_mask)
        torch.cuda.synchronize()
        n_decode = gh.gated_hifi.launches - n_encode
        loss_dict, _ = model(x, n, train=False)
        torch.cuda.synchronize()
    launches = gh.gated_hifi.launches
    n_forward = launches - n_encode - n_decode
    frames = x.shape[1] // compression_factor(configs.VQVAE_TPU)
    used = len(torch.unique(codes[code_mask > 0]))
    losses = {k: float(v) for k, v in loss_dict.items() if k != "yh"}
    print(f"[slice] B={x.shape[0]} x {x.shape[1]} samples: codes {tuple(codes.shape)} "
          f"({used} distinct), y {tuple(y.shape)}, losses {losses}; kernel launches "
          f"encode {n_encode}, decode {n_decode}, forward {n_forward} [{card}]")
    require(codes.shape == (x.shape[0], frames), f"codes shape {tuple(codes.shape)}")
    require(y.shape == x.shape and bool(torch.isfinite(y).all()), "decode output")
    require(loss_dict["yh"].shape == x.shape and all(np.isfinite(v) for v in losses.values()),
            "forward losses")
    require((n_encode, n_decode, n_forward) == (7, 7, 14),
            f"launches {(n_encode, n_decode, n_forward)} != (7, 7, 14)")
    return launches, n_decode


def phase_vs_cpu(model, device, audio) -> None:
    """The card's path against the plain path on the CPU, same weights."""
    batch, samples = SUBSET
    cpu_model = copy.deepcopy(model).to("cpu")
    x = audio[:batch, :samples].contiguous()
    n = torch.tensor([samples, samples - 5013])
    mask = (torch.arange(samples)[None, :] < n[:, None]).float()
    with torch.inference_mode():
        codes_g, _ = model.encode(x.to(device), mask.to(device))
        codes_c, cmask = cpu_model.encode(x, mask)
        h, h_mask = cpu_model.encoders[0](x[..., None], mask[..., None])
        valid = cmask > 0
        codes_g = codes_g.cpu()
        agree = (codes_g == codes_c)[valid].float().mean().item()
        bn = cpu_model.bottleneck.level_blocks[0]
        dist = bn._distances(h.reshape(-1, h.shape[-1])).reshape(*h.shape[:2], -1)
        gaps = []
        for b, t in (~(codes_g == codes_c) & valid).nonzero().tolist():
            gap = (dist[b, t, codes_g[b, t]] - dist[b, t, codes_c[b, t]]).item()
            gaps.append((gap, 1e-4 * (h[b, t] ** 2).sum().item() + 1e-6))
        y_g = model.decode(codes_c.to(device), cmask.to(device)).cpu()
        y_c = cpu_model.decode(codes_c, cmask)
        recon_err = (y_g - y_c).abs().max().item()
        recon_tol = RECON_RTOL * y_c.abs().max().item()
        loss_g, _ = model(x.to(device), n.to(device), train=False)
        loss_c, _ = cpu_model(x, n, train=False)
    print(f"[vs cpu] {batch} x {samples}: codes agree on {agree:.6f} of {int(valid.sum())} valid "
          f"frames (need {CODE_AGREEMENT}); mismatch gaps {gaps}; decode max_abs_err "
          f"{recon_err:.3e} (tol {recon_tol:.3e})")
    require(agree >= CODE_AGREEMENT, f"codes agree on {agree}")
    require(all(gap <= tol for gap, tol in gaps), f"a code mismatch is no near-tie: {gaps}")
    require(recon_err <= recon_tol, f"decode differs: {recon_err} > {recon_tol}")
    for key in ("loss", "loss_recon", "loss_stft", "loss_commit"):
        g, c = float(loss_g[key]), float(loss_c[key])
        rel = abs(g - c) / max(abs(c), 1e-12)
        print(f"[vs cpu] {key}: card {g:.8g} cpu {c:.8g} rel {rel:.3e} (tol {LOSS_RTOL:g})")
        require(rel <= LOSS_RTOL, f"{key} differs: {rel}")


def phase_timing(model, device, audio, lengths, card: str) -> None:
    x, n = audio.to(device), lengths.to(device)
    mask = (torch.arange(x.shape[1], device=device)[None, :] < n[:, None]).float()
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for rep in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            codes, code_mask = model.encode(x, mask)
            model.decode(codes, code_mask)
            torch.cuda.synchronize()
            if rep:  # the first is a warm-up
                times.append((time.perf_counter() - t0) * 1e3)
    print(f"[timing] encode + decode, B={x.shape[0]} x {x.shape[1]} samples: median "
          f"{statistics.median(times):.3f} ms of {len(times)} ({', '.join(f'{t:.3f}' for t in times)}); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB [{card}]")


def block_weights(device: torch.device, seed: int, depth: int = 4) -> gh.GatedHiFiWeights:
    """Packed weights of a codec block at W=64 (depth 4: vqvae_tpu's; 3: vqtts_tpu's), all seeded."""
    block = GatedHiFiBlock(64, depth, dilation_growth_rate=3, kernel_size_growth_rate=2, zero_out=True)
    randomize(block, seed=seed)
    block.to(device)
    with torch.no_grad():
        return gh.pack_weights(dict(block.named_parameters()), block.dilations)


def block_inputs(T: int, batch: int, seed: int, device: torch.device):
    """Pre-masked x [batch, T, 64] with ragged lengths, lens, the valid mask and
    a cotangent g."""
    rng = np.random.RandomState(seed)
    lens_np = rng.randint(T // 2, T + 1, (batch,)).astype(np.int32)
    lens_np[0] = T
    valid = torch.from_numpy(np.arange(T)[None, :] < lens_np[:, None]).to(device)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, T, 64)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.randn(batch, T, 64).astype(np.float32)).to(device)
    return x * valid[..., None], torch.from_numpy(lens_np).to(device), valid, g


def grads_at_gates(x, lens, w: gh.GatedHiFiWeights, g, gate_a, gate_h):
    """Plain autograd of the block (res_scale 1) with each branch's relu(z)*m0 replaced by
    z * gate_a and relu(c)*m1 by c * gate_h: the gradient of the piecewise-
    linear piece the kernel's own relu and dropout decisions select. Where a
    pre-activation lies within fp32 rounding of 0, the kernel and the plain
    version may take opposite sides of the kink, and that element's gradient
    then differs by a whole term; at these shapes that happens somewhere in
    most calls."""
    B, T, W = x.shape
    H = 2 * W
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in w.tensors().items()}
        xl = x.detach().requires_grad_(True)
        z_all = xl @ leaves["wall"] + leaves["ball"]
        ts, ss = [], []
        for d, dil in enumerate(w.dilations):
            cols = slice(d * H, (d + 1) * H)
            kernel = leaves[f"ks.{d}"]
            k = kernel.shape[0]
            c = torch.nn.functional.conv1d(
                (z_all[..., cols] * gate_a[..., cols]).transpose(1, 2), kernel.permute(2, 1, 0),
                leaves["cb"][d], padding=(k - 1) // 2 * dil, dilation=dil).transpose(1, 2)
            zp = z_all[..., cols] + (c * gate_h[..., cols]) @ leaves["w1"][d] + leaves["b1"][d]
            ts.append(zp[..., :W])
            ss.append(zp[..., W:])
        s_max = torch.stack(ss).amax(dim=0)
        exps = [torch.exp(s_ - s_max) for s_ in ss]
        u = sum(torch.tanh(t) * e for t, e in zip(ts, exps)) / sum(exps)
        out = (xl + u @ leaves["wg"] + leaves["bg"])
        out = out * (torch.arange(T, device=x.device)[None, :] < lens[:, None])[..., None]
        grads = torch.autograd.grad(out, [xl, *leaves.values()], g)
    return grads[0], gh.GatedHiFiWeights(
        ks=tuple(grads[1:][list(leaves).index(f"ks.{d}")] for d in range(len(w.ks))),
        dilations=w.dilations,
        **{k: gr for k, gr in zip(leaves, grads[1:]) if not k.startswith("ks.")})


def kink_flips(ours: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(elements whose relu/dropout decision differs, the largest of their
    values on either side, max|ref|): a flip is a near-tie when its values
    are within fp32 rounding of 0."""
    flip = (ours > 0) != (ref > 0)
    worst = torch.maximum(ours.abs(), ref.abs())[flip].max().item() if bool(flip.any()) else 0.0
    return int(flip.sum()), worst, ref.abs().max().item()


def leaf_errors(ours: gh.GatedHiFiWeights, ref: gh.GatedHiFiWeights) -> dict:
    """name -> (max abs error, max|ref|) over every weight gradient."""
    refs = ref.tensors()
    return {name: ((t - refs[name]).abs().max().item(), refs[name].abs().max().item())
            for name, t in ours.tensors().items()}


def phase_backward(device, card: str, block_ts, batch: int, depth: int = 4, tag: str = "[backward]") -> dict:
    """Backward kernels against plain autograd at each block shape, p=0 and p=0.1."""
    w = block_weights(device, seed=1, depth=depth)
    seed = 12345
    out = {"dx_err": 0.0, "red_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "red_ms": 0.0, "red_plain_ms": 0.0}
    for p in (0.0, P_DROP):
        sums = {"bwd": 0.0, "plain": 0.0, "tiles": 0.0, "tiles_plain": 0.0, "red": 0.0, "red_plain": 0.0,
                "tiles_dev": 0.0, "red_dev": 0.0, "red_mm": 0.0}
        # the tile passes: the recomputed forward and the transposed products (2x the
        # forward's operations); x and g in, dx and the buffers out. The reduction: one
        # product per weight; x and the buffers in, the weight gradients out
        work = {"tiles": [0, 0], "red": [0, 0]}
        for i, T in enumerate(block_ts):
            x, lens, _, g = block_inputs(T, batch, 200 + i, device)
            args = (x, lens, w, g, 1.0, p, seed)
            dx_k, gw_k = gh.gated_hifi_backward(*args)
            dx_k2, gw_k2 = gh.gated_hifi_backward(*args)
            torch.cuda.synchronize()
            bitwise = torch.equal(dx_k, dx_k2) and all(
                torch.equal(a, b) for a, b in zip(gw_k.tensors().values(), gw_k2.tensors().values()))
            # the kernel's relu and dropout decisions, read from its buffers,
            # against the plain forward's: every flip must be a near-tie
            _, bufs_k = gh.backward_buffers(*args)
            dx_b, bufs_r = gh.backward_buffers_reference(*args)
            flips = {"a": kink_flips(bufs_k.a, bufs_r.a), "h1": kink_flips(bufs_k.h1, bufs_r.h1)}
            keep = gh.keep_scale(p)
            dx_r, gw_r = grads_at_gates(x, lens, w, g, (bufs_k.a > 0) * keep, (bufs_k.h1 > 0) * keep)
            dx_scale = dx_r.abs().max().item()
            dx_err = (dx_k - dx_r).abs().max().item()
            leaves = leaf_errors(gw_k, gw_r)
            worst = max(leaves, key=lambda n: leaves[n][0] / max(leaves[n][1], 1e-30))
            # against plain autograd at its own decisions: differs by whole terms
            # where a decision flipped (printed, not held to a tolerance)
            dx_p, gw_p = gh.gated_hifi_backward_reference(*args)
            free = leaf_errors(gw_k, gw_p)
            free_worst = max(e / max(s_, 1e-30) for e, s_ in free.values())
            free_dx = (dx_k - dx_p).abs().max().item() / dx_p.abs().max().item()
            buf_errs = {name: (getattr(bufs_k, name) - getattr(bufs_r, name)).abs().max().item()
                        / max(getattr(bufs_r, name).abs().max().item(), 1e-30)
                        for name in ("a", "h1", "dzp", "dc", "dz", "u", "gv")}
            # the reduction alone, on the plain version's buffers
            red_k = gh.weight_grad_reduce(x, bufs_r, w.kernels, w.dilations)
            red_r = gh.weight_grad_reduce_reference(x, bufs_r, w.kernels, w.dilations)
            red = leaf_errors(red_k, red_r)
            frames_flops = batch * T * block_flops_per_frame(w)
            buf_bytes = 4 * sum(getattr(bufs_r, f).numel() for f in ("a", "h1", "dzp", "dc", "dz", "u", "gv"))
            work["tiles"][0] += 2 * frames_flops
            work["tiles"][1] += 4 * 3 * x.numel() + buf_bytes
            work["red"][0] += frames_flops
            work["red"][1] += 4 * x.numel() + buf_bytes + 4 * sum(t.numel() for t in w.tensors().values())
            del dx_b, bufs_k, dx_p, gw_p
            times = {
                "bwd": cuda_ms(lambda: gh.gated_hifi_backward(*args), reps=5, warmup=1),
                "plain": cuda_ms(lambda: gh.gated_hifi_backward_reference(*args), reps=5, warmup=1),
                "tiles": cuda_ms(lambda: gh.backward_buffers(*args), reps=5, warmup=1),
                "tiles_plain": cuda_ms(lambda: gh.backward_buffers_reference(*args), reps=5, warmup=1),
                "red": cuda_ms(lambda: gh.weight_grad_reduce(x, bufs_r, w.kernels, w.dilations),
                               reps=5, warmup=1),
                "red_plain": cuda_ms(lambda: gh.weight_grad_reduce_reference(
                    x, bufs_r, w.kernels, w.dilations), reps=5, warmup=1),
                "tiles_dev": device_ms(lambda: gh.backward_buffers(*args)),
                "red_dev": device_ms(lambda: gh.weight_grad_reduce(x, bufs_r, w.kernels, w.dilations)),
                "red_mm": device_ms(wgrad_mm_calls(x, bufs_r, w.kernels, w.dilations)),
            }
            for key, ms in times.items():
                sums[key] += ms
            print(f"{tag} p={p} B={batch} T={T}: relu/dropout decisions flipped against the "
                  f"plain forward: " + ", ".join(
                      f"{k} {n_} (largest value {v:.1e} of max {m:.1e})" for k, (n_, v, m) in flips.items())
                  + f"; at the kernel's decisions dx max_abs_err {dx_err:.3e} (tol "
                  f"{DX_RTOL * dx_scale:.3e}), worst weight grad {worst} {leaves[worst][0]:.3e} of "
                  f"max|ref| {leaves[worst][1]:.3e} (tol {WGRAD_RTOL:g}x); at the plain version's own "
                  f"decisions dx {free_dx:.1e} and worst weight grad {free_worst:.1e} of max|ref|; "
                  f"reduction alone worst "
                  f"{max(e / max(s_, 1e-30) for e, s_ in red.values()):.3e} of max|ref|; buffers "
                  f"rel err {', '.join(f'{k} {v:.1e}' for k, v in buf_errs.items())}; two calls "
                  f"bitwise equal {bitwise}; ms: backward kernels {times['bwd']:.3f} vs plain autograd "
                  f"{times['plain']:.3f}, tile passes {times['tiles']:.3f} vs plain "
                  f"{times['tiles_plain']:.3f}, reduction {times['red']:.3f} vs plain "
                  f"{times['red_plain']:.3f} (median of 5); over {DEVICE_REPS} back-to-back calls tile "
                  f"passes {times['tiles_dev']:.3f}, reduction {times['red_dev']:.3f} vs its products as "
                  f"torch.mm {times['red_mm']:.3f} [{card}]")
            for name, (_, value, scale) in flips.items():
                require(value <= FLIP_RTOL * scale, f"{name}: a decision flipped at {value} of {scale}")
            require(np.isfinite(dx_err) and dx_err <= DX_RTOL * dx_scale,
                    f"dx differs at p={p} T={T}: {dx_err}")
            for name, (err, scale) in leaves.items():
                require(np.isfinite(err) and err <= WGRAD_RTOL * scale,
                        f"grad {name} differs at p={p} T={T}: {err} > {WGRAD_RTOL} * {scale}")
            for name, (err, scale) in red.items():
                require(np.isfinite(err) and err <= WGRAD_RTOL * scale,
                        f"reduction {name} differs at p={p} T={T}: {err} > {WGRAD_RTOL} * {scale}")
            require(bitwise, f"two backward calls differ at p={p} T={T}")
            out["dx_err"] = max(out["dx_err"], dx_err)
            out["red_err"] = max(out["red_err"], max(e for e, _ in red.values()))
            del dx_r, gw_r, dx_k, gw_k, dx_k2, gw_k2, bufs_r, red_k, red_r
            torch.cuda.empty_cache()
        print(f"{tag} p={p} sums over the {len(block_ts)} block shapes: backward kernels "
              f"{sums['bwd']:.3f} ms vs plain autograd {sums['plain']:.3f} ms; tile passes "
              f"{sums['tiles']:.3f} vs {sums['tiles_plain']:.3f} ms ({sums['tiles_dev']:.3f} ms over "
              f"{DEVICE_REPS} back-to-back calls); reduction {sums['red']:.3f} vs {sums['red_plain']:.3f} ms "
              f"({sums['red_dev']:.3f} ms back to back, its products as torch.mm {sums['red_mm']:.3f}) [{card}]")
        if p == P_DROP:  # the training configuration
            tiles_bound, tiles_by = bound(*work["tiles"])
            red_bound, red_by = bound(*work["red"])
            print(f"{tag} p={p} bounds summed over the block shapes: tile passes {tiles_bound:.3f} ms by "
                  f"{tiles_by} ({tf32_bound_ms(*work['tiles']):.3f} at the 3xTF32 rate), reduction "
                  f"{red_bound:.3f} ms by {red_by} ({tf32_bound_ms(*work['red']):.3f}) [{card}]")
            out.update(ms=sums["tiles_dev"], tiles_call_ms=sums["tiles"], plain_ms=sums["tiles_plain"],
                       red_ms=sums["red_dev"], red_call_ms=sums["red"], red_library_ms=sums["red_mm"],
                       red_plain_ms=sums["red_plain"], bound_ms=tiles_bound, bound_by=tiles_by,
                       red_bound_ms=red_bound, red_bound_by=red_by, tf32_ms=tf32_bound_ms(*work["tiles"]),
                       red_tf32_ms=tf32_bound_ms(*work["red"]))
    return out


def wgrad_mm_calls(x, bufs: gh.BackwardBuffers, kernels, dilations, bf16: bool = False):
    """The reduction's products as one torch.mm each (TF32 off, phase_device),
    the library yardstick for its time: a function that runs every conv
    tap's a^T dc, each branch's h1^T dzp, u^T gv and each branch's x^T dz
    over the B*T frames (33 products at the shipped config). A tap's shift runs over the flattened frames, so the few frames
    at each sequence boundary that the kernel zero-fills are not zeroed: the
    same work, not the same bits. The port never calls this. ``bf16``: every
    operand in bf16 (the fp32 buffers cast once, outside the timing) and each
    product's output fp32 (``out_dtype``)."""
    B, T, W = x.shape
    H = 2 * W
    rows = B * T
    cast = (lambda t: t.to(torch.bfloat16)) if bf16 else (lambda t: t)
    flat = {name: cast(getattr(bufs, name).reshape(rows, -1)) for name in ("a", "h1", "dzp", "dc", "dz", "u", "gv")}
    pairs = []
    for d, (k, dil) in enumerate(zip(kernels, dilations)):
        cols = slice(d * H, (d + 1) * H)
        for j in range(k):
            shift = (j - (k - 1) // 2) * dil
            lo, hi = max(shift, 0), rows + min(shift, 0)   # X rows r + shift for r in [lo - shift, hi - shift)
            pairs.append((flat["a"][lo:hi, cols], flat["dc"][lo - shift:hi - shift, cols]))
        pairs.append((flat["h1"][:, cols], flat["dzp"][:, cols]))
    pairs.append((flat["u"], flat["gv"]))
    pairs += [(x.reshape(rows, W), flat["dz"][:, d * H:(d + 1) * H]) for d in range(len(kernels))]

    mm = functools.partial(torch.mm, out_dtype=torch.float32) if bf16 else torch.mm

    def run():
        for a, b in pairs:
            mm(a.t(), b)
    return run


def read_back_masks(device, T: int, batch: int, depth: int, seed: int, dtype=torch.float32) -> tuple:
    """The backward kernels' dropout masks at p=P_DROP on a probe block whose
    expand and conv biases of 10 (conv weights scaled down) make z > 0 and
    c > 0 everywhere, so the kernel's a > 0 and h1 > 0 exactly where kept:
    each branch's two masks must equal the plain version's (``branch_masks``)
    bit for bit. Returns (kept counts at site 0, site 1 and both, elements,
    the same seed's buffers equal, the share of site 0 another seed changes).
    ``dtype`` bfloat16 runs the bf16 kernels."""
    x, lens, _, g = block_inputs(T, batch, 400, device)
    x, g = x.to(dtype), g.to(dtype)
    block = GatedHiFiBlock(64, depth, dilation_growth_rate=3, kernel_size_growth_rate=2, zero_out=True)
    randomize(block, seed=7)
    with torch.no_grad():
        for d in range(depth):
            block.blocks[d][0].bias.fill_(10.0)
            block.blocks[d][1].model[2].weight.mul_(0.01)
            block.blocks[d][1].model[2].bias.fill_(10.0)
        block.to(device=device, dtype=dtype)
        w = gh.pack_weights(dict(block.named_parameters()), block.dilations)
        _, plain = gh.backward_buffers(x, lens, w, g, 1.0, 0.0, seed)
        require(bool((plain.a > 0).all()) and bool((plain.h1 > 0).all()),
                "the dropout probe's expands and convs are not all positive")
        _, bufs = gh.backward_buffers(x, lens, w, g, 1.0, P_DROP, seed)
        _, again = gh.backward_buffers(x, lens, w, g, 1.0, P_DROP, seed)
        _, other = gh.backward_buffers(x, lens, w, g, 1.0, P_DROP, seed + 1)
        H = 128
        n0 = n1 = n01 = 0
        for d in range(depth):
            k0 = bufs.a[..., d * H:(d + 1) * H] > 0
            k1 = bufs.h1[..., d * H:(d + 1) * H] > 0
            m0, m1 = gh.branch_masks(seed, batch, d, 0, T, H, P_DROP, device)
            require(torch.equal(k0, m0 > 0) and torch.equal(k1, m1 > 0),
                    f"branch {d} at B={batch} T={T}: the kernel's masks differ from the plain version's")
            n0 += int(k0.sum())
            n1 += int(k1.sum())
            n01 += int((k0 & k1).sum())
        same = torch.equal(bufs.a, again.a) and torch.equal(bufs.h1, again.h1)
        changed = ((bufs.a > 0) != (other.a > 0)).float().mean().item()
    return (n0, n1, n01), batch * T * H * depth, same, changed


def phase_dropout(device, card: str) -> float:
    """The dropout law on the card; returns the train-mode forward's error."""
    T, batch, seed = 4128, 16, 777
    keep = 1.0 - gh.keep_threshold(P_DROP) / 65536.0
    (n0, n1, n01), n, same, changed = read_back_masks(device, T, batch, 4, seed)
    rates = {"site 0": (n0 / n, keep), "site 1": (n1 / n, keep), "both": (n01 / n, keep * keep)}
    with torch.no_grad():
        wr = block_weights(device, seed=1)
        xr, lr, vr, _ = block_inputs(T, batch, 401, device)
        ref = gh.gated_hifi_reference(xr, lr, wr, 1.0, P_DROP, seed)
        out = gh.gated_hifi(xr, lr, wr, 1.0, P_DROP, seed)
        err = (out - ref)[vr].abs().max().item()
        scale = ref[vr].abs().max().item()
        no_drop = (gh.gated_hifi_reference(xr, lr, wr) - ref)[vr].abs().max().item()
    print(f"[dropout] p={P_DROP} B={batch} T={T}: kernel masks equal the plain version's at both "
          f"sites of all 4 branches; keep rates " + ", ".join(
              f"{k} {r:.6f} (expect {q:.6f}, 5 sigma {5 * np.sqrt(q * (1 - q) / n):.1e})"
              for k, (r, q) in rates.items())
          + f"; same seed same masks {same}; another seed changes {changed:.4f} of site 0; "
          f"train-mode forward max_abs_err {err:.3e} (tol {KERNEL_RTOL * scale:.3e}), "
          f"dropout moved the output by {no_drop:.3e} [{card}]")
    for k, (r, q) in rates.items():
        require(abs(r - q) <= 5 * np.sqrt(q * (1 - q) / n), f"keep rate {k} {r} vs {q}")
    require(same, "the same seed gave other masks")
    require(changed > 0.1, f"another seed changed only {changed} of the masks")
    require(np.isfinite(err) and err <= KERNEL_RTOL * scale, f"train-mode forward differs: {err}")
    require(no_drop > 100 * KERNEL_RTOL * scale, "dropout did not change the output")
    return err


def launch_counts() -> tuple:
    return gh.gated_hifi.launches, gh.backward_buffers.launches, gh.weight_grad_reduce.launches


def phase_train(device, card: str) -> dict:
    """The training path: lazy codebook init, then TRAIN_STEPS steps."""
    model = harness.get_model({"model": copy.deepcopy(configs.VQVAE_TPU)}, device=device)
    audio, lengths = audio_batch(BATCH, SAMPLES, seed=8)
    batch = {"audio": audio.to(device), "audio_len": lengths.to(device)}
    bn = model.bottleneck.level_blocks[0]
    require(not bool(bn.initialized), "the codebook starts initialized")
    harness.init_model_variables(model, batch, seed=TRAIN_SEED)
    require(bool(bn.initialized), "the lazy codebook init did not run")
    opt, schedule = build_optimizer(model.parameters(), configs.VQVAE_TPU_OPTIMIZER)
    state = TrainState.create(model, opt, use_ema=True)
    train_step = make_train_step(schedule, default_mu(BATCH, 1), use_ema=True)
    params0 = {k: v.detach().clone() for k, v in state.params.items()}
    ema0 = {k: v.clone() for k, v in state.ema_params.items()}
    k0 = bn.k.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gh.gated_hifi.launches = gh.backward_buffers.launches = gh.weight_grad_reduce.launches = 0
    times, per_step, losses = [], [], []
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scalars = train_step(state, batch, TRAIN_SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(a - b for a, b in zip(launch_counts(), before)))
        raise_if_not_finite(scalars, state.step)
        losses.append({k: float(v) for k, v in scalars.items()})
    fwd, bwd, red = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(p.detach(), params0[k]) for k, p in state.params.items())
    ema_moved = sum(not torch.equal(e, ema0[k]) for k, e in state.ema_params.items())
    dk = (bn.k - k0).abs().max().item()
    median = statistics.median(times[1:])
    mel_fps = BATCH * SAMPLES / HOP / (median / 1e3)
    print(f"[train] B={BATCH} x {SAMPLES} samples, p_dropout {model.encoders[0].level_blocks[0].blocks[1].p_dropout}, "
          f"Adam + codebook EMA + parameter EMA: losses per step "
          f"{[round(l['loss'], 6) for l in losses]}; last step {losses[-1]}")
    print(f"[train] launches per step (forward, backward tiles, reduction) {per_step}; "
          f"{moved}/{len(params0)} parameters and {ema_moved}/{len(ema0)} EMA parameters moved; "
          f"codebook k moved by up to {dk:.3e}")
    print(f"[train] step ms {', '.join(f'{t:.3f}' for t in times)}; median of steps 2-{TRAIN_STEPS} "
          f"{median:.3f} ms = {mel_fps:.1f} mel-frames/s ({BATCH} x {SAMPLES} / {HOP} per step); "
          f"max_memory_allocated {peak:.3f} GiB [{card}]")
    require(all(s_ == (14, 14, 14) for s_ in per_step), f"launches per step {per_step} != (14, 14, 14)")
    require(moved == len(params0), f"only {moved}/{len(params0)} parameters moved")
    require(ema_moved == len(ema0), f"only {ema_moved}/{len(ema0)} EMA parameters moved")
    require(dk > 0, "the codebook did not change")
    return {"fwd": fwd, "bwd": bwd, "red": red, "step_ms": median}


def phase_train_vs_cpu(device, card: str) -> None:
    """One train step on the card against the CPU's plain path, same state.

    The codebook starts from other audio (no self-matches, whose codes are
    near-ties). The log-magnitude STFT loss makes the gradient ill-conditioned
    in fp32 (its 1/|Y| near the clamp): the CPU's own fp32 gradients differ
    from fp64 by about 6e-3 (median over parameters, relative L2). So each
    fp32 step is held against the same step in fp64 on the CPU (the STFT
    loss stays fp32 there, by design), and the card must come as close to it
    as the CPU's fp32 step does.
    """
    batch_n, samples = SUBSET
    cfg = {**copy.deepcopy(configs.VQVAE_TPU), "p_dropout": 0.0, "revival_threshold": 0.0,
           "zero_out": False}
    audio, _ = audio_batch(BATCH, SAMPLES, seed=9)
    other, _ = audio_batch(BATCH, SAMPLES, seed=5)
    x = audio[:batch_n, :samples].contiguous()
    n = torch.tensor([samples, samples - 5013])
    models = {"cuda": harness.get_model({"model": cfg}, device=device)}
    harness.init_model_variables(models["cuda"], {"audio": other[:batch_n, :samples], "audio_len": n},
                                 seed=TRAIN_SEED + 1)
    models["cpu"] = copy.deepcopy(models["cuda"]).to("cpu")
    models["cpu64"] = copy.deepcopy(models["cpu"]).double()
    out = {}
    for name, model in models.items():
        dev = next(model.parameters()).device
        xx = x.double() if name == "cpu64" else x
        opt, schedule = build_optimizer(model.parameters(), configs.VQVAE_TPU_OPTIMIZER)
        state = TrainState.create(model, opt, use_ema=True)
        scalars = make_train_step(schedule, default_mu(batch_n, 1), use_ema=True)(
            state, {"audio": xx.to(dev), "audio_len": n.to(dev)}, TRAIN_SEED)
        out[name] = ({k: float(v) for k, v in scalars.items()},
                     {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()})

    def rel_l2(ours: dict, ref: dict) -> dict:
        return {k: ((ours[k] - r).norm() / max(r.norm().item(), 1e-30)).item() for k, r in ref.items()}

    ref = out["cpu64"][1]
    errs = {name: rel_l2(out[name][1], ref) for name in ("cuda", "cpu")}
    stats = {name: (statistics.median(e.values()), max(e.values())) for name, e in errs.items()}
    direct = rel_l2(out["cuda"][1], out["cpu"][1])
    print(f"[train vs cpu] {batch_n} x {samples}, p_dropout 0, revival off: losses card {out['cuda'][0]}; "
          f"cpu {out['cpu'][0]}; cpu fp64 {out['cpu64'][0]}")
    print(f"[train vs cpu] gradients against the fp64 step, relative L2 over {len(ref)} parameters: "
          f"card median {stats['cuda'][0]:.3e} worst {stats['cuda'][1]:.3e}; cpu fp32 median "
          f"{stats['cpu'][0]:.3e} worst {stats['cpu'][1]:.3e} (card within 2x + {STEP_GRAD_MEDIAN_ATOL:g} "
          f"/ {STEP_GRAD_WORST_ATOL:g}); card against cpu fp32 median {statistics.median(direct.values()):.3e} "
          f"worst {max(direct.values()):.3e} [{card}]")
    for key in ("loss", "loss_recon", "loss_stft", "loss_commit"):
        g_, c_ = out["cuda"][0][key], out["cpu"][0][key]
        rel = abs(g_ - c_) / max(abs(c_), 1e-12)
        require(rel <= STEP_LOSS_RTOL, f"train step {key} differs: {rel}")
    require(stats["cuda"][0] <= 2 * stats["cpu"][0] + STEP_GRAD_MEDIAN_ATOL,
            f"train step grads: card median {stats['cuda'][0]} vs cpu {stats['cpu'][0]}")
    require(stats["cuda"][1] <= 2 * stats["cpu"][1] + STEP_GRAD_WORST_ATOL,
            f"train step grads: card worst {stats['cuda'][1]} vs cpu {stats['cpu'][1]}")


# ---------------------------------------------------------------------------
# the Transformer LM
# ---------------------------------------------------------------------------
def packed_qkv(B: int, T: int, seed: int, device: torch.device):
    """A packed [B, T, 3*H*D] projection (the LM's layout), ragged lens
    (lens[0] = T) and a cotangent g [B, T, H, D]."""
    rng = np.random.RandomState(seed)
    hd = ATTN_HEADS * ATTN_DIM
    qkv = torch.from_numpy(rng.randn(B, T, 3 * hd).astype(np.float32)).to(device)
    lens_np = rng.randint(1, T + 1, (B,)).astype(np.int32)
    lens_np[0] = T
    g = torch.from_numpy(rng.randn(B, T, ATTN_HEADS, ATTN_DIM).astype(np.float32)).to(device)
    return qkv, torch.from_numpy(lens_np).to(device), g


def heads(qkv: torch.Tensor):
    """q, k, v as [B, T, H, D] views of the packed projection."""
    B, T, _ = qkv.shape
    return [t.view(B, T, ATTN_HEADS, ATTN_DIM) for t in qkv.split(ATTN_HEADS * ATTN_DIM, dim=-1)]


def kernel_keep_mask(B: int, T: int, lens: torch.Tensor, seed: torch.Tensor, device,
                     dtype=torch.float32) -> torch.Tensor:
    """The forward kernel's dropout decisions [B, H, T, T] at p=P_DROP, read
    back through its output: with q = k = 0 every valid key of row r has
    probability 1/n_r exactly (n_r = min(r + 1, len_b)), and with v one-hot
    over a window of D keys, o[b, r, h, d] * n_r * (1 - p) is 1 where the
    kernel kept key c0 + d and 0 where it dropped it (in bf16 within the
    rounding of p keep, 2^-9)."""
    H, D = ATTN_HEADS, ATTN_DIM
    zeros = torch.zeros(B, T, H, D, device=device, dtype=dtype)
    n = torch.minimum(torch.arange(1, T + 1, device=device)[None, :], lens[:, None].long())
    keep = torch.zeros(B, H, T, T, dtype=torch.bool, device=device)
    for c0 in range(0, T, D):
        w = min(D, T - c0)
        v = torch.zeros(B, T, H, D, device=device, dtype=dtype)
        v[:, c0:c0 + w, :, :w] = torch.eye(w, device=device, dtype=dtype)[None, :, None, :]
        o = att.fused_attention(zeros, zeros, v, lens, seed, 1.0, P_DROP).float()
        kept = o[..., :w] * n[:, :, None, None] * (1.0 - P_DROP) > 0.5
        keep[..., c0:c0 + w] = kept.permute(0, 2, 1, 3)
    return keep


def phase_attention_dropout(device, card: str) -> None:
    """The attention kernel's masks on the card against the plain version's."""
    B, T = ATTN_SHAPES[0]
    _, lens, _ = packed_qkv(B, T, 600, device)
    seed = torch.tensor([31337], dtype=torch.int64, device=device)
    with torch.no_grad():
        keep = kernel_keep_mask(B, T, lens, seed, device)
        again = kernel_keep_mask(B, T, lens, seed, device)
        other = kernel_keep_mask(B, T, lens, seed + 1, device)
        plain = att.dropout_bits(seed, B, ATTN_HEADS, T, device) >= att.keep_threshold(P_DROP)
    valid = att.valid_pairs(lens, T).expand(B, ATTN_HEADS, T, T)
    n = int(valid.sum())
    rate = keep[valid].double().mean().item()
    expect = 1.0 - att.keep_threshold(P_DROP) / 2 ** 32
    sigma = np.sqrt(expect * (1 - expect) / n)
    equal = torch.equal(keep[valid], plain[valid])
    same = torch.equal(keep[valid], again[valid])
    changed = (keep[valid] != other[valid]).double().mean().item()
    print(f"[attention dropout] p={P_DROP} B={B} T={T} H={ATTN_HEADS}: kernel masks read back at "
          f"{n} valid pairs equal the plain version's {equal}; keep rate {rate:.6f} (expect "
          f"{expect:.6f}, 5 sigma {5 * sigma:.1e}); same seed same masks {same}; another seed "
          f"changes {changed:.4f} [{card}]")
    require(equal, "the attention kernel's dropout masks differ from the plain version's")
    require(abs(rate - expect) <= 5 * sigma, f"attention keep rate {rate} vs {expect}")
    require(same, "the same seed gave other attention masks")
    require(changed > 0.1, f"another seed changed only {changed} of the attention masks")


def attention_fwd_launch(q, k, v, lens, seed, scale: float, p: float):
    """One launch of the forward kernel through its C entry point on
    outputs allocated once: for timing the kernel back to back without the
    wrapper's host time, which at (8, 258) is about the kernel's own. The
    call counts no launch."""
    B, T, H, D = q.shape
    o = torch.empty(B, T, H, D, device=q.device, dtype=q.dtype)
    stats = torch.empty(B, H, T, 2, device=q.device)
    lib = _build.build()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(1), lens.data_ptr(), seed.data_ptr(), o.data_ptr(),
            stats.data_ptr(), B, T, H, D, float(scale), *att._dropout_args(p),
            torch.cuda.current_stream(q.device).cuda_stream)
    entry = lib.attention_fwd_bf16 if q.dtype == torch.bfloat16 else lib.attention_fwd

    def launch():
        require(entry(*args) == 0, "attention_fwd launch failed")
    launch.outputs = (o, stats)  # the pointers in args live as long as the closure
    return launch


def phase_attention(device, card: str) -> dict:
    """Forward and recompute backward kernels against their plain versions.

    The kernel's gradients come through autograd (``FusedAttentionFunction``,
    whose backward launches both kernels of attention_bwd.cu), the plain
    ones through autograd of ``attention_reference``; times are of those two
    backward passes (CUDA events, median of 10, each with a retained graph),
    the forward's one call, and both kernels over DEVICE_REPS back-to-back
    calls (the forward through its C entry point).
    """
    scale = 1.0 / np.sqrt(ATTN_DIM)
    out = {"fwd_err": 0.0, "bwd_err": 0.0}
    for i, (B, T) in enumerate(ATTN_SHAPES):
        packed, lens, g = packed_qkv(B, T, 500 + i, device)
        for p in (0.0, P_DROP):
            seed = torch.tensor([12345 + i], dtype=torch.int64, device=device)
            qkv = packed.clone().requires_grad_(True)
            qkv_ref = packed.clone().requires_grad_(True)
            o = att.fused_attention(*heads(qkv), lens, seed, scale, p)
            ref = att.attention_reference(*heads(qkv_ref), lens, seed, scale, p)
            grads = torch.autograd.grad(o, qkv, g, retain_graph=True)[0]
            again = torch.autograd.grad(o, qkv, g, retain_graph=True)[0]
            grads_ref = torch.autograd.grad(ref, qkv_ref, g, retain_graph=True)[0]
            with torch.no_grad():
                fwd_bitwise = torch.equal(o, att.fused_attention(*heads(packed), lens, seed, scale, p))
            torch.cuda.synchronize()
            fwd_scale = ref.abs().max().item()
            fwd_err = (o - ref).abs().max().item()
            errs = {name: ((a - b).abs().max().item(), b.abs().max().item())
                    for name, a, b in zip(("dq", "dk", "dv"), heads(grads), heads(grads_ref))}
            bitwise = torch.equal(grads, again)
            with torch.no_grad():
                args = (*heads(packed), lens, seed, scale, p)
                times = {"fwd": cuda_ms(lambda: att.fused_attention(*args)),
                         "fwd_plain": cuda_ms(lambda: att.attention_reference(*args)),
                         "fwd_dev": device_ms(attention_fwd_launch(*args))}
            times["bwd"] = cuda_ms(lambda: torch.autograd.grad(o, qkv, g, retain_graph=True))
            times["bwd_plain"] = cuda_ms(lambda: torch.autograd.grad(ref, qkv_ref, g, retain_graph=True))
            with torch.no_grad():  # the backward kernels alone, back to back
                q_, k_, v_ = heads(packed)
                o_k, stats_k = att._launch_fwd(q_, k_, v_, lens, seed, scale, p)
                times["bwd_dev"] = device_ms(
                    lambda: att.attention_backward(q_, k_, v_, o_k, stats_k, lens, seed, g, scale, p))
            if p == 0.0:  # the library's attention on the same inputs and mask (timed, used nowhere)
                times.update(sdpa_times(packed, lens, g, scale))
            print(f"[attention] B={B} T={T} H={ATTN_HEADS} D={ATTN_DIM} p={p}: forward max_abs_err "
                  f"{fwd_err:.3e} (tol {ATTN_FWD_RTOL * fwd_scale:.3e}); " + ", ".join(
                      f"{k} {e:.3e} (tol {ATTN_GRAD_RTOL * s_:.3e})" for k, (e, s_) in errs.items())
                  + f"; two forward calls bitwise equal {fwd_bitwise}, two backward calls {bitwise}; ms: forward "
                  f"kernel {times['fwd']:.4f} vs plain {times['fwd_plain']:.4f}, backward kernels "
                  f"{times['bwd']:.4f} vs plain autograd {times['bwd_plain']:.4f} (median of 10)"
                  + (f"; F.scaled_dot_product_attention (same mask, p=0) forward {times['sdpa']:.4f}, "
                     f"backward {times['sdpa_bwd']:.4f}" if p == 0.0 else "")
                  + f"; over {DEVICE_REPS} back-to-back calls: forward kernel {times['fwd_dev']:.4f}, backward "
                  f"kernels (attention_backward) {times['bwd_dev']:.4f}"
                  + (f", SDPA's forward (p=0) {times['sdpa_dev']:.4f} and backward (autograd.grad) "
                     f"{times['sdpa_bwd_dev']:.4f}" if p == 0.0 else "")
                  + f" [{card}]")
            require(np.isfinite(fwd_err) and fwd_err <= ATTN_FWD_RTOL * fwd_scale,
                    f"attention forward differs at B={B} T={T} p={p}: {fwd_err}")
            for name, (err, s_) in errs.items():
                require(np.isfinite(err) and err <= ATTN_GRAD_RTOL * s_,
                        f"attention {name} differs at B={B} T={T} p={p}: {err} > {ATTN_GRAD_RTOL} * {s_}")
            require(fwd_bitwise, f"two attention forward calls differ at B={B} T={T} p={p}")
            require(bitwise, f"two attention backward calls differ at B={B} T={T} p={p}")
            out["fwd_err"] = max(out["fwd_err"], fwd_err)
            out["bwd_err"] = max(out["bwd_err"], max(e for e, _ in errs.values()))
            if (B, T) == ATTN_SHAPES[0] and p == 0.0:
                out.update(sdpa_ms=times["sdpa"], sdpa_bwd_ms=times["sdpa_bwd"], bwd_dev_p0=times["bwd_dev"],
                           sdpa_bwd_dev=times["sdpa_bwd_dev"], sdpa_dev=times["sdpa_dev"], fwd_dev_p0=times["fwd_dev"])
            if (B, T) == ATTN_SHAPES[1] and p == 0.0:
                out["b64_sdpa_dev"] = times["sdpa_dev"]
            if (B, T) in ATTN_SHAPES[:2] and p == P_DROP:  # the LM's training calls
                pairs = int(torch.minimum(torch.arange(1, T + 1, device=device)[None, :],
                                          lens.long()[:, None]).sum()) * ATTN_HEADS
                row = B * T * ATTN_HEADS * ATTN_DIM * 4  # bytes of one [B, T, H, D] tensor
                fwd_bound = bound(4 * ATTN_DIM * pairs, 4 * row + B * ATTN_HEADS * T * 8)
                print(f"[attention] bounds at B={B} T={T} ({pairs} valid (query, key) pairs): forward "
                      f"{fwd_bound[0]:.4f} ms by {fwd_bound[1]}, backward "
                      f"{bound(10 * ATTN_DIM * pairs, 8 * row + B * ATTN_HEADS * T * 8)[0]:.4f} ms [{card}]")
                if (B, T) == ATTN_SHAPES[1]:  # the forward's second row in the kernels line
                    out["b64"] = {"ms": times["fwd_dev"], "call_ms": times["fwd"], "plain_ms": times["fwd_plain"],
                                  "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                                  "bound_3xtf32_ms": tf32_bound_ms(4 * ATTN_DIM * pairs,
                                                                   4 * row + B * ATTN_HEADS * T * 8)}
                else:
                    out["bound"] = fwd_bound
                    out["bwd_bound"] = bound(10 * ATTN_DIM * pairs, 8 * row + B * ATTN_HEADS * T * 8)
                    out["tf32"] = tf32_bound_ms(4 * ATTN_DIM * pairs, 4 * row + B * ATTN_HEADS * T * 8)
                    out["bwd_tf32"] = tf32_bound_ms(10 * ATTN_DIM * pairs, 8 * row + B * ATTN_HEADS * T * 8)
                    out.update(fwd_ms=times["fwd"], fwd_plain_ms=times["fwd_plain"], fwd_dev=times["fwd_dev"],
                               bwd_ms=times["bwd"], bwd_plain_ms=times["bwd_plain"], bwd_dev=times["bwd_dev"])
            del o, ref, grads, again, grads_ref, qkv, qkv_ref, o_k, stats_k
            torch.cuda.empty_cache()
    return out


def sdpa_times(packed: torch.Tensor, lens: torch.Tensor, g: torch.Tensor, scale: float) -> dict:
    """F.scaled_dot_product_attention's forward and backward on the same
    inputs and boolean mask at p=0, in ms (CUDA events, median of 10; and
    both over DEVICE_REPS back-to-back calls)."""
    B, T, _ = packed.shape
    mask = att.valid_pairs(lens, T)
    leaf = packed.clone().requires_grad_(True)
    q, k, v = (t.transpose(1, 2) for t in heads(leaf))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, dropout_p=0.0, scale=scale)
    with torch.no_grad():
        fwd = cuda_ms(sdpa)
        fwd_dev = device_ms(sdpa)
    o = sdpa()
    gt = g.transpose(1, 2)
    bwd = cuda_ms(lambda: torch.autograd.grad(o, leaf, gt, retain_graph=True))
    bwd_dev = device_ms(lambda: torch.autograd.grad(o, leaf, gt, retain_graph=True))
    return {"sdpa": fwd, "sdpa_dev": fwd_dev, "sdpa_bwd": bwd, "sdpa_bwd_dev": bwd_dev}


def lm_tokens(batch: int, T: int, seed: int, device) -> dict:
    """BOS then seeded codes + OFFSET, padded with PAD to T: the first row
    holds T - 1 tokens, the others ragged lengths in [T/2, T - 1]."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(T // 2, T, (batch,)).astype(np.int32)
    lens[0] = T - 1
    tokens = np.full((batch, T), PAD, np.int64)
    for b, n in enumerate(lens):
        tokens[b, 0] = BOS
        tokens[b, 1:n] = rng.randint(0, configs.TRANSFORMER_LM_TPU["vocab_size"], n - 1) + OFFSET
    return {"token": torch.from_numpy(tokens).to(device), "token_len": torch.from_numpy(lens).to(device)}


def build_lm(device, vq_state: dict, seed: int, dropout: Optional[float] = None):
    """The LM at TRANSFORMER_LM_TPU width with flax-default seeded weights,
    the frozen VQVAE_TPU codec grafted from ``vq_state``."""
    cfg = copy.deepcopy(configs.TRANSFORMER_LM_TPU)
    if dropout is not None:
        cfg["dropout"] = dropout
    lm = harness.get_model({"model": cfg}, vqvae_model_config=configs.VQVAE_TPU, device=device)
    harness.init_model_variables(lm, None, seed=seed)
    load_vqvae_into_lm(lm, vq_state)
    return lm


def lm_counts() -> tuple:
    return att.fused_attention.launches, att.attention_backward.launches, gh.gated_hifi.launches


def zero_counts() -> None:
    att.fused_attention.launches = att.attention_backward.launches = 0
    gh.gated_hifi.launches = gh.backward_buffers.launches = gh.weight_grad_reduce.launches = 0


def lm_optimizer(lm):
    return build_optimizer(harness.trainable_parameters(lm), configs.TRANSFORMER_LM_TPU_OPTIMIZER,
                           configs.TRANSFORMER_LM_TPU_SCHEDULER)


def phase_lm_train(device, card: str, vq_state: dict) -> dict:
    """LM_STEPS train steps at each batch of LM_BATCHES x LM_T; returns the
    launches and times, and the state after the first batch's steps."""
    out = {"fwd": 0, "bwd": 0}
    n_layers = configs.TRANSFORMER_LM_TPU["num_layers"]
    for batch_n in LM_BATCHES:
        lm = build_lm(device, vq_state, seed=LM_SEED)
        opt, schedule = lm_optimizer(lm)
        state = TrainState.create(lm, opt, use_ema=True)
        train_step = make_train_step(schedule, default_mu(batch_n, 1), use_ema=True)
        batch = lm_tokens(batch_n, LM_T, seed=20 + batch_n, device=device)
        frozen = {n for n, keep in harness.frozen_param_mask(lm).items() if not keep}
        params0 = {k: v.detach().clone() for k, v in state.params.items()}
        codebook0 = {k: v.clone() for k, v in state.codebook.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        times, per_step, losses = [], [], []
        for _ in range(LM_STEPS):
            before = lm_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scalars = train_step(state, batch, LM_SEED)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            per_step.append(tuple(a - b for a, b in zip(lm_counts(), before)))
            raise_if_not_finite(scalars, state.step)
            losses.append({k: float(v) for k, v in scalars.items()})
        fwd, bwd, _ = lm_counts()
        out["fwd"] += fwd
        out["bwd"] += bwd
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        trainable = [k for k in params0 if k not in frozen]
        moved = sum(not torch.equal(state.params[k].detach(), params0[k]) for k in trainable)
        frozen_same = all(torch.equal(state.params[k].detach(), params0[k]) for k in frozen)
        codebook_same = all(torch.equal(v, codebook0[k]) for k, v in state.codebook.items())
        median = statistics.median(times[1:])
        targets = int((batch["token_len"] - 1).sum())
        print(f"[lm train] B={batch_n} x {LM_T} tokens, dropout {lm.dropout_p}, Adam (warm-up "
              f"{configs.TRANSFORMER_LM_TPU_SCHEDULER['warmup_steps']}) + parameter EMA, codec frozen: "
              f"losses {[round(l['loss'], 6) for l in losses]}, accuracy {losses[-1]['accuracy']:.6f}; "
              f"launches per step (attention forward, attention backward, GatedHiFi forward) "
              f"{per_step}; {moved}/{len(trainable)} trainable parameters moved; {len(frozen)} frozen "
              f"codec parameters unchanged {frozen_same}, codebook unchanged {codebook_same}")
        print(f"[lm train] B={batch_n}: step ms {', '.join(f'{t:.3f}' for t in times)}; median of "
              f"steps 2-{LM_STEPS} {median:.3f} ms = {batch_n * LM_T / (median / 1e3):.1f} token "
              f"positions/s ({batch_n} x {LM_T} per step), {targets / (median / 1e3):.1f} target "
              f"tokens/s ({targets} per step); max_memory_allocated {peak:.3f} GiB [{card}]")
        require(all(s_ == (n_layers, n_layers, 0) for s_ in per_step),
                f"launches per step {per_step} != ({n_layers}, {n_layers}, 0)")
        require(moved == len(trainable), f"only {moved}/{len(trainable)} trainable parameters moved")
        require(frozen and frozen_same, "a frozen codec parameter changed")
        require(codebook_same, "the frozen codebook changed")
        out[batch_n] = {"step_ms": median}
        if batch_n == LM_BATCHES[0]:
            out.update(state=state, model=lm)
        else:
            del state, lm, opt
        torch.cuda.empty_cache()
    return out


def phase_lm_val(state: TrainState, device, card: str, decode_launches: int) -> None:
    batch_n = LM_BATCHES[0]
    batch = lm_tokens(batch_n, LM_T, seed=40, device=device)
    zero_counts()
    loss_dict, metrics = make_val_step(use_ema=True)(state, batch)
    torch.cuda.synchronize()
    counts = lm_counts()
    n_layers = configs.TRANSFORMER_LM_TPU["num_layers"]
    yh = loss_dict["yh"]
    shape = (batch_n, (LM_T - 1) * compression_factor(configs.VQVAE_TPU))
    print(f"[lm val] B={batch_n} x {LM_T} on the EMA parameters: loss {float(loss_dict['loss']):.6f} "
          f"accuracy {float(metrics['accuracy']):.6f}; yh {tuple(yh.shape)}; launches (attention "
          f"forward, attention backward, GatedHiFi forward) {counts} [{card}]")
    require(counts == (n_layers, 0, decode_launches),
            f"val step launches {counts} != ({n_layers}, 0, {decode_launches})")
    require(tuple(yh.shape) == shape and bool(torch.isfinite(yh).all()), f"yh {tuple(yh.shape)}")
    require(np.isfinite(float(loss_dict["loss"])), "val loss")


@torch.no_grad()
def cached_logits(lm, tokens: torch.Tensor) -> torch.Tensor:
    """The logits of ``sample``'s KV-cached decode, fed ``tokens`` one by one."""
    B, T = tokens.shape
    layers = lm.transformer.layers
    caches = torch.zeros(2, len(layers), B, T, lm.n_heads, lm.d_model // lm.n_heads, device=tokens.device)
    out = []
    for pos in range(T):
        x = lm.embedding(tokens[:, pos:pos + 1]) * np.sqrt(lm.d_model) + lm.pe[None, pos:pos + 1]
        for i, layer in enumerate(layers):
            x = layer.decode_step(x, caches[0, i], caches[1, i], pos)
        out.append(lm.classifier(lm.transformer.norm(x)[:, 0]))
    return torch.stack(out, dim=1)


def phase_lm_sample(lm, device, card: str, decode_launches: int) -> dict:
    """KV-cached sampling then the codec decode, at each of SAMPLE_BATCHES."""
    out = {}
    samples = SAMPLE_STEPS * compression_factor(configs.VQVAE_TPU)
    for batch_n in SAMPLE_BATCHES:
        lm.sample(batch_n, 8, torch.Generator(device=device).manual_seed(0))  # warm-up
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, codes = lm.sample(batch_n, SAMPLE_STEPS, torch.Generator(device=device).manual_seed(batch_n))
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = lm_counts()
        with torch.no_grad():
            t0 = time.perf_counter()
            lm.reconstruct(codes, torch.ones(codes.shape, device=device))
            torch.cuda.synchronize()
            decode = time.perf_counter() - t0
        rate = batch_n * SAMPLE_STEPS / total
        out[batch_n] = {"tokens_per_s": rate, "ms": total * 1e3, "decode_ms": decode * 1e3}
        print(f"[lm sample] B={batch_n} x {SAMPLE_STEPS} codes: {total * 1e3:.3f} ms = {rate:.1f} "
              f"tokens/s; the codec decode alone {decode * 1e3:.3f} ms ({decode / total:.4f} of it); "
              f"audio {tuple(audio.shape)}, {len(torch.unique(codes))} distinct codes; launches "
              f"(attention forward, attention backward, GatedHiFi forward) {counts} [{card}]")
        require(counts == (0, 0, decode_launches), f"sampling launches {counts} != (0, 0, {decode_launches})")
        require(tuple(audio.shape) == (batch_n, samples) and bool(torch.isfinite(audio).all()), "sampled audio")
        require(int(codes.min()) >= 0 and int(codes.max()) < lm.vocab_size, "sampled codes out of range")
        if batch_n == SAMPLE_BATCHES[0]:
            seq = torch.cat([torch.full((batch_n, 1), BOS, device=device), codes[:, :-1] + OFFSET], dim=1)
            kv = cached_logits(lm, seq)
            with torch.no_grad():
                lens = torch.full((batch_n,), SAMPLE_STEPS, dtype=torch.int32, device=device)
                full = lm.classifier(lm._backbone(seq, lens, train=False))
            err, scale = (kv - full).abs().max().item(), full.abs().max().item()
            print(f"[lm sample] KV-cached logits against a full teacher-forced forward over the "
                  f"sampled prefix ({batch_n} x {SAMPLE_STEPS}): max_abs_err {err:.3e} (tol "
                  f"{KV_RTOL * scale:.3e} = {KV_RTOL:g} * max|logit| {scale:.3e})")
            require(err <= KV_RTOL * scale, f"cached logits differ from the full forward: {err}")
    return out


def phase_lm_vs_cpu(device, card: str, vq_state: dict) -> None:
    """One LM train step on the card against the CPU's plain path, dropout 0."""
    batch_n, T = LM_SUBSET
    models = {"cuda": build_lm(device, vq_state, seed=LM_SEED + 1, dropout=0.0)}
    models["cpu"] = copy.deepcopy(models["cuda"]).to("cpu")
    batch = lm_tokens(batch_n, T, seed=50, device="cpu")
    out = {}
    for name, lm in models.items():
        dev = next(lm.parameters()).device
        opt, schedule = lm_optimizer(lm)
        state = TrainState.create(lm, opt, use_ema=True)
        scalars = make_train_step(schedule, default_mu(batch_n, 1), use_ema=True)(
            state, {k: v.to(dev) for k, v in batch.items()}, LM_SEED)
        out[name] = ({k: float(v) for k, v in scalars.items()},
                     {k: p.grad.detach().cpu().double() for k, p in lm.named_parameters() if p.grad is not None})
    grads, ref = out["cuda"][1], out["cpu"][1]
    floor = 1e-4 * np.sqrt(sum(float((g ** 2).sum()) for g in ref.values()))
    rel = {k: ((grads[k] - r).norm().item() / max(r.norm().item(), floor)) for k, r in ref.items()}
    worst = max(rel, key=rel.get)
    median = statistics.median(rel.values())
    print(f"[lm vs cpu] {batch_n} x {T}, dropout 0: card {out['cuda'][0]}; cpu {out['cpu'][0]}; "
          f"gradients of {len(ref)} parameters, relative L2 (denominator floor {floor:.3e}): median "
          f"{median:.3e} (tol {LM_GRAD_MEDIAN_RTOL:g}), worst {rel[worst]:.3e} at {worst} (tol "
          f"{LM_GRAD_WORST_RTOL:g}) [{card}]")
    require(set(grads) == set(ref), "card and CPU differ in which parameters have gradients")
    require(not any(k.startswith(("vqvae_decoder.", "vqvae_bottleneck.")) for k in ref),
            "a frozen codec parameter has a gradient")
    loss_g, loss_c = out["cuda"][0]["loss"], out["cpu"][0]["loss"]
    require(abs(loss_g - loss_c) <= LM_LOSS_RTOL * abs(loss_c), f"LM step loss {loss_g} vs {loss_c}")
    require(median <= LM_GRAD_MEDIAN_RTOL, f"LM step gradients: median {median}")
    require(rel[worst] <= LM_GRAD_WORST_RTOL, f"LM step gradients: {worst} {rel[worst]}")


# ---------------------------------------------------------------------------
# Glow-TTS
# ---------------------------------------------------------------------------
def glow_config(flow_step: bool = False) -> dict:
    """GLOW_TTS_TPU; with ``flow_step`` the B6 route, the override the YAML
    names (fused_flow_step: true)."""
    model = dict(copy.deepcopy(configs.GLOW_TTS_TPU), fused_flow_step=flow_step)
    return {"model": model, "dataset": copy.deepcopy(configs.LJSPEECH_TPU)}


def build_glow(device, seed: int, flow_step: bool = False) -> GlowTTS:
    """GlowTTS at GLOW_TTS_TPU width with the JAX initializers, then the leaves
    those leave at zero drawn from the seed: each coupling's end conv and the
    prenet's proj lecun-normal (the end convs at a quarter of it, so 24 flow
    steps keep the latent finite), ActNorm N(0, 0.1^2). The duration head's
    proj is scaled to 0.3 of lecun-normal with bias log(2.5), so a token lasts
    about 3 frames (LJSpeech speaks about 12 phonemes and blanks a second
    against 86 frames a second)."""
    model = harness.get_model(glow_config(flow_step), device=device)
    require(model.decoder.fused_flow_step == flow_step, f"the decoder's route is not fused_flow_step={flow_step}")
    harness.init_model_variables(model, None, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for module in model.modules():
            if getattr(module, "zero_init", False):
                w = module.weight
                scale = 0.25 if w.shape[0] == model.n_mels * model.n_sqz else 1.0
                w.copy_(torch.randn(w.shape, generator=gen) * scale / np.sqrt(w[0].numel()))
            elif isinstance(module, glow_flows.ActNorm):
                module.logs.copy_(torch.randn(module.logs.shape, generator=gen) * 0.1)
                module.bias.copy_(torch.randn(module.bias.shape, generator=gen) * 0.1)
        proj = model.encoder.proj_w.proj
        proj.weight.mul_(0.3)
        proj.bias.fill_(float(np.log(2.5)))
    return model.eval()


def glow_counts() -> tuple:
    return (enc_ops.enc_layer.launches, wn_ops.wn_coupling.launches, mas_ops.maximum_path_auto.launches,
            fs_ops.flow_step.launches)


def zero_glow_counts() -> None:
    enc_ops.enc_layer.launches = wn_ops.wn_coupling.launches = mas_ops.maximum_path_auto.launches = 0
    fs_ops.flow_step.launches = 0


def ragged(rng, batch: int, lo: int, hi: int) -> np.ndarray:
    lens = rng.randint(lo, hi + 1, (batch,))
    lens[0] = hi
    return lens


def wn_flops_per_frame(w: wn_ops.WNWeights) -> int:
    tensors = [w.ws, w.wend, *w.win, *w.wrs]
    return 2 * sum(t.numel() for t in tensors)


def phase_wn_coupling(model: GlowTTS, device, card: str) -> dict:
    """B3 against its plain version on the first coupling block's weights,
    two calls bitwise equal, then at B3_OTHER_SHAPES."""
    w = model.decoder.flows[2].conditioner_weights()
    half = model.n_mels * model.n_sqz // 2
    out = {"max_abs_err": 0.0}
    for i, (B, T) in enumerate(B3_SHAPES):
        rng = np.random.RandomState(700 + i)
        lens_np = ragged(rng, B, max(1, T // 2), T).astype(np.int32)
        lens = torch.from_numpy(lens_np).to(device)
        valid = torch.arange(T, device=device)[None, :] < lens[:, None]
        x = torch.from_numpy(rng.randn(B, T, 2 * half).astype(np.float32)).to(device) * valid[..., None]
        x0 = x[..., :half]
        with torch.no_grad():
            ours, again = wn_ops.wn_coupling(x0, lens, w), wn_ops.wn_coupling(x0, lens, w)
            ref = wn_ops.wn_coupling_reference(x0, lens, w)
            torch.cuda.synchronize()
            bitwise = torch.equal(ours, again)
            err = (ours - ref)[valid].abs().max().item()
            scale = ref[valid].abs().max().item()
            ms = cuda_ms(lambda: wn_ops.wn_coupling(x0, lens, w))
            plain = cuda_ms(lambda: wn_ops.wn_coupling_reference(x0, lens, w))
            dev = device_ms(lambda: wn_ops.wn_coupling(x0, lens, w)) if i == 0 else None
        frames = int(lens_np.sum())  # padded frames are masked: the work is the valid ones
        flops = frames * wn_flops_per_frame(w)
        nbytes = 4 * (frames * (x0.shape[2] + ours.shape[2]) + sum(t.numel() for t in (
            w.ws, w.bs, w.wend, w.bend, *w.win, *w.bin, *w.wrs, *w.brs)))
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"[B3] B={B} T={T} (squeezed frames) half={half} H={w.hidden}: max_abs_err {err:.3e} (tol "
              f"{B3_RTOL * scale:.3e} = {B3_RTOL:g} * max|ref| {scale:.3e}) at valid frames; two calls bitwise "
              f"equal {bitwise}; kernel {ms:.4f} ms, plain {plain:.4f} ms (median of 10)"
              + (f", kernel back to back {dev:.4f} ms a call ({DEVICE_REPS} calls)" if dev is not None else "")
              + f"; bound {bound_ms:.4f} ms by {bound_by}, 3xTF32 bound {tf32_bound_ms(flops, nbytes):.4f} ms "
              f"({frames} valid frames: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) [{card}]")
        require(np.isfinite(err) and err <= B3_RTOL * scale, f"B3 disagrees at B={B} T={T}: {err}")
        require(bitwise, f"B3: two forward calls differ at B={B} T={T}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if i == 0:  # the val step's shape
            out.update(ms=dev, call_ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                       tf32_ms=tf32_bound_ms(flops, nbytes))
    out["max_abs_err"] = max(out["max_abs_err"], other_forward_shapes(device, card, flow_step=False))
    return out


def enc_flops(lens: np.ndarray, w: enc_ops.EncLayerWeights) -> int:
    """The work of the valid rows: per token QKV, conv_o and the FFN; per valid
    (query, key) pair q.k and p.v over all heads; per valid pair in the band
    |j - i| <= w the two relative terms. Padded rows and masked keys add nothing."""
    C, Fc, k = w.wq.shape[0], w.w1.shape[0], w.w1.shape[2]
    D = C // w.n_heads
    tokens = int(lens.sum())
    pairs = int((lens.astype(np.int64) ** 2).sum())
    i = np.arange(int(lens.max()))
    band = sum(int((np.minimum(i[:n] + w.window, n - 1) - np.maximum(i[:n] - w.window, 0) + 1).sum()) for n in lens)
    return tokens * (8 * C * C + 4 * k * C * Fc) + 4 * C * pairs + 4 * D * w.n_heads * band


def phase_enc_layer(model: GlowTTS, device, card: str) -> dict:
    """B5 against its plain version on the first encoder layer's weights."""
    w = model.encoder.layer_weights(0)
    C = w.wq.shape[0]
    out = {"max_abs_err": 0.0}
    for i, (B, T) in enumerate(B5_SHAPES):
        rng = np.random.RandomState(800 + i)
        lens_np = ragged(rng, B, max(1, T // 2), T).astype(np.int32)
        lens = torch.from_numpy(lens_np).to(device)
        valid = torch.arange(T, device=device)[None, :] < lens[:, None]
        x = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device)
        with torch.no_grad():
            ours = enc_ops.enc_layer(x, lens, w)
            ref = enc_ops.enc_layer_reference(x, lens, w)
            torch.cuda.synchronize()
            err = (ours - ref)[valid].abs().max().item()
            scale = ref[valid].abs().max().item()
            finite = bool(torch.isfinite(ours).all())
            ms = cuda_ms(lambda: enc_ops.enc_layer(x, lens, w))
            dev = device_ms(lambda: enc_ops.enc_layer(x, lens, w)) if i == 0 else None
            plain = cuda_ms(lambda: enc_ops.enc_layer_reference(x, lens, w))
        flops = enc_flops(lens_np, w)
        nbytes = 4 * (2 * int(lens_np.sum()) * C + sum(t.numel() for t in w.tensors().values()))
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"[B5] B={B} T={T} C={C} heads {w.n_heads} window {w.window}: max_abs_err {err:.3e} (tol "
              f"{B5_RTOL * scale:.3e} = {B5_RTOL:g} * max|ref| {scale:.3e}) at valid rows, all finite {finite}; "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms (median of 10)"
              + (f", kernel back to back {dev:.4f} ms a call ({DEVICE_REPS} calls)" if dev is not None else "")
              + f"; bound {bound_ms:.4f} ms by {bound_by}, 3xTF32 bound {tf32_bound_ms(flops, nbytes):.4f} ms "
              f"({int(lens_np.sum())} valid rows: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) [{card}]")
        require(np.isfinite(err) and err <= B5_RTOL * scale, f"B5 disagrees at B={B} T={T}: {err}")
        require(finite, f"B5 output not finite at B={B} T={T}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if i == 0:  # the val step's shape
            out.update(ms=dev, call_ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                       tf32_ms=tf32_bound_ms(flops, nbytes))
    return out


def mas_inputs(B: int, t_x: int, t_y: int, seed: int, ties: bool, device):
    rng = np.random.RandomState(seed)
    value = rng.randn(B, t_x, t_y).astype(np.float32)
    if ties:
        value = np.round(value * 4) / 4
    x_len = ragged(rng, B, t_x // 2, t_x)
    y_len = np.maximum(ragged(rng, B, t_y // 2, t_y), x_len)
    mask = ((np.arange(t_x)[None, :, None] < x_len[:, None, None])
            & (np.arange(t_y)[None, None, :] < y_len[:, None, None])).astype(np.float32)
    return torch.from_numpy(value).to(device), torch.from_numpy(mask).to(device)


def phase_mas(device, card: str) -> dict:
    """B4 against its plain version, bit for bit, at MAS_SHAPES (and with
    ties) and MAS_EDGE_SHAPES; one call (CUDA events, median of 10) and
    DEVICE_REPS back-to-back calls; the chain's ns per frame between
    MAS_SHAPES[0] and the edge shape with twice its frames."""
    out, b2b = {}, {}
    cases = ([(shape, False) for shape in MAS_SHAPES] + [(MAS_SHAPES[0], True)]
             + [(shape, False) for shape in MAS_EDGE_SHAPES])
    for i, ((B, t_x, t_y), ties) in enumerate(cases):
        value, mask = mas_inputs(B, t_x, t_y, 900 + i, ties, device)
        path = mas_ops.maximum_path_auto(value, mask)
        ref = mas_ops.maximum_path(value, mask)
        torch.cuda.synchronize()
        equal = torch.equal(path, ref)
        covers = torch.equal(path.sum(dim=1), mask[:, 0, :])
        ms = cuda_ms(lambda: mas_ops.maximum_path_auto(value, mask))
        dev = device_ms(lambda: mas_ops.maximum_path_auto(value, mask))
        if not ties:
            b2b[(B, t_x, t_y)] = dev
        cells = int(mask.sum())  # the DP reads value and mask at valid cells only; the path is written whole
        nbytes = 4 * (2 * cells + value.numel())
        bound_ms, bound_by = bound(3 * cells, nbytes)
        plain = cuda_ms(lambda: mas_ops.maximum_path(value, mask), reps=3, warmup=1) if i == 0 else None
        print(f"[B4] [{B}, {t_x}, {t_y}]{' values in steps of 0.25 (exact ties)' if ties else ''}: path equal to "
              f"the plain version's bit for bit {equal}, one token per valid frame {covers}; kernel {ms:.4f} ms "
              f"(median of 10), {dev:.4f} over {DEVICE_REPS} back-to-back calls"
              + (f", plain {plain:.2f} ms (median of 3)" if plain is not None else "")
              + f"; bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB; the DP's {t_y} serial frames are "
              f"the real limit) [{card}]")
        require(equal, f"B4 differs from the plain version at [{B}, {t_x}, {t_y}] ties={ties}")
        require(covers, f"B4 path does not cover the valid frames at [{B}, {t_x}, {t_y}]")
        if i == 0:
            out.update(ms=dev, call_ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by)
    B, t_x, t_y = MAS_SHAPES[0]
    out["ns_per_frame"] = (b2b[(B, t_x, 2 * t_y)] - b2b[(B, t_x, t_y)]) / t_y * 1e6
    print(f"[B4] the chain's cost: {out['ns_per_frame']:.1f} ns per frame (back-to-back time, [{B}, {t_x}, "
          f"{2 * t_y}] less [{B}, {t_x}, {t_y}], over {t_y} frames) [{card}]")
    out["max_abs_err"] = 0.0
    return out


def glow_val_batch(batch: int, device, seed: int) -> dict:
    """Seeded audio of GLOW_FRAMES frames and token ids with ragged lengths."""
    rng = np.random.RandomState(seed)
    samples = GLOW_FRAMES * HOP
    frames = ragged(rng, batch, GLOW_FRAMES // 2, GLOW_FRAMES)
    tokens = np.minimum(ragged(rng, batch, GLOW_TOKENS // 2, GLOW_TOKENS), frames)
    t = np.arange(samples) / configs.LJSPEECH_TPU["sample_rate"]
    pitch = rng.uniform(100, 300, (batch, 1))
    audio = 0.3 * np.sin(2 * np.pi * pitch * t[None]) + 0.05 * rng.randn(batch, samples)
    audio *= np.arange(samples)[None, :] < frames[:, None] * HOP
    ids = rng.randint(0, configs.GLOW_TTS_TPU["encoder"]["n_vocab"] + 1, (batch, GLOW_TOKENS))
    ids *= np.arange(GLOW_TOKENS)[None, :] < tokens[:, None]
    return {"token": torch.from_numpy(ids).to(device), "token_len": torch.from_numpy(tokens).to(device),
            "audio": torch.from_numpy(audio.astype(np.float32)).to(device),
            "audio_len": torch.from_numpy(frames * HOP).to(device)}


def phase_glow_val(model: GlowTTS, device, card: str, expect: tuple = (6, 24, 1, 0)) -> dict:
    """The val step on the EMA parameters, the mel computed on the card;
    ``expect`` is its launches (B5, B3, B4, B6) per step."""
    opt, _ = build_optimizer(model.parameters(), configs.GLOW_TTS_TPU_OPTIMIZER, configs.GLOW_TTS_TPU_SCHEDULER,
                             configs.GLOW_TTS_TPU)
    state = TrainState.create(model, opt, use_ema=True)
    batch = glow_val_batch(GLOW_BATCH, device, seed=30)
    val_step = make_val_step(use_ema=True)
    val_step(state, batch)  # warm-up
    torch.cuda.synchronize()
    times, counts = [], []
    for _ in range(3):
        zero_glow_counts()
        t0 = time.perf_counter()
        loss, _ = val_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(glow_counts())
    losses = {k: float(loss[k]) for k in ("loss", "loss_mle", "loss_length")}
    yh = loss["yh"]
    route = "B6 route" if model.decoder.fused_flow_step else "B3 route"
    print(f"[glow val] {route}, B={GLOW_BATCH} x {GLOW_FRAMES} frames ({GLOW_FRAMES * HOP} samples) and "
          f"{GLOW_TOKENS} tokens, ragged; mel on the card {tuple(loss['y'].shape)}; EMA parameters: losses {losses}; "
          f"yh {tuple(yh.shape)}; launches (B5, B3, B4, B6) per step {counts}; step ms "
          f"{', '.join(f'{t:.3f}' for t in times)}, median {statistics.median(times):.3f} [{card}]")
    require(all(c == expect for c in counts), f"val step launches {counts} != {expect}")
    require(all(np.isfinite(v) for v in losses.values()), f"val losses {losses}")
    require(tuple(yh.shape) == tuple(loss["y"].shape) and bool(torch.isfinite(yh).all()), "val yh")
    return {"launches": counts[0], "step_ms": statistics.median(times), "batch": batch, "state": state}


def audio_seconds(z_lengths: torch.Tensor, max_frames: int) -> float:
    return float(torch.clamp(z_lengths, max=max_frames).sum()) * HOP / configs.LJSPEECH_TPU["sample_rate"]


def phase_synthesis(model: GlowTTS, device, card: str) -> dict:
    """GlowTTSSynthesizer.synthesize_ids at batch 1 and 8."""
    rng = np.random.RandomState(40)
    n_vocab = configs.GLOW_TTS_TPU["encoder"]["n_vocab"] + 1
    ids = torch.from_numpy(rng.randint(0, n_vocab, (max(SYNTH_BATCHES), GLOW_TOKENS))).to(device)
    lens = torch.from_numpy(ragged(rng, max(SYNTH_BATCHES), SYNTH_MIN_TOKENS, GLOW_TOKENS)).to(device)
    gen = lambda s: torch.Generator(device=device).manual_seed(s)  # noqa: E731
    uncached, _ = model.infer(ids[:2], lens[:2], generator=gen(1), max_frames=SYNTH_MAX_FRAMES, noise_scale=0.667)
    synth = GlowTTSSynthesizer(model, glow_config(), max_frames=SYNTH_MAX_FRAMES, gl_iters=GL_ITERS)
    folded = synth.model.decoder.flows[2].start.folded_weight
    require(folded is not None, "the synthesizer built no flow cache")
    require(model.decoder.flows[2].start.folded_weight is None, "the synthesizer cached the caller's model")
    cached, _ = synth.synthesize_mel(ids[:2], gen(1), 0.667, lens[:2])
    cache_err = (cached - uncached).abs().max().item()
    cache_scale = uncached.abs().max().item()
    out = {"launches": None}
    for B in SYNTH_BATCHES:
        mel_ms, total_ms, per_call = [], [], []
        for rep in range(SYNTH_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mel, z = synth.synthesize_mel(ids[:B], gen(rep), 0.667, lens[:B])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            zero_glow_counts()
            mel, audio, z = synth.synthesize_ids(ids[:B], gen(rep), 0.667, lens[:B])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            per_call.append(glow_counts())
            if rep:  # the first is a warm-up
                mel_ms.append((t1 - t0) * 1e3)
                total_ms.append((t2 - t1) * 1e3)
        secs = audio_seconds(z, synth.max_frames)
        med_mel, med_total = statistics.median(mel_ms), statistics.median(total_ms)
        print(f"[synthesis] B={B}, tokens {lens[:B].tolist()}: z_lengths {z.tolist()}; mel {tuple(mel.shape)}, "
              f"audio {tuple(audio.shape)}; launches (B5, B3, B4, B6) per call {per_call[-1]}; median of "
              f"{SYNTH_REPS}: mel {med_mel:.3f} ms, text to waveform ({GL_ITERS} Griffin-Lim iterations) "
              f"{med_total:.3f} ms; {secs:.3f} s of audio: {secs / (med_mel / 1e3):.1f} s/s as mel, "
              f"{secs / (med_total / 1e3):.1f} s/s as waveform [{card}]")
        require(all(c == (6, 12, 0, 0) for c in per_call), f"synthesis launches {per_call} != (6, 12, 0, 0)")
        require(bool(torch.isfinite(mel).all()) and bool(torch.isfinite(audio).all()), "synthesis output")
        require(tuple(audio.shape) == (B, synth.max_frames * HOP), f"audio shape {tuple(audio.shape)}")
        out[B] = {"mel_ms": med_mel, "total_ms": med_total, "audio_s": secs}
        out["launches"] = per_call[-1]
    require(synth.model.decoder.flows[2].start.folded_weight is folded, "the flow cache was rebuilt")
    print(f"[synthesis] flow cache built once, on the synthesizer's own copy; cached against the caller's uncached mel (B=2): max_abs_err {cache_err:.3e} "
          f"(tol {1e-5 * cache_scale:.3e}) [{card}]")
    require(cache_err <= 1e-5 * cache_scale, f"cached mel differs: {cache_err}")
    return out


def phase_glow_vs_cpu(model: GlowTTS, batch: dict, device, card: str) -> None:
    """The eval forward on the card against the CPU on a 2-sequence subset."""
    n = GLOW_VS_CPU
    sub = {k: v[:n] for k, v in batch.items()}
    with torch.no_grad():
        spect, spect_len = spect_from_audio(model, sub)
        x, x_len = sub["token"], sub["token_len"]
        T = int(spect_len.max()) // model.n_sqz * model.n_sqz
        noise = torch.randn(n, T, model.n_mels, generator=torch.Generator().manual_seed(9)).to(device)
        cpu = copy.deepcopy(model).to("cpu")
        loss_g, _ = model(x, x_len, spect, spect_len, noise=noise)
        loss_c, _ = cpu(x.cpu(), x_len.cpu(), spect.cpu(), spect_len.cpu(), noise=noise.cpu())
        x_m, x_logs, _, x_mask = model.encoder(x, x_len)
        y_len = spect_len // model.n_sqz * model.n_sqz
        y_mask = (torch.arange(T, device=device)[None, :] < y_len[:, None]).float()[..., None]
        z, _ = model.decoder(spect[:, :T], y_mask)
        logp = mas_ops.mas_log_prior(x_m, x_logs, z)
        attn_mask = x_mask[:, :, 0][:, :, None] * y_mask[:, :, 0][:, None, :]
        path_g = mas_ops.maximum_path_auto(logp, attn_mask).cpu()
        path_c = mas_ops.maximum_path(logp.cpu(), attn_mask.cpu())
    yh_err = (loss_g["yh"].cpu() - loss_c["yh"]).abs().max().item()
    yh_scale = loss_c["yh"].abs().max().item()
    rels = {k: abs(float(loss_g[k]) - float(loss_c[k])) / max(abs(float(loss_c[k])), 1e-12)
            for k in ("loss", "loss_mle", "loss_length")}
    print(f"[glow vs cpu] {n} sequences: losses card {[round(float(loss_g[k]), 7) for k in rels]} cpu "
          f"{[round(float(loss_c[k]), 7) for k in rels]}, relative {rels} (tol {GLOW_LOSS_RTOL:g}); yh max_abs_err "
          f"{yh_err:.3e} (tol {GLOW_YH_RTOL * yh_scale:.3e}); MAS on the CPU on the card's log-prior table equal "
          f"to the card's path bit for bit {torch.equal(path_g, path_c)} [{card}]")
    for k, rel in rels.items():
        require(rel <= GLOW_LOSS_RTOL, f"glow {k} differs: {rel}")
    require(yh_err <= GLOW_YH_RTOL * yh_scale, f"glow yh differs: {yh_err}")
    require(torch.equal(path_g, path_c), "MAS on the CPU differs from the card's path")


# ---------------------------------------------------------------------------
# Glow-TTS training
# ---------------------------------------------------------------------------
def leaf_report(ours: dict, ref: dict) -> dict:
    """name -> (max abs error, scale): the scale is the leaf's max|ref|, floored
    at GRAD_FLOOR of the largest leaf's (a leaf whose true gradient is zero,
    like the key bias under the shift-invariant softmax, holds rounding only)."""
    top = max(t.abs().max().item() for t in ref.values())
    return {n: ((ours[n] - ref[n]).abs().max().item(), max(ref[n].abs().max().item(), GRAD_FLOOR * top))
            for n in ref}


def keep_rates_ok(rates: dict, p: float) -> None:
    """rates: site -> (kept, checked); each within 5 sigma of 1 - p."""
    q = 1.0 - p
    for site, (kept, n) in rates.items():
        require(abs(kept / n - q) <= 5 * np.sqrt(q * p / n), f"{site}: keep rate {kept / n} vs {q} over {n}")


def print_grads(tag: str, dx_err: float, dx_scale: float, leaves: dict, bitwise: bool, fwd: tuple, times: dict,
                bnd: tuple, card: str) -> None:
    worst = max(leaves, key=lambda n: leaves[n][0] / leaves[n][1])
    print(f"{tag}: dx max_abs_err {dx_err:.3e} (tol {DX_RTOL * dx_scale:.3e}) at valid rows; worst weight grad "
          f"{worst} {leaves[worst][0]:.3e} of scale {leaves[worst][1]:.3e} (tol {WGRAD_RTOL:g}x); two calls bitwise "
          f"equal {bitwise}; train-mode forward max_abs_err {fwd[0]:.3e} (tol {fwd[1]:.3e}); ms (median of 5): "
          f"backward kernels {times['bwd']:.4f}, plain backward {times['plain']:.4f}, forward kernel "
          f"{times['fwd']:.4f}, plain forward {times['fwd_plain']:.4f}"
          + (f"; backward kernels back to back {times['dev']:.4f} ms a call ({DEVICE_REPS} calls)" if "dev" in times
             else "") + f"; backward bound {bnd[0]:.4f} ms by {bnd[1]} [{card}]")
    require_grads(tag, dx_err, dx_scale, leaves, bitwise)
    require(np.isfinite(fwd[0]) and fwd[0] <= fwd[1], f"{tag}: the train-mode forward differs: {fwd[0]}")


def require_grads(tag: str, dx_err: float, dx_scale: float, leaves: dict, bitwise: bool) -> None:
    require(np.isfinite(dx_err) and dx_err <= DX_RTOL * dx_scale, f"{tag}: dx differs: {dx_err}")
    for name, (err, scale) in leaves.items():
        require(np.isfinite(err) and err <= WGRAD_RTOL * scale, f"{tag}: grad {name} differs: {err} > "
                f"{WGRAD_RTOL} * {scale}")
    require(bitwise, f"{tag}: two backward calls differ")


def small_conditioner(rng, half: int, H: int, taps: int, rate: int, L: int, device) -> wn_ops.WNWeights:
    """A seeded conditioner of out width 2 half (B3_OTHER_SHAPES)."""
    def w(*shape):
        fan_in = shape[1] * shape[2] if len(shape) == 3 else 10
        return torch.from_numpy((rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)).to(device)
    rs = [2 * H if i < L - 1 else H for i in range(L)]
    return wn_ops.WNWeights(ws=w(H, half, 1), bs=w(H), win=tuple(w(2 * H, H, taps) for _ in range(L)),
                            bin=tuple(w(2 * H) for _ in range(L)), wrs=tuple(w(r, H, 1) for r in rs),
                            brs=tuple(w(r) for r in rs), wend=w(2 * half, H, 1), bend=w(2 * half),
                            dilations=tuple(rate ** i for i in range(L)))


def other_shape_inputs(j: int, device, flow_step: bool) -> tuple:
    """(weights, lens, valid, the kernel's first arguments, two cotangents) of
    B3_OTHER_SHAPES[j], seeded: B3's x0 a view whose row stride and offset
    are not multiples of 4 floats, B6's x contiguous with its ActNorm and a
    rotation as the InvConvNear."""
    B, T, half, H, taps, rate, L = B3_OTHER_SHAPES[j]
    rng = np.random.RandomState(740 + j)
    w = small_conditioner(rng, half, H, taps, rate, L, device)
    lens = torch.from_numpy(ragged(rng, B, T // 2, T).astype(np.int32)).to(device)
    valid = torch.arange(T, device=device)[None, :] < lens[:, None]
    x = torch.from_numpy(rng.randn(B, T, 2 * half + 1).astype(np.float32)).to(device) * valid[..., None]
    gs = [torch.from_numpy(rng.randn(B, T, 2 * half).astype(np.float32)).to(device) for _ in range(2)]
    if not flow_step:
        return w, lens, valid, (x[..., 1:1 + half],), gs
    xf = x[..., :2 * half].contiguous()
    aln, alb = (torch.from_numpy((0.1 * rng.randn(2 * half)).astype(np.float32)).to(device) for _ in range(2))
    mt = torch.from_numpy(np.linalg.qr(rng.randn(2 * half, 2 * half))[0].astype(np.float32)).to(device)
    return w, lens, valid, (xf, lens, aln, alb, mt), gs


def other_forward_shapes(device, card: str, flow_step: bool) -> float:
    """B3's (flow_step False) or B6's forward kernel against its plain
    version at B3_OTHER_SHAPES, p=0 and B3_DROP, within B3_RTOL of max|ref|
    at valid frames, two calls bitwise equal. Returns the largest error."""
    worst = 0.0
    seed = torch.tensor([4545], dtype=torch.int64, device=device)
    for j, (B, T, half, H, taps, rate, L) in enumerate(B3_OTHER_SHAPES):
        w, lens, valid, head, _ = other_shape_inputs(j, device, flow_step)
        if flow_step:
            args = (*head, w)
            kernel, plain = fs_ops.flow_step, fs_ops.flow_step_reference
        else:
            args = (head[0], lens, w)
            kernel = lambda *a: (wn_ops.wn_coupling(*a),)  # noqa: E731
            plain = lambda *a: (wn_ops.wn_coupling_reference(*a),)  # noqa: E731
        for p in (0.0, B3_DROP):
            with torch.no_grad():
                ours, again, ref = kernel(*args, seed, p), kernel(*args, seed, p), plain(*args, seed, p)
                torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(ours, again))
            errs = [((o - r)[valid].abs().max().item(), r[valid].abs().max().item()) for o, r in zip(ours, ref)]
            tag = f"[{'B6' if flow_step else 'B3'} fwd] p={p} B={B} T={T} half={half} H={H} k={taps} rate={rate} L={L}"
            print(f"{tag}: " + ", ".join(f"{n} max_abs_err {e:.3e} (tol {B3_RTOL * sc:.3e})" for n, (e, sc) in zip(
                ("xc", "out") if flow_step else ("out",), errs)) + f" at valid frames; two calls bitwise equal "
                f"{bitwise} [{card}]")
            for err, scale in errs:
                require(np.isfinite(err) and err <= B3_RTOL * scale, f"{tag}: the forward differs: {err}")
                worst = max(worst, err)
            require(bitwise, f"{tag}: two forward calls differ")
    return worst


def other_backward_shapes(device, card: str, flow_step: bool) -> float:
    """B3's (flow_step False) or B6's backward kernels against the plain
    backward at B3_OTHER_SHAPES, p=0 and B3_DROP, two calls bitwise equal;
    B3's x0 is a view whose row stride and offset are not multiples of 4
    floats. Returns the largest dx error."""
    worst = 0.0
    seed = torch.tensor([4444], dtype=torch.int64, device=device)
    for j, (B, T, half, H, taps, rate, L) in enumerate(B3_OTHER_SHAPES):
        w, lens, valid, head, gs = other_shape_inputs(j, device, flow_step)
        if flow_step:
            args = (*head, w, *gs)
            kernel, plain = fs_ops.flow_step_backward, fs_ops.flow_step_backward_reference
            leaves = lambda out: {"daln": out[1], "dalb": out[2], "dmt": out[3], **out[4].tensors()}  # noqa: E731
        else:
            args = (head[0], lens, w, gs[0])
            kernel, plain = wn_ops.wn_coupling_backward, wn_ops.wn_coupling_backward_reference
            leaves = lambda out: out[1].tensors()  # noqa: E731
        for p in (0.0, B3_DROP):
            with torch.no_grad():
                ours, again, ref = kernel(*args, seed, p), kernel(*args, seed, p), plain(*args, seed, p)
                torch.cuda.synchronize()
            bitwise = torch.equal(ours[0], again[0]) and all(
                torch.equal(a, leaves(again)[n]) for n, a in leaves(ours).items())
            dx_err = (ours[0] - ref[0])[valid].abs().max().item()
            dx_scale = ref[0][valid].abs().max().item()
            report = leaf_report(leaves(ours), leaves(ref))
            top = max(report, key=lambda n: report[n][0] / report[n][1])
            tag = f"[{'B6' if flow_step else 'B3'} bwd] p={p} B={B} T={T} half={half} H={H} k={taps} rate={rate} L={L}"
            print(f"{tag}: dx max_abs_err {dx_err:.3e} (tol {DX_RTOL * dx_scale:.3e}); worst weight grad {top} "
                  f"{report[top][0]:.3e} of scale {report[top][1]:.3e} (tol {WGRAD_RTOL:g}x); two calls bitwise "
                  f"equal {bitwise} [{card}]")
            require_grads(tag, dx_err, dx_scale, report, bitwise)
            worst = max(worst, dx_err)
    return worst


def phase_wn_coupling_bwd(model: GlowTTS, device, card: str) -> dict:
    """B3's backward kernels against the plain backward at p=0 and the
    decoder's p, then its dropout masks read back from the recompute."""
    w = model.decoder.flows[2].conditioner_weights()
    half, C, H, L = model.n_mels * model.n_sqz // 2, w.wend.shape[0], w.hidden, len(w.win)
    seed = torch.tensor([4242], dtype=torch.int64, device=device)
    out = {"max_abs_err": 0.0}
    for i, (B, T) in enumerate(B3_SHAPES):
        rng = np.random.RandomState(720 + i)
        lens_np = ragged(rng, B, max(1, T // 2), T).astype(np.int32)
        lens = torch.from_numpy(lens_np).to(device)
        valid = torch.arange(T, device=device)[None, :] < lens[:, None]
        x = torch.from_numpy(rng.randn(B, T, 2 * half).astype(np.float32)).to(device) * valid[..., None]
        x0 = x[..., :half]
        g = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device)
        for p in (0.0, B3_DROP):
            args = (x0, lens, w, g, seed, p)
            with torch.no_grad():
                dx_k, gw_k = wn_ops.wn_coupling_backward(*args)
                dx_k2, gw_k2 = wn_ops.wn_coupling_backward(*args)
                dx_r, gw_r = wn_ops.wn_coupling_backward_reference(*args)
                fwd_k = wn_ops.wn_coupling(x0, lens, w, seed, p)
                fwd_r = wn_ops.wn_coupling_reference(x0, lens, w, seed, p)
                torch.cuda.synchronize()
                bitwise = torch.equal(dx_k, dx_k2) and all(torch.equal(a, b) for a, b in zip(gw_k.flat(), gw_k2.flat()))
                fwd = ((fwd_k - fwd_r)[valid].abs().max().item(), B3_RTOL * fwd_r[valid].abs().max().item())
                times = {"bwd": cuda_ms(lambda: wn_ops.wn_coupling_backward(*args), reps=5, warmup=1),
                         "plain": cuda_ms(lambda: wn_ops.wn_coupling_backward_reference(*args), reps=5, warmup=1),
                         "fwd": cuda_ms(lambda: wn_ops.wn_coupling(x0, lens, w, seed, p), reps=5, warmup=1),
                         "fwd_plain": cuda_ms(lambda: wn_ops.wn_coupling_reference(x0, lens, w, seed, p), reps=5,
                                              warmup=1)}
                if i == 0 and p > 0:  # the train step's shape: the card's time alone
                    times["dev"] = device_ms(lambda: wn_ops.wn_coupling_backward(*args))
            frames = int(lens_np.sum())
            weights = sum(t.numel() for t in w.flat())
            # recompute, transposed products and weight products: 3x the forward's operations;
            # x0 and g in, dx0 out, the weights in and their gradients out
            work = (3 * frames * wn_flops_per_frame(w), 4 * (frames * (2 * half + C) + 2 * weights))
            bnd = bound(*work)
            dx_err = (dx_k - dx_r)[valid].abs().max().item()
            print_grads(f"[B3 bwd] p={p} B={B} T={T}", dx_err, dx_r[valid].abs().max().item(),
                        leaf_report(gw_k.tensors(), gw_r.tensors()), bitwise, fwd, times, bnd, card)
            out["max_abs_err"] = max(out["max_abs_err"], dx_err)
            if i == 0 and p > 0:  # the train step's shape
                out.update(ms=times["dev"], call_ms=times["bwd"], plain_ms=times["plain"], bound_ms=bnd[0],
                           bound_by=bnd[1], fwd_ms=times["fwd"], fwd_plain_ms=times["fwd_plain"],
                           tf32_ms=tf32_bound_ms(*work))
            del dx_k, gw_k, dx_k2, gw_k2, dx_r, gw_r
    other_backward_shapes(device, card, flow_step=False)
    # the masks: with conv biases of 10 (conv weights scaled down) every pre-dropout
    # x_in is positive, so the recompute's x_in > 0 exactly where the kernel kept it
    B, T = B3_SHAPES[0]
    rng = np.random.RandomState(760)
    lens = torch.from_numpy(ragged(rng, B, T // 2, T).astype(np.int32)).to(device)
    x0 = torch.from_numpy(rng.randn(B, T, half).astype(np.float32)).to(device)
    g = torch.zeros(B, T, C, device=device)
    probe = wn_ops.WNWeights(ws=w.ws, bs=w.bs, win=tuple(t * 0.01 for t in w.win),
                             bin=tuple(torch.full_like(b, 10.0) for b in w.bin), wrs=w.wrs, brs=w.brs,
                             wend=w.wend, bend=w.bend, dilations=w.dilations)
    with torch.no_grad():
        plain = wn_ops.wn_coupling_backward(x0, lens, probe, g, seed, 0.0, return_buffers=True)[2]["xin"]
        require(bool((plain > 0).all()), "the B3 dropout probe's conv outputs are not all positive")
        bufs = [wn_ops.wn_coupling_backward(x0, lens, probe, g, s_, B3_DROP, return_buffers=True)[2]["xin"] > 0
                for s_ in (seed, seed, seed + 1)]
    for i in range(L):
        require(torch.equal(bufs[0][i], wn_ops.keep_mask(seed, lens, T, i, 2 * H, B3_DROP) > 0),
                f"B3 layer {i}: the kernel's masks differ from the plain version's")
    n = bufs[0].numel()
    keep_rates_ok({"x_in": (int(bufs[0].sum()), n)}, B3_DROP)
    changed = (bufs[0] != bufs[2]).float().mean().item()
    print(f"[B3 dropout] p={B3_DROP} B={B} T={T}: the kernel's masks of all {L} layers equal the plain version's "
          f"bit for bit; keep rate {bufs[0].float().mean().item():.6f} (expect {1 - B3_DROP:.6f}, 5 sigma "
          f"{5 * np.sqrt(B3_DROP * (1 - B3_DROP) / n):.1e}); same seed same masks {torch.equal(bufs[0], bufs[1])}; "
          f"another seed changes {changed:.4f} [{card}]")
    require(torch.equal(bufs[0], bufs[1]), "B3: the same seed gave other masks")
    require(changed > B3_DROP, f"B3: another seed changed only {changed} of the masks")
    return out


def phase_flow_step(model: GlowTTS, device, card: str) -> dict:
    """B6 against its plain version at p=0 and the decoder's p on the first
    flow step's weights, the B3 route it replaces against it, then its masks
    against the B3 plain version's."""
    act, inv, cpl = model.decoder.flows[0], model.decoder.flows[1], model.decoder.flows[2]
    w = cpl.conditioner_weights()
    w = wn_ops.WNWeights.from_flat([t.detach() for t in w.flat()], w.dilations)
    with torch.no_grad():
        aln, alb, mt = act.logs.view(-1).clone(), act.bias.view(-1).clone(), inv.dense_matrix_t()
    C = model.n_mels * model.n_sqz
    half, H, L = C // 2, w.hidden, len(w.win)
    seed = torch.tensor([4343], dtype=torch.int64, device=device)
    n_weights = sum(t.numel() for t in w.flat()) + 2 * C + C * C
    out = {"max_abs_err": 0.0, "fwd_err": 0.0}
    for i, (B, T) in enumerate(B3_SHAPES):
        rng = np.random.RandomState(720 + i)  # phase 22's lengths: the same valid frames as B3's backward
        lens_np = ragged(rng, B, max(1, T // 2), T).astype(np.int32)
        lens = torch.from_numpy(lens_np).to(device)
        valid = torch.arange(T, device=device)[None, :] < lens[:, None]
        mask = valid[..., None].float()
        x = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device) * mask
        g_xc, g_out = (torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device) for _ in range(2))
        frames = int(lens_np.sum())
        # B3's operations plus the [C, C] product a frame (3x in the backward); x in, xc and out out
        # (x, g_xc, g_out in, dx out), the weights in (and their gradients out)
        flops = frames * (wn_flops_per_frame(w) + 2 * C * C)
        work = {"fwd": (flops, 4 * (3 * frames * C + n_weights)),
                "bwd": (3 * flops, 4 * (4 * frames * C + 2 * n_weights))}
        bnd = {key: bound(*w_) for key, w_ in work.items()}
        for p in (0.0, B3_DROP):
            args = (x, lens, aln, alb, mt, w)
            with torch.no_grad():
                xc_k, out_k = fs_ops.flow_step(*args, seed, p)
                xc_k2, out_k2 = fs_ops.flow_step(*args, seed, p)
                xc_r, out_r = fs_ops.flow_step_reference(*args, seed, p)
                dx_k, *gk = fs_ops.flow_step_backward(*args, g_xc, g_out, seed, p)
                dx_k2, *gk2 = fs_ops.flow_step_backward(*args, g_xc, g_out, seed, p)
                dx_r, *gr = fs_ops.flow_step_backward_reference(*args, g_xc, g_out, seed, p)
                torch.cuda.synchronize()
            leaves = lambda g: {"daln": g[0], "dalb": g[1], "dmt": g[2], **g[3].tensors()}  # noqa: E731
            bitwise = torch.equal(dx_k, dx_k2) and all(torch.equal(a, leaves(gk2)[n]) for n, a in leaves(gk).items())
            fwd_bitwise = torch.equal(xc_k, xc_k2) and torch.equal(out_k, out_k2)
            fwd_errs = {n: ((k - r)[valid].abs().max().item(), r[valid].abs().max().item())
                        for n, k, r in (("xc", xc_k, xc_r), ("out", out_k, out_r))}
            times = {"fwd": cuda_ms(lambda: fs_ops.flow_step(*args, seed, p), reps=5, warmup=1),
                     "fwd_plain": cuda_ms(lambda: fs_ops.flow_step_reference(*args, seed, p), reps=5, warmup=1),
                     "bwd": cuda_ms(lambda: fs_ops.flow_step_backward(*args, g_xc, g_out, seed, p), reps=5, warmup=1),
                     "plain": cuda_ms(lambda: fs_ops.flow_step_backward_reference(*args, g_xc, g_out, seed, p),
                                      reps=5, warmup=1)}
            if i == 0 and p > 0:  # the train step's shape: the card's time alone
                with torch.no_grad():
                    times["dev"] = device_ms(lambda: fs_ops.flow_step_backward(*args, g_xc, g_out, seed, p))
                    times["fwd_dev"] = device_ms(lambda: fs_ops.flow_step(*args, seed, p))
            routes = flow_step_routes(act, inv, x, mask, lens, w, g_xc, g_out, seed, p)
            dx_err = (dx_k - dx_r)[valid].abs().max().item()
            tag = f"[B6] p={p} B={B} T={T}"
            print(f"{tag}: forward xc max_abs_err {fwd_errs['xc'][0]:.3e} of max|ref| {fwd_errs['xc'][1]:.3e}, out "
                  f"{fwd_errs['out'][0]:.3e} of {fwd_errs['out'][1]:.3e} (tol {B3_RTOL:g}x) at valid frames, two "
                  f"calls bitwise equal {fwd_bitwise}"
                  + (f", back to back {times['fwd_dev']:.4f} ms a call" if "fwd_dev" in times else "") + "; B3 "
                  f"route (plain ActNorm + InvConvNear, B3's kernels) against the B6 route through autograd: out "
                  f"{routes['out_err'][0]:.3e} of {routes['out_err'][1]:.3e}, worst prefix/input gradient "
                  f"{routes['worst']} {routes['grads'][routes['worst']][0]:.3e} of scale "
                  f"{routes['grads'][routes['worst']][1]:.3e}; ms (median of 5): B6 route forward "
                  f"{routes['b6_fwd']:.4f} vs B3 route {routes['b3_fwd']:.4f}, forward + backward "
                  f"{routes['b6_fwd_bwd']:.4f} vs {routes['b3_fwd_bwd']:.4f}; forward bound {bnd['fwd'][0]:.4f} ms "
                  f"by {bnd['fwd'][1]} ({frames} valid frames: {flops / 1e9:.2f} GFLOP) [{card}]")
            for n, (err, scale) in fwd_errs.items():
                require(np.isfinite(err) and err <= B3_RTOL * scale, f"{tag}: {n} differs: {err}")
            require(fwd_bitwise, f"{tag}: two forward calls differ")
            require(routes["out_err"][0] <= B3_RTOL * routes["out_err"][1], f"{tag}: the B3 route's out differs")
            for n, (err, scale) in routes["grads"].items():
                require(np.isfinite(err) and err <= WGRAD_RTOL * scale, f"{tag}: route gradient {n} differs: {err}")
            print_grads(f"{tag} bwd", dx_err, dx_r[valid].abs().max().item(), leaf_report(leaves(gk), leaves(gr)),
                        bitwise, fwd_errs["out"][:1] + (B3_RTOL * fwd_errs["out"][1],), times, bnd["bwd"], card)
            out["max_abs_err"] = max(out["max_abs_err"], dx_err)
            out["fwd_err"] = max(out["fwd_err"], fwd_errs["xc"][0], fwd_errs["out"][0])
            if i == 0 and p > 0:  # the train step's shape
                out.update(ms=times["dev"], call_ms=times["bwd"], plain_ms=times["plain"], bound_ms=bnd["bwd"][0],
                           bound_by=bnd["bwd"][1], fwd_ms=times["fwd_dev"], fwd_call_ms=times["fwd"],
                           fwd_plain_ms=times["fwd_plain"],
                           fwd_bound_ms=bnd["fwd"][0], fwd_bound_by=bnd["fwd"][1], tf32_ms=tf32_bound_ms(*work["bwd"]),
                           fwd_tf32_ms=tf32_bound_ms(*work["fwd"]))
            del dx_k, gk, dx_k2, gk2, dx_r, gr
    out["fwd_err"] = max(out["fwd_err"], other_forward_shapes(device, card, flow_step=True))
    other_backward_shapes(device, card, flow_step=True)
    # the masks, as in phase 22: with conv biases of 10 every pre-dropout x_in is positive
    B, T = B3_SHAPES[0]
    rng = np.random.RandomState(780)
    lens = torch.from_numpy(ragged(rng, B, T // 2, T).astype(np.int32)).to(device)
    x = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device)
    g = torch.zeros(B, T, C, device=device)
    probe = wn_ops.WNWeights(ws=w.ws, bs=w.bs, win=tuple(t * 0.01 for t in w.win),
                             bin=tuple(torch.full_like(b, 10.0) for b in w.bin), wrs=w.wrs, brs=w.brs,
                             wend=w.wend, bend=w.bend, dilations=w.dilations)
    with torch.no_grad():
        plain = fs_ops.flow_step_backward(x, lens, aln, alb, mt, probe, g, g, seed, 0.0, return_buffers=True)[5]["xin"]
        require(bool((plain > 0).all()), "the B6 dropout probe's conv outputs are not all positive")
        bufs = [fs_ops.flow_step_backward(x, lens, aln, alb, mt, probe, g, g, s_, B3_DROP,
                                          return_buffers=True)[5]["xin"] > 0 for s_ in (seed, seed + 1)]
    for i in range(L):
        require(torch.equal(bufs[0][i], wn_ops.keep_mask(seed, lens, T, i, 2 * H, B3_DROP) > 0),
                f"B6 layer {i}: the kernel's masks differ from the B3 plain version's")
    n = bufs[0].numel()
    keep_rates_ok({"x_in": (int(bufs[0].sum()), n)}, B3_DROP)
    changed = (bufs[0] != bufs[1]).float().mean().item()
    print(f"[B6 dropout] p={B3_DROP} B={B} T={T}: the kernels' masks of all {L} layers equal the B3 plain "
          f"version's bit for bit; keep rate {bufs[0].float().mean().item():.6f} (expect {1 - B3_DROP:.6f}); "
          f"another seed changes {changed:.4f} [{card}]")
    require(changed > B3_DROP, f"B6: another seed changed only {changed} of the masks")
    return out


def flow_step_routes(act, inv, x, mask, lens, w, g_xc, g_out, seed, p) -> dict:
    """The B3 route of one flow step (the ActNorm and InvConvNear modules,
    then B3's kernels) and the B6 route through autograd: the B3 route's out
    against the B6 route's at valid frames, the gradients of x and of the
    prefix's parameters (WGRAD_RTOL of each leaf's scale), and both routes'
    forward and forward + backward times."""
    half = x.shape[2] // 2
    xg = x.clone().requires_grad_(True)
    wl = wn_ops.WNWeights.from_flat([t.clone().requires_grad_(True) for t in w.flat()], w.dilations)
    inputs = [xg, act.logs, act.bias, inv.weight, *wl.flat()]

    def b3():
        x1, _ = act(xg, mask, lens)
        xc, _ = inv(x1, mask, lens)
        return xc, wn_ops.wn_coupling(xc[..., :half], lens, wl, seed, p)

    def b6():
        return fs_ops.flow_step(xg, lens, act.logs.view(-1), act.bias.view(-1), inv.dense_matrix_t(), wl, seed, p)

    def grads(route):
        return torch.autograd.grad(route(), inputs, (g_xc, g_out))

    valid = mask[..., 0] > 0
    with torch.no_grad():
        o3, o6 = b3()[1], b6()[1]
    names = ["x", "actnorm.logs", "actnorm.bias", "invconv.weight"]
    g3 = dict(zip(names, grads(b3)))
    g6 = dict(zip(names, grads(b6)))
    g3["x"], g6["x"] = g3["x"][valid], g6["x"][valid]
    report = leaf_report(g6, g3)
    with torch.no_grad():
        b3_fwd, b6_fwd = (cuda_ms(r, reps=5, warmup=1) for r in (b3, b6))
    return {"out_err": ((o6 - o3)[valid].abs().max().item(), o3[valid].abs().max().item()), "grads": report,
            "worst": max(report, key=lambda n: report[n][0] / report[n][1]), "b3_fwd": b3_fwd, "b6_fwd": b6_fwd,
            "b3_fwd_bwd": cuda_ms(lambda: grads(b3), reps=5, warmup=1),
            "b6_fwd_bwd": cuda_ms(lambda: grads(b6), reps=5, warmup=1)}


def band_keys(lens: torch.Tensor, T: int, window: int) -> torch.Tensor:
    """[B, T, 2w+1] bool: row t's band key t + o - w is a valid key of a valid row."""
    t = torch.arange(T, device=lens.device)
    c = t[:, None] + torch.arange(-window, window + 1, device=lens.device)[None, :]
    ln = lens.to(torch.int64)[:, None, None]
    return (t[None, :, None] < ln) & (c[None] >= 0) & (c[None] < ln)


def phase_enc_layer_bwd(model: GlowTTS, device, card: str) -> dict:
    """B5's backward kernels against the plain backward at the kernel's own
    relu decisions, at p=0 and the encoder's p, with the four dropout sites'
    masks read back from the kernels' buffers."""
    w = model.encoder.layer_weights(0)
    C, H, Fc = w.wq.shape[0], w.n_heads, w.w1.shape[0]
    seed = torch.tensor([5151], dtype=torch.int64, device=device)
    out = {"max_abs_err": 0.0}
    for i, (B, T) in enumerate(B5_SHAPES):
        rng = np.random.RandomState(820 + i)
        lens_np = ragged(rng, B, max(1, T // 2), T).astype(np.int32)
        lens = torch.from_numpy(lens_np).to(device)
        valid = torch.arange(T, device=device)[None, :] < lens[:, None]
        x = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device)
        g = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device)
        for p in (0.0, B5_DROP):
            args = (x, lens, w, g, seed, p)
            with torch.no_grad():
                dx_k, gw_k, bufs = enc_ops.enc_layer_backward(*args, return_buffers=True)
                dx_k2, gw_k2 = enc_ops.enc_layer_backward(*args)
                plain = enc_ops._forward(x, lens, w, seed, p)
                gate = bufs["hid"] > 0  # the kernel's relu decisions where it kept the row
                kept_mid = (enc_ops.dropout_keep(seed, lens, T, Fc, enc_ops.SITE_FFN_MID, p) > 0) if p else True
                flip = ((plain["c1"] > 0) != gate) & kept_mid & valid[..., None]
                flips = (int(flip.sum()), plain["c1"].abs()[flip].max().item() if bool(flip.any()) else 0.0,
                         plain["c1"].abs().max().item())
                dx_r, gw_r = enc_ops.enc_layer_backward_reference(*args, relu_gate=gate.float())
                fwd_k = enc_ops.enc_layer(x, lens, w, seed, p)
                fwd = ((fwd_k - plain["out"])[valid].abs().max().item(),
                       B5_RTOL * plain["out"][valid].abs().max().item())
                torch.cuda.synchronize()
                bitwise = torch.equal(dx_k, dx_k2) and all(torch.equal(gw_k[n], gw_k2[n]) for n in gw_k)
                times = {"bwd": cuda_ms(lambda: enc_ops.enc_layer_backward(*args), reps=5, warmup=1),
                         "plain": cuda_ms(lambda: enc_ops.enc_layer_backward_reference(*args), reps=5, warmup=1),
                         "fwd": cuda_ms(lambda: enc_ops.enc_layer(x, lens, w, seed, p), reps=5, warmup=1),
                         "fwd_plain": cuda_ms(lambda: enc_ops.enc_layer_reference(x, lens, w, seed, p), reps=5,
                                              warmup=1)}
                if i == 0 and p > 0:  # the train step's shape
                    times["dev"] = device_ms(lambda: enc_ops.enc_layer_backward(*args))
            tokens = int(lens_np.sum())
            params = sum(t.numel() for t in w.tensors().values())
            work = (3 * enc_flops(lens_np, w), 4 * (3 * tokens * C + 2 * params))
            bnd = bound(*work)
            dx_err = (dx_k - dx_r)[valid].abs().max().item()
            print(f"[B5 bwd] p={p} B={B} T={T}: FFN relu decisions flipped against the plain forward {flips[0]} "
                  f"(largest |c1| {flips[1]:.1e} of max {flips[2]:.1e}) [{card}]")
            require(flips[1] <= FLIP_RTOL * flips[2], f"B5: a relu decision flipped at {flips[1]} of {flips[2]}")
            print_grads(f"[B5 bwd] p={p} B={B} T={T}", dx_err, dx_r[valid].abs().max().item(),
                        leaf_report(gw_k, gw_r), bitwise, fwd, times, bnd, card)
            out["max_abs_err"] = max(out["max_abs_err"], dx_err)
            if i == 0 and p > 0:  # the train step's shape
                out.update(ms=times["dev"], call_ms=times["bwd"], plain_ms=times["plain"], bound_ms=bnd[0],
                           bound_by=bnd[1], fwd_ms=times["fwd"], fwd_plain_ms=times["fwd_plain"],
                           tf32_ms=tf32_bound_ms(*work))
            if p > 0:
                enc_masks(x, lens, w, g, seed, bufs, plain, valid, card)
            del dx_k, gw_k, bufs, dx_k2, gw_k2, dx_r, gw_r, plain
    return out


def enc_masks(x, lens, w: enc_ops.EncLayerWeights, g, seed, bufs: dict, plain: dict, valid, card: str,
              flip_rtol: float = FLIP_RTOL) -> None:
    """B5's four dropout sites read back from its backward buffers (fp32, or
    the bf16 mode's: enc_ops.backward_buffer_shapes): the band's dropped
    probabilities (every pair at T <= w + 1), conv_o's output cotangent
    after dropout, the FFN's hidden rows (where |c1| is clear of 0 by
    flip_rtol of its max) and its output cotangent, each against the plain
    version's masks."""
    B, T, C = x.shape
    H, R, Fc, p = w.n_heads, 2 * w.window + 1, w.w1.shape[0], B5_DROP
    site = lambda s, width: enc_ops.dropout_keep(seed, lens, T, width, s, p) > 0  # noqa: E731
    band_ok = band_keys(lens, T, w.window)[:, :, None, :].expand(B, T, H, R)
    want_p = enc_ops.band_extract(enc_ops.attention_keep(seed, lens, H, T, p), w.window).permute(0, 2, 1, 3) > 0
    c1 = plain["c1"]
    clear = (c1.abs() > flip_rtol * c1.abs().max()) & valid[..., None]  # relu decisions clear of a tie
    rows = valid[..., None].expand(B, T, C)
    checks = {
        "attention P (band)": (bufs["bandp"].reshape(B, T, H, R) != 0, want_p, band_ok),
        "conv_o output": (bufs["dy"] != 0, site(enc_ops.SITE_ATTN_Y, C), rows),
        "FFN hidden (c1 > 0)": (bufs["hid"] != 0, site(enc_ops.SITE_FFN_MID, Fc), clear & (c1 > 0)),
        "FFN output": (bufs["dc2"] != 0, site(enc_ops.SITE_FFN_Y, C), rows),
    }
    require(not bool((bufs["hid"] != 0)[clear & (c1 < 0)].any()), "B5: the kernel's relu kept a negative row")
    rates = {}
    for name, (got, want, where) in checks.items():
        require(torch.equal(got[where], want[where]), f"B5 {name}: the kernel's masks differ from the plain version's")
        rates[name] = (int(got[where].sum()), int(where.sum()))
    other = enc_ops.enc_layer_backward(x, lens, w, g, seed + 1, p, return_buffers=True)[2]
    changed = ((bufs["dy"] != 0) != (other["dy"] != 0))[rows].float().mean().item()
    print(f"[B5 dropout{' bf16' if x.dtype == torch.bfloat16 else ''}] p={p} B={B} T={T}: the kernels' masks equal the plain version's bit for bit; keep rates "
          + ", ".join(f"{k} {kept / n:.5f} of {n} (5 sigma {5 * np.sqrt(p * (1 - p) / n):.1e})"
                      for k, (kept, n) in rates.items())
          + f" (expect {1 - p:.5f}); another seed changes {changed:.4f} of conv_o's [{card}]")
    keep_rates_ok(rates, p)
    require(changed > p, f"B5: another seed changed only {changed} of the masks")


def glow_train_counts() -> tuple:
    return (enc_ops.enc_layer.launches, enc_ops.enc_layer_backward.launches, wn_ops.wn_coupling.launches,
            wn_ops.wn_coupling_backward.launches, mas_ops.maximum_path_auto.launches, fs_ops.flow_step.launches,
            fs_ops.flow_step_backward.launches)


def zero_glow_train_counts() -> None:
    zero_glow_counts()
    enc_ops.enc_layer_backward.launches = wn_ops.wn_coupling_backward.launches = 0
    fs_ops.flow_step_backward.launches = 0


def actnorm_outputs(model: GlowTTS, batch: dict, seed: int) -> list:
    """(output, mask) of every ActNorm in a train-mode forward whose dropout
    generator starts at ``seed``, on the B3 route (the B6 route runs no
    ActNorm module; both draw the same masks)."""
    seen = []
    hooks = [f.register_forward_hook(lambda m, inp, out: seen.append((out[0], inp[1])))
             for f in model.decoder.flows if isinstance(f, glow_flows.ActNorm)]
    route = model.decoder.fused_flow_step
    model.decoder.fused_flow_step = False
    try:
        with torch.no_grad():
            model.supervised_step(batch, train=True, generators={
                "device_dropout": torch.Generator(device=batch["audio"].device).manual_seed(seed)})
    finally:
        model.decoder.fused_flow_step = route
        for hook in hooks:
            hook.remove()
    require(len(seen) == len(model.decoder.flows) // 3, f"{len(seen)} ActNorm outputs seen")
    return seen


def phase_glow_train(device, card: str, flow_step: bool = False) -> dict:
    """The Glow-TTS training path at batch 8 x 768 frames: ddi_init, then
    GLOW_TRAIN_STEPS train steps with dropout, AdamW + Noam and the EMA, on
    the B3 route or (``flow_step``) the B6 route."""
    tag = "[glow train B6]" if flow_step else "[glow train]"
    expect = (6, 6, 0, 0, 1, 12, 12) if flow_step else (6, 6, 12, 12, 1, 0, 0)
    held = torch.cuda.memory_allocated()  # what earlier phases still hold: not this route's
    model = build_glow(device, GLOW_SEED + 1, flow_step)
    batch = glow_val_batch(GLOW_BATCH, device, seed=31)
    ddi_seed = 17
    model.ddi_init(batch, {"device_dropout": torch.Generator(device=device).manual_seed(ddi_seed)})
    # the same dropout draws again: every ActNorm sees the input its init saw
    worst_mean = worst_var = 0.0
    for z, mask in actnorm_outputs(model, batch, ddi_seed):
        n = mask.sum()
        mean = (z * mask).sum(dim=(0, 1)) / n
        var = (z * z * mask).sum(dim=(0, 1)) / n - mean * mean
        worst_mean = max(worst_mean, mean.abs().max().item())
        worst_var = max(worst_var, (var - 1).abs().max().item())
    opt, schedule = build_optimizer(model.parameters(), configs.GLOW_TTS_TPU_OPTIMIZER,
                                    configs.GLOW_TTS_TPU_SCHEDULER, configs.GLOW_TTS_TPU)
    state = TrainState.create(model, opt, use_ema=True)
    train_step = make_train_step(schedule, default_mu(GLOW_BATCH, 1), use_ema=True)
    ema0 = {k: v.clone() for k, v in state.ema_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_glow_train_counts()
    times, per_step, losses = [], [], []
    for _ in range(GLOW_TRAIN_STEPS):
        before = glow_train_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scalars = train_step(state, batch, TRAIN_SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(a - b for a, b in zip(glow_train_counts(), before)))
        raise_if_not_finite(scalars, state.step)
        losses.append({k: round(float(v), 6) for k, v in scalars.items() if k != "finite"})
    totals = glow_train_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    bad = [k for k, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.abs().sum() > 0)]
    ema_moved = sum(not torch.equal(e, ema0[k]) for k, e in state.ema_params.items())
    median = statistics.median(times[GLOW_STEADY_FROM - 1:])
    frames = GLOW_BATCH * GLOW_FRAMES
    valid = int((batch["audio_len"] // HOP).sum())
    prefix_params = [k for k, _ in model.named_parameters() if k.endswith((".logs", ".bias", ".weight"))
                     and k.startswith("decoder.flows.") and int(k.split(".")[2]) % 3 < 2]
    print(f"{tag} ddi_init on B={GLOW_BATCH} x {GLOW_FRAMES} frames: each ActNorm's output at valid frames "
          f"has per-channel mean within {worst_mean:.2e} of 0 and variance within {worst_var:.2e} of 1 [{card}]")
    print(f"{tag} B={GLOW_BATCH} x {GLOW_FRAMES} frames ({valid} valid) and {GLOW_TOKENS} tokens, ragged, "
          f"mel on the card; dropout (encoder {model.encoder.p_dropout}, decoder "
          f"{model.decoder.flows[2].p_dropout}, prenet {model.encoder.pre.P_DROPOUT}), AdamW + Noam (lr at step 1 "
          f"{schedule(0):.3e}) + parameter EMA: losses per step {losses}")
    print(f"{tag} launches per step (B5 fwd, B5 bwd, B3 fwd, B3 bwd, B4, B6 fwd, B6 bwd) {per_step}; every one "
          f"of {len(list(model.parameters()))} parameters ({len(prefix_params)} ActNorm and InvConvNear) has a "
          f"finite nonzero gradient: {not bad}; {ema_moved}/{len(ema0)} EMA parameters moved")
    print(f"{tag} step ms {', '.join(f'{t:.3f}' for t in times)}; median of steps {GLOW_STEADY_FROM}-"
          f"{GLOW_TRAIN_STEPS} {median:.3f} ms = {frames / (median / 1e3):.1f} mel-frames/s ({GLOW_BATCH} x "
          f"{GLOW_FRAMES} per step; {valid / (median / 1e3):.1f} valid frames/s); max_memory_allocated "
          f"{peak:.3f} GiB above the {held / 2 ** 30:.3f} GiB held before the phase [{card}]")
    require(worst_mean <= 1e-3 and worst_var <= 1e-3, f"ddi_init: mean {worst_mean}, variance {worst_var}")
    require(all(c == expect for c in per_step), f"train step launches {per_step} != {expect}")
    require(len(prefix_params) == 3 * len(model.decoder.flows) // 3, f"prefix parameters {prefix_params}")
    require(not bad, f"parameters without a finite nonzero gradient: {bad[:8]}")
    require(ema_moved == len(ema0), f"only {ema_moved}/{len(ema0)} EMA parameters moved")
    return {"launches": totals, "step_ms": median, "frames_per_s": frames / (median / 1e3), "peak": peak,
            "loss1": losses[0]["loss"], "model": model,
            "step": lambda: raise_if_not_finite(train_step(state, batch, TRAIN_SEED), state.step)}


def steps_in_turns(steps: dict, rounds: int) -> dict:
    """name -> wall times (ms) of ``rounds`` calls of each step function,
    taken in turns: a, b, then b, a, and so on."""
    names = list(steps)
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[n]()
            torch.cuda.synchronize()
            times[n].append((time.perf_counter() - t0) * 1e3)
    return times


def set_dropout(model: GlowTTS, p: float) -> None:
    """Every dropout site of the model at p, the prenet's fixed rate included."""
    model.encoder.p_dropout = p
    model.encoder.pre.P_DROPOUT = p
    for flow in model.decoder.flows[2::3]:
        flow.p_dropout = p


def phase_glow_train_vs_cpu(device, card: str, flow_step: bool = False) -> None:
    """One train step (p=0) on the card against the CPU on 2 sequences, each
    held against the same step in fp64 on the CPU, as phase 10 does: the
    card's gradients within GLOW_GRAD_MEDIAN_MULTIPLE (median parameter) and
    GLOW_GRAD_WORST_MULTIPLE (worst) times the CPU fp32 step's distance from
    fp64 (phase 10's additive allowance would admit some 200x here). On the B3
    route or (``flow_step``) the B6 route."""
    tag = "[glow train vs cpu B6]" if flow_step else "[glow train vs cpu]"
    n = GLOW_VS_CPU
    sub = {k: v[:n] for k, v in glow_val_batch(GLOW_BATCH, device, seed=32).items()}
    models = {"cuda": build_glow(device, GLOW_SEED + 2, flow_step)}
    set_dropout(models["cuda"], 0.0)
    with torch.no_grad():
        spect, spect_len = spect_from_audio(models["cuda"], sub)
    models["cpu"] = copy.deepcopy(models["cuda"]).to("cpu")
    models["cpu64"] = copy.deepcopy(models["cpu"]).double()
    out = {}
    for name, model in models.items():
        dev = next(model.parameters()).device
        batch = {"token": sub["token"].to(dev), "token_len": sub["token_len"].to(dev),
                 "spect": spect.to(dev, torch.float64 if name == "cpu64" else torch.float32),
                 "spect_len": spect_len.to(dev)}
        opt, schedule = build_optimizer(model.parameters(), configs.GLOW_TTS_TPU_OPTIMIZER,
                                        configs.GLOW_TTS_TPU_SCHEDULER, configs.GLOW_TTS_TPU)
        state = TrainState.create(model, opt, use_ema=True)
        scalars = make_train_step(schedule, default_mu(n, 1), use_ema=True)(state, batch, TRAIN_SEED)
        out[name] = ({k: float(v) for k, v in scalars.items()},
                     {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()})
    ref = out["cpu64"][1]
    floor = 1e-4 * torch.sqrt(sum((r * r).sum() for r in ref.values())).item()

    def rel_l2(ours: dict) -> dict:  # floored: the key biases' true gradients are zero
        return {k: ((ours[k] - r).norm() / max(r.norm().item(), floor)).item() for k, r in ref.items()}

    errs = {name: rel_l2(out[name][1]) for name in ("cuda", "cpu")}
    stats = {name: (statistics.median(e.values()), max(e.values())) for name, e in errs.items()}
    print(f"{tag} {n} sequences, p=0: losses card {out['cuda'][0]}; cpu {out['cpu'][0]}; cpu fp64 "
          f"{out['cpu64'][0]}")
    print(f"{tag} gradients against the fp64 step, relative L2 over {len(ref)} parameters "
          f"(denominator floored at 1e-4 of the global norm): card median {stats['cuda'][0]:.3e} worst "
          f"{stats['cuda'][1]:.3e}; cpu fp32 median {stats['cpu'][0]:.3e} worst {stats['cpu'][1]:.3e} (card within "
          f"{GLOW_GRAD_MEDIAN_MULTIPLE}x and {GLOW_GRAD_WORST_MULTIPLE}x: {stats['cuda'][0] / stats['cpu'][0]:.2f}x "
          f"and {stats['cuda'][1] / stats['cpu'][1]:.2f}x) [{card}]")
    for key in ("loss", "loss_mle", "loss_length"):
        g_, c_ = out["cuda"][0][key], out["cpu"][0][key]
        rel = abs(g_ - c_) / max(abs(c_), 1e-12)
        require(rel <= STEP_LOSS_RTOL, f"glow train step {key} differs: {rel}")
    require(stats["cuda"][0] <= GLOW_GRAD_MEDIAN_MULTIPLE * stats["cpu"][0],
            f"glow train step grads: card median {stats['cuda'][0]} vs cpu {stats['cpu'][0]}")
    require(stats["cuda"][1] <= GLOW_GRAD_WORST_MULTIPLE * stats["cpu"][1],
            f"glow train step grads: card worst {stats['cuda'][1]} vs cpu {stats['cpu'][1]}")


# ---------------------------------------------------------------------------
# VQ-TTS
# ---------------------------------------------------------------------------
def phase_vqtts_blocks(device, card: str) -> dict:
    """Phase 29: B1 at VQ-TTS's eight depth-3 block shapes, batch 4: the
    forward at p=0 (phase 3's checks and times), at p=0.1 against the plain
    version with two calls bitwise equal, the kernels' masks read back, then
    the backward's tile passes and reduction at p=0 and 0.1 (phase 7's)."""
    fwd = phase_kernel(device, card, VQTTS_BLOCK_TS, VQTTS_BATCH, depth=VQTTS_DEPTH, tag="[vqtts B1]")
    w = block_weights(device, seed=1, depth=VQTTS_DEPTH)
    keep = 1.0 - gh.keep_threshold(P_DROP) / 65536.0
    worst = 0.0
    with torch.no_grad():
        for i, T in enumerate(VQTTS_BLOCK_TS):
            x, lens, valid, _ = block_inputs(T, VQTTS_BATCH, 500 + i, device)
            seed = 900 + i
            ref = gh.gated_hifi_reference(x, lens, w, 1.0, P_DROP, seed)
            out = gh.gated_hifi(x, lens, w, 1.0, P_DROP, seed)
            again = gh.gated_hifi(x, lens, w, 1.0, P_DROP, seed)
            torch.cuda.synchronize()
            err = (out - ref)[valid].abs().max().item()
            scale = ref[valid].abs().max().item()
            bitwise = torch.equal(out, again)
            (n0, n1, n01), n, same, changed = read_back_masks(device, T, VQTTS_BATCH, VQTTS_DEPTH, seed)
            rates = {"site 0": (n0 / n, keep), "site 1": (n1 / n, keep), "both": (n01 / n, keep * keep)}
            print(f"[vqtts B1] p={P_DROP} B={VQTTS_BATCH} T={T} depth {VQTTS_DEPTH}: forward max_abs_err {err:.3e} "
                  f"(tol {KERNEL_RTOL * scale:.3e}), two calls bitwise equal {bitwise}; the backward's masks equal "
                  f"the plain version's at both sites of all {VQTTS_DEPTH} branches, keep rates "
                  + ", ".join(f"{k} {r:.5f} (expect {q:.5f})" for k, (r, q) in rates.items())
                  + f"; same seed same masks {same}; another seed changes {changed:.4f} [{card}]")
            require(np.isfinite(err) and err <= KERNEL_RTOL * scale, f"VQ-TTS block T={T}: p=0.1 forward {err}")
            require(bitwise, f"VQ-TTS block T={T}: two p=0.1 forward calls differ")
            for k, (r, q) in rates.items():
                require(abs(r - q) <= 5 * np.sqrt(q * (1 - q) / n), f"VQ-TTS block T={T}: keep rate {k} {r} vs {q}")
            require(same and changed > 0.1, f"VQ-TTS block T={T}: masks same {same}, changed {changed}")
            worst = max(worst, err)
    bwd = phase_backward(device, card, VQTTS_BLOCK_TS, VQTTS_BATCH, depth=VQTTS_DEPTH, tag="[vqtts B1 backward]")
    return {"fwd": fwd, "fwd_drop_err": worst, "bwd": bwd}


def vqtts_config(fused_encoder: bool = False, **overrides) -> dict:
    """VQTTS_TPU (its encoder route, fused_encoder: false), or with
    ``fused_encoder`` B5's, and ``overrides`` of the model section."""
    model = dict(copy.deepcopy(configs.VQTTS_TPU), fused_encoder=fused_encoder, **overrides)
    return {"model": model, "dataset": copy.deepcopy(configs.LJSPEECH_TPU)}


def build_vqtts(device, seed: int, fused_encoder: bool = False, **overrides) -> VQTTS:
    """VQTTS at VQTTS_TPU width with init_model_variables' initializers (the
    text encoder's Glow-TTS ones), then the leaves those leave at zero (the
    codec's gates and branch 1x1s, the quant decoder's 1x1s, the prenet's
    proj) drawn lecun-normal from the seed. The codebook stays uninitialized:
    its lazy init runs in the first train step."""
    model = harness.get_model(vqtts_config(fused_encoder, **overrides), device=device)
    harness.init_model_variables(model, None, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for module in model.modules():
            if getattr(module, "zero_init", False):
                w = module.weight
                w.copy_(torch.randn(w.shape, generator=gen) / np.sqrt(w[0].numel()))
    return model


def vqtts_batch(batch: int, samples: int, device, seed: int) -> dict:
    """Seeded audio (uniform in +-0.5, as the JAX package's bench) and token
    ids, ragged: audio lengths from half to all of ``samples``, up to
    VQTTS_TOKENS tokens and never more tokens than code frames."""
    rng = np.random.RandomState(seed)
    lens = ragged(rng, batch, samples // 2, samples)
    tokens = np.minimum(ragged(rng, batch, VQTTS_TOKENS // 2, VQTTS_TOKENS), lens // 256)
    audio = rng.uniform(-0.5, 0.5, (batch, samples)) * (np.arange(samples)[None, :] < lens[:, None])
    ids = rng.randint(0, configs.VQTTS_TPU["encoder"]["n_vocab"] + 1, (batch, VQTTS_TOKENS))
    ids *= np.arange(VQTTS_TOKENS)[None, :] < tokens[:, None]
    return {"token": torch.from_numpy(ids).to(device), "token_len": torch.from_numpy(tokens).to(device),
            "audio": torch.from_numpy(audio.astype(np.float32)).to(device),
            "audio_len": torch.from_numpy(lens).to(device)}


def vqtts_counts() -> tuple:
    """(B1 fwd, B1 bwd, B1 red, B4, B5 fwd, B5 bwd) launches so far."""
    return (gh.gated_hifi.launches, gh.backward_buffers.launches, gh.weight_grad_reduce.launches,
            mas_ops.maximum_path_auto.launches, enc_ops.enc_layer.launches, enc_ops.enc_layer_backward.launches)


def zero_vqtts_counts() -> None:
    gh.gated_hifi.launches = gh.backward_buffers.launches = gh.weight_grad_reduce.launches = 0
    mas_ops.maximum_path_auto.launches = enc_ops.enc_layer.launches = enc_ops.enc_layer_backward.launches = 0


def phase_vqtts_train(device, card: str, fused_encoder: bool = False) -> dict:
    """Phase 30: VQTTS_STEPS train steps at batch 4 x 2 s, ragged, every
    dropout site on, Adam and the codebook and parameter EMAs, the codebook's
    lazy init inside step 1; on the config's encoder route or B5's."""
    tag = "[vqtts train B5]" if fused_encoder else "[vqtts train]"
    expect = (16, 16, 16, 1, 6, 6) if fused_encoder else (16, 16, 16, 1, 0, 0)
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    model = build_vqtts(device, VQTTS_SEED, fused_encoder)
    batch = vqtts_batch(VQTTS_BATCH, VQTTS_SAMPLES, device, seed=41)
    bn = model.quant_bottleneck
    require(not bool(bn.initialized), "the VQ-TTS codebook starts initialized")
    opt, schedule = build_optimizer(model.parameters(), configs.VQTTS_TPU_OPTIMIZER)
    state = TrainState.create(model, opt, use_ema=True)
    train_step = make_train_step(schedule, default_mu(VQTTS_BATCH, 1), use_ema=True)
    ema0 = {k: v.clone() for k, v in state.ema_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_vqtts_counts()
    times, per_step, losses, syncs = [], [], [], []
    for _ in range(VQTTS_STEPS):
        before = vqtts_counts()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")  # each op that waits for the card warns once
            t0 = time.perf_counter()
            scalars = train_step(state, batch, TRAIN_SEED)
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        syncs.append([f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught
                      if "synchronizing" in str(w.message)])
        per_step.append(tuple(a - b for a, b in zip(vqtts_counts(), before)))
        if len(times) == 1:
            initialized = bool(bn.initialized) and bn.init_seen and bool(bn.k.abs().sum() > 0)
        raise_if_not_finite(scalars, state.step)
        losses.append({k: round(float(v), 6) for k, v in scalars.items() if k != "finite"})
    totals = vqtts_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    grads = {k: p.grad for k, p in model.named_parameters()}
    not_finite = [k for k, g in grads.items() if g is None or not bool(torch.isfinite(g).all())]
    zero = [k for k, g in grads.items() if g is not None and not bool(g.abs().sum() > 0)]
    ema_moved = sum(not torch.equal(e, ema0[k]) for k, e in state.ema_params.items())
    median = statistics.median(times[VQTTS_STEADY_FROM - 1:])
    seconds = VQTTS_BATCH * VQTTS_SAMPLES / configs.LJSPEECH_TPU["sample_rate"]
    valid = float(batch["audio_len"].sum()) / configs.LJSPEECH_TPU["sample_rate"]
    print(f"{tag} B={VQTTS_BATCH} x {VQTTS_SAMPLES} samples ({seconds:.3f} s of audio, {valid:.3f} s valid) and "
          f"{VQTTS_TOKENS} tokens, ragged; dropout (encoder {model.text_encoder.p_dropout}, prenet "
          f"{model.text_encoder.pre.P_DROPOUT}, codec {model.audio_encoder.level_blocks[0].blocks[1].p_dropout}, "
          f"quant decoder {model.quant_decoder.model[0].model[0].p}), Adam + codebook EMA + parameter EMA; the "
          f"codebook's lazy init ran in step 1: {initialized}; losses per step {losses}")
    print(f"{tag} launches per step (B1 fwd, B1 bwd, B1 red, B4, B5 fwd, B5 bwd) {per_step}; ops that waited for "
          f"the card per step (torch.cuda sync debug mode) {[len(x) for x in syncs]}, in step 1 at {syncs[0]}; "
          f"every one of {len(grads)} parameters a finite "
          f"gradient: {not not_finite}, zero gradients {zero}; {ema_moved}/{len(ema0)} EMA parameters moved")
    print(f"{tag} step ms {', '.join(f'{t:.3f}' for t in times)}; median of steps {VQTTS_STEADY_FROM}-{VQTTS_STEPS} "
          f"{median:.3f} ms = {seconds / (median / 1e3):.2f} audio seconds/s ({valid / (median / 1e3):.2f} valid); "
          f"max_memory_allocated {peak:.3f} GiB above the {held / 2 ** 30:.3f} GiB held before the phase [{card}]")
    require(initialized, "the codebook's lazy init did not run in step 1")
    require(all(c == expect for c in per_step), f"VQ-TTS train step launches {per_step} != {expect}")
    require(not any(syncs[1:]), f"steps 2-{VQTTS_STEPS} wait for the card: {syncs[1:]}")
    require(not not_finite, f"parameters without a finite gradient: {not_finite[:8]}")
    # the key biases' true gradient is zero (the softmax is invariant to them): rounding may leave exact zeros
    require(all(k.endswith("conv_k.bias") for k in zero), f"zero gradients: {zero[:8]}")
    require(ema_moved == len(ema0), f"only {ema_moved}/{len(ema0)} EMA parameters moved")
    return {"launches": totals, "per_step": per_step[0], "step_ms": median, "audio_s_per_s": seconds / (median / 1e3),
            "peak": peak, "loss1": losses[0]["loss"], "state": state, "batch": batch,
            "step": lambda: raise_if_not_finite(train_step(state, batch, TRAIN_SEED), state.step)}


def phase_vqtts_val(state: TrainState, batch: dict, card: str) -> dict:
    """Phase 31: the val step on the EMA parameters (eval forward: the codec's
    decoder runs twice, once at the quantized encodings for the losses and
    once at the predicted codes for ``yh``)."""
    val_step = make_val_step(use_ema=True)
    val_step(state, batch)  # warm-up
    torch.cuda.synchronize()
    times, counts = [], []
    for _ in range(3):
        zero_vqtts_counts()
        t0 = time.perf_counter()
        loss, metrics = val_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(vqtts_counts())
    losses = {k: float(loss[k]) for k in VQTTS_LOSS_KEYS}
    yh, q_acc = loss["yh"], float(metrics["q_acc"])
    print(f"[vqtts val] B={VQTTS_BATCH} x {VQTTS_SAMPLES} samples, {VQTTS_TOKENS} tokens, ragged; EMA parameters: "
          f"losses {losses}; q_acc {q_acc:.6f}; yh {tuple(yh.shape)} finite {bool(torch.isfinite(yh).all())}; "
          f"launches (B1 fwd, B1 bwd, B1 red, B4, B5 fwd, B5 bwd) per step {counts}; step ms "
          f"{', '.join(f'{t:.3f}' for t in times)}, median {statistics.median(times):.3f} [{card}]")
    require(all(c == (24, 0, 0, 1, 0, 0) for c in counts), f"VQ-TTS val step launches {counts}")
    require(all(np.isfinite(v) for v in losses.values()), f"VQ-TTS val losses {losses}")
    require(tuple(yh.shape) == tuple(batch["audio"].shape) and bool(torch.isfinite(yh).all()), "VQ-TTS val yh")
    require(0.0 <= q_acc <= 1.0, f"q_acc {q_acc}")
    return {"launches": counts[0], "step_ms": statistics.median(times), "q_acc": q_acc}


def vqtts_step_capture(model: VQTTS, batch: dict) -> tuple:
    """One train step (seed TRAIN_SEED) with the MAS inputs and path and the
    codes captured: (scalars, grads, value, mask, path, codes)."""
    seen = {}

    def mas(value, mask):
        seen["value"], seen["mask"] = value.detach().clone(), mask.detach().clone()
        seen["path"] = mas_ops.maximum_path_auto(value, mask)
        return seen["path"]

    hook = model.quant_bottleneck.register_forward_hook(lambda m, inp, out: seen.update(codes=out[0].clone()))
    route = vqtts_model.maximum_path_auto
    vqtts_model.maximum_path_auto = mas
    try:
        opt, schedule = build_optimizer(model.parameters(), configs.VQTTS_TPU_OPTIMIZER)
        state = TrainState.create(model, opt, use_ema=True)
        scalars = make_train_step(schedule, default_mu(len(batch["token"]), 1), use_ema=True)(
            state, batch, TRAIN_SEED)
    finally:
        vqtts_model.maximum_path_auto = route
        hook.remove()
    grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()}
    return ({k: float(v) for k, v in scalars.items()}, grads, *(seen[k].cpu() for k in ("value", "mask", "path",
                                                                                          "codes")))


def phase_vqtts_train_vs_cpu(device, card: str, fused_encoder: bool = False) -> dict:
    """Phase 32: one train step (p=0 at every site, revival off) on the card
    against the CPU on 2 sequences, each against the same step in fp64 on the
    CPU, on the config's encoder route or B5's (the card's step launches B5
    6 times each way there, and 0 on the config's; the CPU steps run B5's
    plain version). The codebook is drawn once on the card from other audio (so all three
    steps start from the same one and no frame meets its own encoding). First
    the MAS path and the codes: the card's against the CPU's (frames that
    differ), and B4 on the card's own value table against the plain MAS bit
    for bit; then the losses within STEP_LOSS_RTOL and the card's gradients
    within VQTTS_GRAD_{MEDIAN,WORST}_MULTIPLE times the CPU fp32 step's
    distance from fp64."""
    tag = "[vqtts train vs cpu B5]" if fused_encoder else "[vqtts train vs cpu]"
    n = VQTTS_VS_CPU
    enc = dict(configs.VQTTS_TPU["encoder"], p_dropout=0.0)
    model = build_vqtts(device, VQTTS_SEED + 2, fused_encoder, p_dropout=0.0, revival_threshold=0.0, encoder=enc)
    model.text_encoder.pre.P_DROPOUT = 0.0
    for m in model.quant_decoder.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    sub = vqtts_batch(n, VQTTS_SAMPLES, device, seed=43)
    other = vqtts_batch(n, VQTTS_SAMPLES, device, seed=44)
    with torch.no_grad():
        mask = (torch.arange(VQTTS_SAMPLES, device=device)[None, :] < other["audio_len"][:, None]).float()
        h, h_mask = model.audio_encoder(other["audio"][..., None], mask[..., None])
        model.quant_bottleneck._maybe_init(h.reshape(-1, h.shape[-1]), h_mask.reshape(-1),
                                           torch.Generator(device=device).manual_seed(VQTTS_SEED))
    models = {"cuda": model, "cpu": copy.deepcopy(model).to("cpu")}
    models["cpu64"] = copy.deepcopy(models["cpu"]).double()
    out = {}
    for name, m in models.items():
        dev = next(m.parameters()).device
        batch = {k: v.to(dev) for k, v in sub.items()}
        if name == "cpu64":
            batch["audio"] = batch["audio"].double()
        before = vqtts_counts()
        out[name] = vqtts_step_capture(m, batch)
        if name == "cuda":
            b5 = tuple(a - b for a, b in zip(vqtts_counts(), before))[4:]
    (_, _, value, vmask, path, codes), (_, _, _, _, cpu_path, cpu_codes) = out["cuda"], out["cpu"]
    path64, codes64 = out["cpu64"][4], out["cpu64"][5]
    frames = vmask[:, 0, :] > 0                                     # valid code frames

    def frames_apart(a, b):  # frames whose token differs, then codes that differ, at valid frames
        return int(((a.argmax(dim=1) != b.argmax(dim=1)) & frames).sum())

    b4_bitwise = torch.equal(mas_ops.maximum_path(value, vmask), path)
    path_diff, code_diff = frames_apart(path, cpu_path), int(((codes != cpu_codes) & frames).sum())
    path64_diff, code64_diff = frames_apart(path64.float(), cpu_path), int(((codes64 != cpu_codes) & frames).sum())
    ref = out["cpu64"][1]
    floor = 1e-4 * torch.sqrt(sum((r * r).sum() for r in ref.values())).item()

    def rel_l2(ours: dict) -> dict:  # floored: the key biases' true gradients are zero
        return {k: ((ours[k] - r).norm() / max(r.norm().item(), floor)).item() for k, r in ref.items()}

    errs = {name: rel_l2(out[name][1]) for name in ("cuda", "cpu")}
    stats = {name: (statistics.median(e.values()), max(e.values())) for name, e in errs.items()}
    worst = sorted(errs["cuda"], key=errs["cuda"].get)[-3:]
    print(f"{tag} {n} sequences, p=0, revival off, B5 launches on the card (fwd, bwd) {b5}: "
          f"{int(frames.sum())} valid code frames; the MAS "
          f"path's token differs from the CPU's at {path_diff} frames (fp64's from the CPU fp32's at {path64_diff}), "
          f"the codes at {code_diff} (fp64's {code64_diff}); B4 on the card's value table equals the plain MAS bit "
          f"for bit: {b4_bitwise} [{card}]")
    print(f"{tag} losses card {out['cuda'][0]}; cpu {out['cpu'][0]}; cpu fp64 {out['cpu64'][0]}")
    print(f"{tag} gradients against the fp64 step, relative L2 over {len(ref)} parameters "
          f"(denominator floored at 1e-4 of the global norm): card median {stats['cuda'][0]:.3e} worst "
          f"{stats['cuda'][1]:.3e} ({', '.join(f'{k} {errs['cuda'][k]:.2e}' for k in worst)}); "
          f"cpu fp32 median {stats['cpu'][0]:.3e} worst {stats['cpu'][1]:.3e} (card within "
          f"{VQTTS_GRAD_MEDIAN_MULTIPLE}x and {VQTTS_GRAD_WORST_MULTIPLE}x: {stats['cuda'][0] / stats['cpu'][0]:.2f}x "
          f"and {stats['cuda'][1] / stats['cpu'][1]:.2f}x) [{card}]")
    require(b5 == ((6, 6) if fused_encoder else (0, 0)), f"{tag} B5 launches on the card's step: {b5}")
    require(b4_bitwise, "B4 on the card's value table differs from the plain MAS")
    require(path_diff == 0 and code_diff == 0,
            f"the card's MAS path ({path_diff} frames) or codes ({code_diff} frames) differ from the CPU's")
    for key in VQTTS_LOSS_KEYS:
        g_, c_ = out["cuda"][0][key], out["cpu"][0][key]
        rel = abs(g_ - c_) / max(abs(c_), 1e-12)
        require(rel <= STEP_LOSS_RTOL, f"VQ-TTS train step {key} differs: {rel}")
    require(stats["cuda"][0] <= VQTTS_GRAD_MEDIAN_MULTIPLE * stats["cpu"][0],
            f"VQ-TTS train step grads: card median {stats['cuda'][0]} vs cpu {stats['cpu'][0]}")
    require(stats["cuda"][1] <= VQTTS_GRAD_WORST_MULTIPLE * stats["cpu"][1],
            f"VQ-TTS train step grads: card worst {stats['cuda'][1]} vs cpu {stats['cpu'][1]}")
    return {"median_ratio": stats["cuda"][0] / stats["cpu"][0], "worst_ratio": stats["cuda"][1] / stats["cpu"][1]}


# ---------------------------------------------------------------------------
# bf16: B1's bf16 mode and the VQ-VAE's mixed-precision train step
# ---------------------------------------------------------------------------
def bf16_bound(flops: float, nbytes: float) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of the operations over
    the bf16 tensor-core peak and the bytes over the memory rate."""
    ops_ms, bytes_ms = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bf16_agreement(ours: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(share of elements within one bf16 ulp of the reference's own
    magnitude, max abs error / max|ref|, max abs error, relative L2 error):
    ulp = 2^-7 of the power of two at or below |ref| (0 where ref is 0)."""
    ours, ref = ours.float(), ref.float()
    _, e = torch.frexp(ref)
    ulp = torch.where(ref == 0, torch.zeros_like(ref), torch.ldexp(torch.ones_like(ref), e - 8))
    err = (ours - ref).abs()
    worst = err.max().item()
    return ((err <= ulp).float().mean().item(), worst / max(ref.abs().max().item(), 1e-30), worst,
            (err.norm() / max(ref.norm().item(), 1e-30)).item())


def bf16_ok(agreement: tuple, summed: bool = False) -> bool:
    """An elementwise output: BF16_ULP_SHARE within one ulp; a weight
    gradient (``summed``): relative L2 within BF16_SUM_RTOL; both: every
    element within BF16_MAX_RTOL of max|ref|."""
    share, rel, _, l2 = agreement
    return bool(np.isfinite(rel) and rel <= BF16_MAX_RTOL and (l2 <= BF16_SUM_RTOL if summed else
                                                                share >= BF16_ULP_SHARE))


def to_bf16(w: gh.GatedHiFiWeights) -> gh.GatedHiFiWeights:
    return gh.GatedHiFiWeights(
        ks=tuple(k.to(torch.bfloat16) for k in w.ks), dilations=w.dilations,
        **{k: v.to(torch.bfloat16) for k, v in w.tensors().items() if not k.startswith("ks.")})


def phase_bf16_mma(device, card: str) -> bool:
    """Whether the bf16 MMA's fp32 accumulation truncates (csrc/gated_hifi_fwd.cu:bf16_mma_probe)."""
    out = torch.zeros(2, device=device)
    rc = _build.build().bf16_mma_probe(out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    torch.cuda.synchronize()
    require(rc == 0, f"bf16_mma_probe failed with cudaError {rc}")
    got = out.cpu().tolist()
    nearest, truncated = [1.0 + 2.0 ** -23, -(1.0 + 2.0 ** -23)], [1.0, -1.0]
    require(got in (nearest, truncated), f"bf16 MMA probe gave {got}, neither rounding")
    truncates = got == truncated
    print(f"[bf16 mma] m16n8k16 bf16 MMA, accumulator +-1 plus one product of 0.75 ulp: {got[0]!r}, {got[1]!r} "
          f"-> the fp32 accumulation {'truncates (rounds toward zero)' if truncates else 'rounds to nearest'} "
          f"[{card}]")
    return truncates


def phase_wgmma(device, card: str) -> bool:
    """wgmma as B1's bf16 backward runs it (csrc/gated_hifi_bwd_bf16.cu:wgmma_probe):
    whether its fp32 accumulation truncates, as the bf16 MMA's does (the
    reduction adds its accumulators into fp32 partials every 1,024 frames
    either way), and both operand layouts it reads (K-major, and MN-major
    with two 64-column tiles LBO apart) exact on a product of small integers,
    and a K-major operand read from 3 rows into its tile, as a window of
    frames shared by a conv's taps would be read, exact with the
    descriptor's base offset 0 (with base offset 3 it reads other rows:
    printed, not required)."""
    out = torch.zeros(6, device=device)
    rc = _build.build().wgmma_probe(out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    torch.cuda.synchronize()
    require(rc == 0, f"wgmma_probe failed with cudaError {rc}")
    got = out.cpu().tolist()
    nearest, truncated = [1.0 + 2.0 ** -23, -(1.0 + 2.0 ** -23)], [1.0, -1.0]
    require(got[:2] in (nearest, truncated), f"wgmma probe gave {got[:2]}, neither rounding")
    truncates = got[:2] == truncated
    print(f"[wgmma] m64n128k16 bf16 wgmma, accumulator +-1 plus one product of 0.75 ulp: {got[0]!r}, {got[1]!r} "
          f"-> the fp32 accumulation {'truncates (rounds toward zero)' if truncates else 'rounds to nearest'}; "
          f"64 x 128 x 64 products of small integers against FMA sums: K-major max error {got[2]!r}, MN-major "
          f"{got[3]!r}, K-major from row 3 with base offset 0 {got[4]!r} (with base offset 3 {got[5]!r}) [{card}]")
    require(got[2] == 0.0 and got[3] == 0.0 and got[4] == 0.0,
            f"a wgmma layout reads other elements than written: {got[2:5]}")
    return truncates


def b1_bf16_bytes_per_frame(depth: int, W: int = 64) -> dict:
    """Bytes a frame B1's bf16 backward moves through device memory by its
    design, counted from the stages' reads and writes (a conv tap's shifted
    re-reads of the same frames not counted): design arithmetic, printed
    beside the measured times, not a measurement."""
    ldw = depth * 2 * W
    bias = 4 * (3 * ldw + W) / 128  # the 128-frame tiles' fp32 column sums: written once, read once
    tiles = {"expand": 2 * W + 2 * ldw, "conv": 4 * ldw, "branch": 2 * ldw + 2 * W + 4 * ldw,
             "gate": 2 * W + 4 * ldw + 4 * ldw + 2 * ldw + 4 * W, "dc": 2 * ldw + 2 * ldw + 2 * ldw,
             "convt": 2 * ldw + 4 * ldw + 2 * ldw + 2 * ldw, "dx": 2 * ldw + 4 * W}
    return {"tiles": sum(tiles.values()) + bias, "reduction": 6 * W + 10 * ldw + bias, "by_stage": tiles}


def b1_bf16_fwd_bytes_per_frame(depth: int, W: int = 64) -> dict:
    """Bytes a frame B1's bf16 forward moves through device memory by its
    design (csrc/gated_hifi_fwd_bf16.cu), each stage's reads and writes (a
    conv tap's shifted re-reads and the gate stage's re-reads of x a branch
    not counted): design arithmetic, printed beside the measured times, not a
    measurement."""
    ldw = depth * 2 * W
    return {"expand": 2 * W + 2 * ldw, "conv": 2 * ldw + 2 * ldw, "gate": 2 * ldw + 2 * W + 2 * W}


def kernel_times(fn) -> dict:
    """Device ms a call of ``fn`` by kernel name (torch.profiler over 3
    calls), the wrapper's own copies included: launch_kinds without the
    counts."""
    return {name: ms for name, (ms, _) in launch_kinds(fn).items()}


def phase_bf16_kernel(device, card: str, block_ts=BLOCK_TS, batch: int = BATCH, depth: int = 4,
                      tag: str = "[bf16 kernel]") -> dict:
    """B1's bf16 forward against its plain bf16 version at each block shape,
    p=0 (times) and p=0.1 (two calls bitwise equal), and the bf16 backward
    kernels' dropout masks read back bit for bit; then the forward's device
    time by kernel at the largest shape (p=0.1) beside its design's bytes a
    frame."""
    w = to_bf16(block_weights(device, seed=1, depth=depth))
    seed = 4321
    out = {"max_abs_err": 0.0, "ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "share": 1.0}
    flops = nbytes = 0
    keep = 1.0 - gh.keep_threshold(P_DROP) / 65536.0
    with torch.inference_mode():
        for i, T in enumerate(block_ts):
            x, lens, valid, _ = block_inputs(T, batch, 100 + i, device)
            x = x.to(torch.bfloat16)
            for p in (0.0, P_DROP):
                ref = gh.gated_hifi_reference(x, lens, w, 1.0, p, seed)
                got = gh.gated_hifi(x, lens, w, 1.0, p, seed)
                again = gh.gated_hifi(x, lens, w, 1.0, p, seed)
                torch.cuda.synchronize()
                agree = bf16_agreement(got[valid], ref[valid])
                zeros = bool((got[~valid] == 0).all().item())
                bitwise = torch.equal(got, again)
                times = ""
                if p == 0.0:
                    dev = device_ms(lambda: gh.gated_hifi(x, lens, w))
                    call = cuda_ms(lambda: gh.gated_hifi(x, lens, w))
                    plain = cuda_ms(lambda: gh.gated_hifi_reference(x, lens, w), reps=3, warmup=1)
                    out["ms"] += dev
                    out["call_ms"] += call
                    out["plain_ms"] += plain
                    times = (f"; kernel {dev:.3f} ms over {DEVICE_REPS} back-to-back calls, {call:.3f} ms a call, "
                             f"plain {plain:.3f} ms")
                print(f"{tag} B={batch} T={T} p={p}: {agree[0]:.5f} of valid elements within one bf16 ulp "
                      f"(need {BF16_ULP_SHARE}), max_abs_err {agree[2]:.3e} = {agree[1]:.2e} of max|ref| (tol "
                      f"{BF16_MAX_RTOL:.4g}); exact zeros past lens {zeros}; two calls bitwise equal {bitwise}"
                      f"{times} [{card}]")
                require(bf16_ok(agree), f"bf16 forward disagrees at T={T} p={p}: {agree}")
                require(zeros and bitwise, f"bf16 forward at T={T} p={p}: zeros {zeros}, bitwise {bitwise}")
                out["max_abs_err"] = max(out["max_abs_err"], agree[2])
                out["share"] = min(out["share"], agree[0])
                del ref, got, again
            (n0, n1, n01), n, same, changed = read_back_masks(device, T, batch, depth, seed, torch.bfloat16)
            rates = {"site 0": (n0 / n, keep), "site 1": (n1 / n, keep), "both": (n01 / n, keep * keep)}
            print(f"{tag} T={T}: the bf16 backward kernels' masks equal the plain version's at both sites "
                  f"of all 4 branches; keep rates " + ", ".join(f"{k} {r:.6f} (expect {q:.6f})"
                                                                for k, (r, q) in rates.items())
                  + f"; same seed same masks {same}; another seed changes {changed:.4f} of site 0 [{card}]")
            for k, (r, q) in rates.items():
                require(abs(r - q) <= 5 * np.sqrt(q * (1 - q) / n), f"bf16 keep rate {k} {r} vs {q} at T={T}")
            require(same and changed > 0.1, f"bf16 masks at T={T}: same {same}, changed {changed}")
            flops += batch * T * block_flops_per_frame(w)
            nbytes += 2 * (2 * x.numel() + sum(t.numel() for t in w.tensors().values()))
            torch.cuda.empty_cache()
    with torch.inference_mode():
        x, lens, _, _ = block_inputs(block_ts[0], batch, 100, device)
        x = x.to(torch.bfloat16)
        stages = kernel_times(lambda: gh.gated_hifi(x, lens, w, 1.0, P_DROP, seed))
        del x, lens
    per_frame = b1_bf16_fwd_bytes_per_frame(depth)
    print(f"{tag} by kernel at B={batch} T={block_ts[0]}, p={P_DROP} (torch.profiler, 3 calls, device ms a call): "
          + ", ".join(f"{n} {t:.4f}" for n, t in stages.items()) + f" (sum {sum(stages.values()):.4f}); the design's "
          f"bytes a frame {sum(per_frame.values())} (" + ", ".join(f"{k} {v}" for k, v in per_frame.items())
          + f"; design arithmetic, not measured) [{card}]")
    torch.cuda.empty_cache()
    out["bound_ms"], out["bound_by"] = bf16_bound(flops, nbytes)
    print(f"{tag} sum over the {len(block_ts)} block shapes, p=0: kernel {out['ms']:.3f} ms over "
          f"{DEVICE_REPS} back-to-back calls ({out['call_ms']:.3f} ms a call), plain {out['plain_ms']:.3f} ms; bound "
          f"{out['bound_ms']:.3f} ms by {out['bound_by']} ({flops / 1e9:.1f} GFLOP at {PEAK_BF16 / 1e12:.0f} TF/s, "
          f"{nbytes / 1e6:.1f} MB) [{card}]")
    return out


def bf16_leaves(ours: dict, ref: dict) -> dict:
    """name -> bf16_agreement of a weight gradient, its relative L2 over a
    norm floored at BF16_SUM_RTOL of the largest leaf's (a leaf whose true
    gradient is zero, like the key bias under the shift-invariant softmax,
    holds rounding only)."""
    top = max(t.float().norm().item() for t in ref.values())
    out = {}
    for name, r in ref.items():
        share, rel, worst, _ = bf16_agreement(ours[name], r)
        l2 = (ours[name].float() - r.float()).norm().item() / max(r.float().norm().item(), BF16_SUM_RTOL * top)
        out[name] = (share, rel, worst, l2)
    return out


def bf16_grads_ok(tag: str, dx: tuple, leaves: dict, bitwise: bool) -> str:
    """dx and every weight gradient by the CPU tests' measure (relative L2
    within BF16_SUM_RTOL, every element within BF16_MAX_RTOL of max|ref|);
    returns the report's text."""
    worst = max(leaves, key=lambda n: leaves[n][3])
    require(bf16_ok(dx, summed=True), f"{tag}: dx disagrees: {dx}")
    for name, agree in leaves.items():
        require(agree[3] <= BF16_SUM_RTOL and np.isfinite(agree[1]), f"{tag}: grad {name} disagrees: {agree}")
    require(bitwise, f"{tag}: two backward calls differ")
    return (f"dx relative L2 {dx[3]:.2e}, max_abs_err {dx[1]:.2e} of max|ref| ({dx[0]:.5f} within one ulp); "
            f"worst weight grad {worst} relative L2 {leaves[worst][3]:.2e} (tol {BF16_SUM_RTOL:.4g}); two calls "
            f"bitwise equal {bitwise}")


def wn_bf16(w: wn_ops.WNWeights) -> wn_ops.WNWeights:
    return wn_ops.WNWeights.from_flat([t.to(torch.bfloat16) for t in w.flat()], w.dilations)


def enc_bf16(w: enc_ops.EncLayerWeights) -> enc_ops.EncLayerWeights:
    return w.with_tensors([t.to(torch.bfloat16) for t in w.tensors().values()])


def launch_kinds(fn) -> dict:
    """name -> (device ms a call, launches a call) of every kernel of ``fn``
    (torch.profiler over 3 calls); wn16_gemm_kernel's and enc16_gemm_kernel's
    instances named by their epilogue (WN16_EPILOGUES, ENC16_EPILOGUES),
    enc16_rows_kernel's by its mode (ENC16_ROWS)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):  # a first session can drop a call's first kernels
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    kinds = {}
    for e in prof.key_averages():
        t = next((float(getattr(e, n)) for n in ("self_device_time_total", "self_cuda_time_total")
                  if hasattr(e, n)), 0.0)
        if t > 0:
            name = re.sub(r"^void |\(.*$", "", e.key.replace("(anonymous namespace)::", ""))
            for kernel, kinds_of in (("wn16_gemm_kernel", WN16_EPILOGUES), ("enc16_gemm_kernel", ENC16_EPILOGUES),
                                     ("enc16_rows_kernel", ENC16_ROWS)):
                m = re.search(kernel + r"<(\d+)>", name)
                if m:
                    name = f"{kernel}<{kinds_of[int(m.group(1))]}>"
            ms, n = kinds.get(name, (0.0, 0.0))
            kinds[name] = (ms + t / 3 / 1e3, n + e.count / 3)
    return kinds


def complete_kinds(fn, kernels: tuple, tries: int = 4):
    """launch_kinds(fn) once it counts each of ``kernels`` exactly once a
    call: torch.profiler drops a launch now and then, so a profile that
    misses one is taken again, up to ``tries`` times; None if none was
    complete."""
    for _ in range(tries):
        kinds = launch_kinds(fn)
        if all(kinds.get(k, (0.0, 0.0))[1] == 1.0 for k in kernels):
            return kinds
    return None


def kinds_line(kinds) -> str:
    if kinds is None:
        return "not measured (no complete profile)"
    return (", ".join(f"{n} {t:.4f} x{c:g}" for n, (t, c) in sorted(kinds.items(), key=lambda kv: -kv[1][0]))
            + f" (sum {sum(t for t, _ in kinds.values()):.4f} ms, {sum(c for _, c in kinds.values()):g} launches)")


def wn16_fwd_bytes_per_frame(w: wn_ops.WNWeights, half: int, c_out: int, flow: bool) -> dict:
    """Device-memory bytes a frame of csrc/wn_coupling_bf16.cu's forward by
    design (each launch's operands read once, a conv's taps counted once,
    its outputs written once; weights left out), by part of the call:
    design arithmetic, not a measurement."""
    H, L, C = w.hidden, len(w.win), c_out
    pack = 2 * C + 2 * C if flow else 2 * half + 2 * half
    prefix = 2 * C + 2 * C if flow else 0
    chain = 2 * half + 4 * H + 2 * H  # START: x0 in, h32 and h out
    for i in range(L):
        last = i == L - 1
        chain += 2 * H + 2 * H  # GATE: h in, acts out
        chain += 2 * H + (4 * H if i else 0) + (0 if last else 4 * H + 4 * H + 2 * H) + 4 * H + (2 * H if last else 0)
    end = 2 * H + 2 * C
    return {"pack": pack, "prefix": prefix, "chain": chain, "end": end, "total": pack + prefix + chain + end}


def wn16_bytes_per_frame(w: wn_ops.WNWeights, half: int, c_out: int, flow: bool) -> dict:
    """Device-memory bytes a frame of csrc/wn_coupling_bf16.cu's backward by design
    (each launch's operands read once, a conv's taps and the weight sums'
    shifts counted once, its outputs written once; weights and the
    partials, which do not grow with the frames, left out), by part of the
    call: design arithmetic, not a measurement."""
    H, L, C = w.hidden, len(w.win), c_out
    pack = 2 * 2 * C + (2 * C + 2 * C + 2 * 2 * (C - half) if flow else 2 * 2 * half)
    recompute = (2 * half + 4 * H + 2 * H) + L * (2 * H + 8 * H + 2 * H) + (2 * C + 2 * half if flow else 0)
    for i in range(L):
        skip = 4 * H if i == 0 else 8 * H
        recompute += 2 * H + (skip + 2 * H if i == L - 1 else 8 * H + 2 * H + skip)
    transposed = 2 * C + 2 * H + 2 * H + 2 * half + (2 * half + 3 * 2 * C if flow else 0)
    for i in range(L):
        last = i == L - 1
        transposed += (2 * H if last else 4 * H) + 8 * H + 4 * H + 4 * H + (4 * H if last else 8 * H) + 2 * H
    wsums = 2 * half + 2 * H + L * (2 * H + 4 * H) + L * (2 * H + 2 * H) + (L - 1) * 2 * H + 2 * H + 2 * C
    wsums += 4 * C if flow else 0
    biases = 2 * C  # g's rows for dbend (the other bias sums come from the epilogues' partial rows)
    return {"pack": pack, "recompute": recompute, "transposed": transposed, "weight and bias sums": wsums + biases,
            "total": pack + recompute + transposed + wsums + biases}


def phase_bf16_wn_coupling(model: GlowTTS, device, card: str) -> dict:
    """B3's bf16 forward and backward kernels against the plain bf16
    versions at B3_SHAPES (the first coupling block's weights in bf16) and
    B3_OTHER_SHAPES (x0 a view of odd stride and offset), p=0 and B3_DROP:
    the output, dx and the weight gradients within BF16_SUM_RTOL relative L2
    and every element within BF16_MAX_RTOL of max|ref|
    (tests/test_torch_bf16_wn_coupling.py's measures for dx), two calls
    bitwise equal; the forward's x_in and skip sum (``return_buffers``)
    equal to the backward's recompute bit for bit; times at (8, 384). The
    share within one ulp is printed, not held: at Glow's width each product
    sums 960 terms in fp32, in another order than the plain version's, so
    an intermediate within that rounding of a bf16 boundary rounds one ulp
    apart (about 1e-4 of them); through four layers and the end conv, whose
    outputs cancel, some 5% of the outputs then move by more than one ulp of
    their own magnitude while the relative L2 error stays near 2e-3 (the
    CPU tests' small widths sum exactly and meet the share). So each layer
    is also held at the kernel's own rounded intermediates (teacher_forced
    on its x_in): every layer's x_in, and the forward's out against the
    plain end conv on its skip sum (end_conv), at least BF16_ULP_SHARE
    within one ulp. Then the bf16 backward's masks read back bit for bit;
    the forward and the backward by launch kind at (8, 384) and their bytes
    a frame by design."""
    w0 = wn_bf16(model.decoder.flows[2].conditioner_weights())
    half = model.n_mels * model.n_sqz // 2
    seed = torch.tensor([4343], dtype=torch.int64, device=device)
    fwd_out, bwd_out = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    cases = [("glow", B, T) for B, T in B3_SHAPES] + [("other", j, None) for j in range(len(B3_OTHER_SHAPES))]
    for i, (kind, a, b) in enumerate(cases):
        if kind == "glow":
            B, T = a, b
            rng = np.random.RandomState(780 + i)
            lens_np = ragged(rng, B, max(1, T // 2), T).astype(np.int32)
            lens = torch.from_numpy(lens_np).to(device)
            valid = torch.arange(T, device=device)[None, :] < lens[:, None]
            x = (torch.from_numpy(rng.randn(B, T, 2 * half).astype(np.float32)).to(device) * valid[..., None])
            x0, w = x.to(torch.bfloat16)[..., :half], w0
            g = torch.from_numpy(rng.randn(B, T, w.wend.shape[0]).astype(np.float32)).to(device).to(torch.bfloat16)
            tag = f"B={B} T={T}"
        else:
            w32, lens, valid, head, gs = other_shape_inputs(a, device, flow_step=False)
            B, T, hf, H, taps, rate, L = B3_OTHER_SHAPES[a]
            w = wn_bf16(w32)
            xb = head[0].to(torch.bfloat16)
            wide = torch.zeros(B, T, 2 * hf + 1, device=device, dtype=torch.bfloat16)
            wide[..., 1:1 + hf] = xb
            x0 = wide[..., 1:1 + hf]  # a view of odd row stride and offset, as the fp32 phase's
            g = gs[0].to(torch.bfloat16)
            lens_np = lens.cpu().numpy()
            tag = f"B={B} T={T} half={hf} H={H} k={taps} rate={rate} L={L}"
        for p in (0.0, B3_DROP):
            with torch.no_grad():
                ours, again = wn_ops.wn_coupling(x0, lens, w, seed, p), wn_ops.wn_coupling(x0, lens, w, seed, p)
                out_b, fbufs = wn_ops.wn_coupling(x0, lens, w, seed, p, return_buffers=True)
                ref = wn_ops.wn_coupling_reference(x0, lens, w, seed, p)
                dx_k, gw_k, bufs = wn_ops.wn_coupling_backward(x0, lens, w, g, seed, p, return_buffers=True)
                dx_k2, gw_k2 = wn_ops.wn_coupling_backward(x0, lens, w, g, seed, p)
                dx_r, gw_r = wn_ops.wn_coupling_backward_reference(x0, lens, w, g, seed, p)
                xins = teacher_forced(x0, lens, w, fbufs["xin"], seed, p)
                torch.cuda.synchronize()
            agree = bf16_agreement(ours[valid], ref[valid])
            require(ours.dtype == torch.bfloat16 and bf16_ok(agree, summed=True), f"[bf16 B3] {tag} p={p}: forward {agree}")
            require(torch.equal(ours, again) and torch.equal(ours, out_b),
                    f"[bf16 B3] {tag} p={p}: two forward calls differ")
            recompute = torch.equal(fbufs["xin"], bufs["xin"]) and torch.equal(fbufs["skip"], bufs["skip"])
            require(recompute, f"[bf16 B3] {tag} p={p}: the forward's x_in or skip sum is not the backward's recompute")
            bitwise = torch.equal(dx_k, dx_k2) and all(torch.equal(u, v) for u, v in zip(gw_k.flat(), gw_k2.flat()))
            report = bf16_grads_ok(f"[bf16 B3 bwd] {tag} p={p}", bf16_agreement(dx_k[valid], dx_r[valid]),
                                   bf16_leaves(gw_k.tensors(), gw_r.tensors()), bitwise)
            layers = [bf16_agreement(fbufs["xin"][j][valid], xins[j][valid])[0] for j in range(len(w.win))]
            end = bf16_agreement(ours[valid], end_conv(fbufs["skip"], lens, w)[valid])[0]
            require(min(layers) >= BF16_ULP_SHARE and end >= BF16_ULP_SHARE,
                    f"[bf16 B3] {tag} p={p}: a layer at the kernel's own intermediates: x_in {layers}, out {end}")
            times = ""
            if i == 0:
                with torch.no_grad():
                    t = {"fwd": device_ms(lambda: wn_ops.wn_coupling(x0, lens, w, seed, p)),
                         "fwd_call": cuda_ms(lambda: wn_ops.wn_coupling(x0, lens, w, seed, p)),
                         "fwd_plain": cuda_ms(lambda: wn_ops.wn_coupling_reference(x0, lens, w, seed, p), reps=5),
                         "bwd": device_ms(lambda: wn_ops.wn_coupling_backward(x0, lens, w, g, seed, p)),
                         "bwd_call": cuda_ms(lambda: wn_ops.wn_coupling_backward(x0, lens, w, g, seed, p), reps=5),
                         "bwd_plain": cuda_ms(lambda: wn_ops.wn_coupling_backward_reference(x0, lens, w, g, seed, p),
                                              reps=5, warmup=1)}
                frames = int(lens_np.sum())
                weights = sum(t_.numel() for t_ in w.flat())
                fb = bf16_bound(frames * wn_flops_per_frame(w), 2 * (frames * (half + w.wend.shape[0]) + weights))
                bb = bf16_bound(3 * frames * wn_flops_per_frame(w),
                                2 * (frames * (2 * half + w.wend.shape[0]) + 2 * weights))
                times = (f"; forward {t['fwd']:.4f} ms b2b ({t['fwd_call']:.4f} a call), plain {t['fwd_plain']:.4f}, "
                         f"bound {fb[0]:.4f} by {fb[1]}; backward {t['bwd']:.4f} ms b2b ({t['bwd_call']:.4f} a call), "
                         f"plain {t['bwd_plain']:.4f}, bound {bb[0]:.4f} by {bb[1]}")
                with torch.no_grad():
                    fkinds = launch_kinds(lambda: wn_ops.wn_coupling(x0, lens, w, seed, p))
                    kinds = launch_kinds(lambda: wn_ops.wn_coupling_backward(x0, lens, w, g, seed, p))
                if p == 0.0:
                    fwd_out.update(ms=t["fwd"], call_ms=t["fwd_call"], plain_ms=t["fwd_plain"], bound_ms=fb[0],
                                   bound_by=fb[1], kinds={n: [ms, c] for n, (ms, c) in fkinds.items()})
                else:
                    bwd_out.update(ms=t["bwd"], call_ms=t["bwd_call"], plain_ms=t["bwd_plain"], bound_ms=bb[0],
                                   bound_by=bb[1])
                print(f"[bf16 B3 fwd] {tag} p={p}: by launch kind (ms a call, launches a call): {kinds_line(fkinds)}; "
                      f"bytes a frame by design {wn16_fwd_bytes_per_frame(w, half, w.wend.shape[0], False)} [{card}]")
                print(f"[bf16 B3 bwd] {tag} p={p}: by launch kind (ms a call, launches a call): {kinds_line(kinds)}; "
                      f"bytes a frame by design {wn16_bytes_per_frame(w, half, w.wend.shape[0], False)} [{card}]")
            print(f"[bf16 B3] {tag} p={p}: forward {agree[0]:.5f} within one bf16 ulp (need {BF16_ULP_SHARE}), "
                  f"max_abs_err {agree[1]:.2e} of max|ref|; its x_in and skip sum the backward's recompute bit for "
                  f"bit {recompute}; at the kernel's own intermediates, within one ulp: x_in of layers "
                  f"0-{len(w.win) - 1} {', '.join(f'{v:.5f}' for v in layers)}, out against the end conv on its skip "
                  f"sum {end:.5f}; backward {report}{times} [{card}]")
            fwd_out["max_abs_err"] = max(fwd_out["max_abs_err"], agree[2])
            bwd_out["max_abs_err"] = max(bwd_out["max_abs_err"], bf16_agreement(dx_k[valid], dx_r[valid])[2])
            del ours, again, out_b, fbufs, ref, dx_k, gw_k, dx_k2, gw_k2, dx_r, gw_r, bufs, xins
    # the masks, as phase_bf16_flow_step reads B6's: with conv biases of 10 every pre-dropout x_in is positive
    B, T = B3_SHAPES[0]
    H, L = w0.hidden, len(w0.win)
    rng = np.random.RandomState(781)
    lens = torch.from_numpy(ragged(rng, B, T // 2, T).astype(np.int32)).to(device)
    x0 = torch.from_numpy(rng.randn(B, T, half).astype(np.float32)).to(device).to(torch.bfloat16)
    g = torch.zeros(B, T, w0.wend.shape[0], device=device, dtype=torch.bfloat16)
    probe = wn_ops.WNWeights(ws=w0.ws, bs=w0.bs, win=tuple(t * 0.01 for t in w0.win),
                             bin=tuple(torch.full_like(b_, 10.0) for b_ in w0.bin), wrs=w0.wrs, brs=w0.brs,
                             wend=w0.wend, bend=w0.bend, dilations=w0.dilations)
    with torch.no_grad():
        plain = wn_ops.wn_coupling_backward(x0, lens, probe, g, seed, 0.0, return_buffers=True)[2]["xin"]
        require(bool((plain > 0).all()), "the bf16 B3 dropout probe's conv outputs are not all positive")
        kept = [wn_ops.wn_coupling_backward(x0, lens, probe, g, s_, B3_DROP, return_buffers=True)[2]["xin"] > 0
                for s_ in (seed, seed + 1)]
    for i in range(L):
        require(torch.equal(kept[0][i], wn_ops.keep_mask(seed, lens, T, i, 2 * H, B3_DROP) > 0),
                f"bf16 B3 layer {i}: the kernel's masks differ from the plain version's")
    keep_rates_ok({"x_in": (int(kept[0].sum()), kept[0].numel())}, B3_DROP)
    changed = (kept[0] != kept[1]).float().mean().item()
    print(f"[bf16 B3 dropout] p={B3_DROP} B={B} T={T}: the bf16 backward's masks of all {L} layers equal the plain "
          f"version's bit for bit; keep rate {kept[0].float().mean().item():.6f} (expect {1 - B3_DROP:.6f}); another "
          f"seed changes {changed:.4f} [{card}]")
    require(changed > B3_DROP, f"bf16 B3: another seed changed only {changed} of the masks")
    return {"fwd": fwd_out, "bwd": bwd_out}


def enc16_bytes_per_frame(F: int, H: int, R: int, splits: int) -> dict:
    """Device-memory bytes a frame of csrc/enc_layer_bf16.cu's backward by design, by
    launch (each launch's operands read once, a conv's taps and the weight
    sums' shifts counted once, its outputs written once; the weights and the
    partials that do not grow with the frames left out; C = 192, S the split
    of the two 2,304-deep products): design arithmetic, not a measurement."""
    C, S, dots = 192, splits, 2 * 4 * 24 * H  # q R_k^T and doh R_v^T: 24 fp32 a row and head
    launches = {
        "pack (x masked)": 2 * C + 2 * C,
        "q|k|v": 2 * C + 6 * C,
        "attention recompute": 6 * C + 2 * C + 8 * H,
        "W_o (partials)": 2 * C + 4 * C,
        "LN1 forward": 4 * C + 2 * C + 4 * C + 4 * C + 2 * C + 4,
        "FFN conv 1": 2 * C + 4 * F + 2 * F,
        "FFN conv 2 (split partials)": 2 * F + 4 * S * C,
        "LN2 forward and backward": 4 * S * C + 4 * C + 2 * C + 4 * C + 2 * C,
        "conv^T W_2, relu'": 2 * C + 4 * F + 2 * F,
        "conv^T W_1 (split partials)": 2 * F + 4 * S * C,
        "LN1 backward": 4 * S * C + 4 * C + 4 * C + 4 + 4 * C + 2 * C,
        "doh": 2 * C + 2 * C,
        "attention dq": 6 * C + 2 * C + 8 * H + 4 * H + dots + 2 * 2 * H * R + 2 * C,
        "attention dk/dv": 6 * C + 2 * C + 12 * H + dots + 4 * C,
        "dx": 6 * C + 4 * C + 2 * C,
        "weight sums": 2 * C + 6 * C + 2 * C + 2 * C + 2 * C + 2 * F + 2 * F + 2 * C,
    }
    return {**launches, "total": sum(launches.values())}


def enc_variant(w: enc_ops.EncLayerWeights, k: int, window: int, seed: int) -> enc_ops.EncLayerWeights:
    """``w`` with FFN convs of kernel size ``k`` and relative tables of
    ``window``, drawn from ``seed`` at the layer's init scales, in bf16."""
    rng = np.random.RandomState(seed)
    Fc, C, _ = w.w1.shape
    D, R = C // w.n_heads, 2 * window + 1
    draw = lambda *shape, fan: torch.from_numpy(  # noqa: E731
        (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)).to(w.wq.device, torch.bfloat16)
    t = {**w.tensors(), "w1": draw(Fc, C, k, fan=C * k), "w2": draw(C, Fc, k, fan=Fc * k),
         "rk": draw(R, D, fan=D), "rv": draw(R, D, fan=D)}
    return enc_ops.EncLayerWeights(*t.values(), n_heads=w.n_heads, window=window, eps=w.eps)


def enc_bf16_intermediates(x, lens, w: enc_ops.EncLayerWeights, bufs: dict, seed, p: float) -> dict:
    """The bf16 backward's recompute held at its own intermediates, as
    teacher_forced holds B3's: its q|k|v against the plain bf16 products of
    x, its heads' output against the plain attention of its own q|k|v, and
    its FFN hidden rows (hid) against the plain conv, relu, dropout and mask
    of its own LN1 output (x1m). name -> bf16_agreement at the valid rows."""
    rnd, xf, wf = enc_ops._operands(x, w)
    B, T, C = x.shape
    H = wf.n_heads
    valid = torch.arange(T, device=x.device)[None, :] < lens[:, None]
    validf = valid.to(xf.dtype)[..., None]
    xm = xf * validf
    qkv = torch.cat([enc_ops.pointwise(rnd(xm), rnd(wt), b) for wt, b in ((wf.wq, wf.bq), (wf.wk, wf.bk),
                                                                           (wf.wv, wf.bv))], dim=-1)
    qk = bufs["qkv"].float()
    probs = enc_ops.attention_probs(qk[..., :C], qk[..., C:2 * C], validf, rnd(wf.rk), H, wf.window)
    if p > 0:
        probs = probs * enc_ops.attention_keep(seed, lens, H, T, p)
    pd = rnd(probs)
    att = enc_ops._merge(pd @ enc_ops._heads(qk[..., 2 * C:], H) + enc_ops.band_extract(pd, wf.window) @ rnd(wf.rv))
    hid = torch.relu(enc_ops.conv1d_ntc(bufs["x1m"].float(), rnd(wf.w1), wf.b1))
    if p > 0:
        hid = hid * enc_ops.dropout_keep(seed, lens, T, wf.w1.shape[0], enc_ops.SITE_FFN_MID, p)
    hid = hid * validf
    return {"q|k|v": bf16_agreement(bufs["qkv"][valid], qkv[valid]),
            "heads' output": bf16_agreement(bufs["att"][valid], att[valid]),
            "hid": bf16_agreement(bufs["hid"][valid], hid[valid])}


def phase_bf16_enc_layer(model: GlowTTS, device, card: str) -> dict:
    """B5's bf16 forward and backward kernels against the plain bf16
    versions at B5_SHAPES (the first encoder layer's weights in bf16), p=0
    and B5_DROP, the backward at the kernel's own FFN relu decisions (flips
    within BF16_FLIP_RTOL); measures as phase_bf16_wn_coupling's (the ulp
    share, printed, is near 0.99 at (8, 256) and lower at (1, 160): the same
    roundings of 192- to 768-term fp32 sums, through attention and two
    LayerNorms); the backward's recompute at its own intermediates
    (enc_bf16_intermediates: q|k|v, the heads' output and hid at least
    BF16_ULP_SHARE within one ulp); the bf16 dropout masks read back bit for
    bit (enc_masks); the forward's q|k|v, heads' output, x1m and hid
    (``return_buffers``) equal to the backward's recompute bit for bit; the
    same checks at B5_SWEEP_SHAPE over the kernel sizes and windows of
    B5_SWEEP (enc_variant); times at (8, 256), with the forward's and the
    backward's device time by launch kind (launch_kinds) and the backward's
    bytes a frame by design."""
    w0 = enc_bf16(model.encoder.layer_weights(0))
    C, Fc, H = w0.wq.shape[0], w0.w1.shape[0], w0.n_heads
    seed = torch.tensor([5353], dtype=torch.int64, device=device)
    fwd_out, bwd_out = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    cases = [(w0, B, T) for B, T in B5_SHAPES] + [(enc_variant(w0, k, window, 860 + j), *B5_SWEEP_SHAPE)
                                                   for j, (k, window) in enumerate(B5_SWEEP)]
    for i, (w, B, T) in enumerate(cases):
        rng = np.random.RandomState(840 + i)
        lens_np = ragged(rng, B, max(1, T // 2), T).astype(np.int32)
        lens = torch.from_numpy(lens_np).to(device)
        valid = torch.arange(T, device=device)[None, :] < lens[:, None]
        x = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device).to(torch.bfloat16)
        g = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device).to(torch.bfloat16)
        for p in (0.0, B5_DROP):
            with torch.no_grad():
                ours, again = enc_ops.enc_layer(x, lens, w, seed, p), enc_ops.enc_layer(x, lens, w, seed, p)
                out_b, fbufs = enc_ops.enc_layer(x, lens, w, seed, p, return_buffers=True)
                ref = enc_ops.enc_layer_reference(x, lens, w, seed, p)
                dx_k, gw_k, bufs = enc_ops.enc_layer_backward(x, lens, w, g, seed, p, return_buffers=True)
                dx_k2, gw_k2 = enc_ops.enc_layer_backward(x, lens, w, g, seed, p)
                rnd, xf, wf = enc_ops._operands(x, w)
                plain = enc_ops._forward(xf, lens, wf, seed, p, rnd)
                c1 = plain["c1"]
                gate = bufs["hid"] > 0
                kept = (enc_ops.dropout_keep(seed, lens, T, Fc, enc_ops.SITE_FFN_MID, p) > 0) if p else True
                flip = ((c1 > 0) != gate) & kept & valid[..., None]
                flips = (int(flip.sum()), c1.abs()[flip].max().item() if bool(flip.any()) else 0.0,
                         c1.abs().max().item())
                dx_r, gw_r = enc_ops.enc_layer_backward_reference(x, lens, w, g, seed, p, relu_gate=gate.float())
                inter = enc_bf16_intermediates(x, lens, w, bufs, seed, p)
                torch.cuda.synchronize()
            agree = bf16_agreement(ours[valid], ref[valid])
            tag = f"B={B} T={T} k={w.w1.shape[2]} window={w.window}"
            require(ours.dtype == torch.bfloat16 and bf16_ok(agree, summed=True), f"[bf16 B5] {tag} p={p}: forward {agree}")
            require(torch.equal(ours, again) and torch.equal(ours, out_b),
                    f"[bf16 B5] {tag} p={p}: two forward calls differ")
            recompute = {n: torch.equal(fbufs[n], bufs[n]) for n in enc_ops.FWD16_BUFFERS}
            require(all(recompute.values()),
                    f"[bf16 B5] {tag} p={p}: the forward's buffers are not the backward's recompute: {recompute}")
            require(flips[1] <= BF16_FLIP_RTOL * flips[2], f"[bf16 B5] {tag} p={p}: a relu flipped: {flips}")
            for name, a in inter.items():
                require(a[0] >= BF16_ULP_SHARE and np.isfinite(a[1]),
                        f"[bf16 B5 bwd] {tag} p={p}: the recompute's {name} is {a[0]} within one ulp of the plain "
                        f"forward at its own upstream values (need {BF16_ULP_SHARE}): {a}")
            bitwise = torch.equal(dx_k, dx_k2) and all(torch.equal(gw_k[n], gw_k2[n]) for n in gw_k)
            dx_agree = bf16_agreement(dx_k[valid], dx_r[valid])
            report = bf16_grads_ok(f"[bf16 B5 bwd] {tag} p={p}", dx_agree, bf16_leaves(gw_k, gw_r), bitwise)
            times = ""
            if i == 0:
                with torch.no_grad():
                    t = {"fwd": device_ms(lambda: enc_ops.enc_layer(x, lens, w, seed, p)),
                         "fwd_call": cuda_ms(lambda: enc_ops.enc_layer(x, lens, w, seed, p)),
                         "fwd_plain": cuda_ms(lambda: enc_ops.enc_layer_reference(x, lens, w, seed, p), reps=5),
                         "bwd": device_ms(lambda: enc_ops.enc_layer_backward(x, lens, w, g, seed, p)),
                         "bwd_call": cuda_ms(lambda: enc_ops.enc_layer_backward(x, lens, w, g, seed, p), reps=5),
                         "bwd_plain": cuda_ms(lambda: enc_ops.enc_layer_backward_reference(x, lens, w, g, seed, p),
                                              reps=5, warmup=1)}
                    fkinds = launch_kinds(lambda: enc_ops.enc_layer(x, lens, w, seed, p))
                    kinds = launch_kinds(lambda: enc_ops.enc_layer_backward(x, lens, w, g, seed, p))
                tokens = int(lens_np.sum())
                params = sum(t_.numel() for t_ in w.tensors().values())
                fb = bf16_bound(enc_flops(lens_np, w), 2 * (2 * tokens * C + params))
                bb = bf16_bound(3 * enc_flops(lens_np, w), 2 * (3 * tokens * C + 2 * params))
                per_frame = enc16_bytes_per_frame(Fc, H, 2 * w.window + 1, enc_ops.bwd16_splits(
                    B, T, Fc, w.w1.shape[2], torch.cuda.get_device_properties(device).multi_processor_count))
                times = (f"; forward {t['fwd']:.4f} ms b2b ({t['fwd_call']:.4f} a call), plain {t['fwd_plain']:.4f}, "
                         f"bound {fb[0]:.4f} by {fb[1]}; backward {t['bwd']:.4f} ms b2b ({t['bwd_call']:.4f} a call), "
                         f"plain {t['bwd_plain']:.4f}, bound {bb[0]:.4f} by {bb[1]}; forward by launch kind: "
                         f"{kinds_line(fkinds)}; backward by launch kind: {kinds_line(kinds)}; backward's bytes a "
                         f"frame by design {per_frame}")
                if p == 0.0:
                    fwd_out.update(ms=t["fwd"], call_ms=t["fwd_call"], plain_ms=t["fwd_plain"], bound_ms=fb[0],
                                   bound_by=fb[1], kinds={n: [ms, c] for n, (ms, c) in fkinds.items()})
                else:
                    bwd_out.update(ms=t["bwd"], call_ms=t["bwd_call"], plain_ms=t["bwd_plain"], bound_ms=bb[0],
                                   bound_by=bb[1], kinds={n: [ms, c] for n, (ms, c) in kinds.items()})
            print(f"[bf16 B5] {tag} p={p}: forward {agree[0]:.5f} within one bf16 ulp (need {BF16_ULP_SHARE}), "
                  f"max_abs_err {agree[1]:.2e} of max|ref|; its q|k|v, heads' output, x1m and hid the backward's "
                  f"recompute bit for bit {all(recompute.values())}; FFN relu flips {flips[0]} (largest |c1| "
                  f"{flips[1]:.1e} of "
                  f"max {flips[2]:.1e}); the backward's recompute at its own intermediates, within one bf16 ulp: "
                  + ", ".join(f"{n} {a[0]:.5f}" for n, a in inter.items())
                  + f" (need {BF16_ULP_SHARE}); backward {report}{times} [{card}]")
            if p > 0:
                enc_masks(x, lens, w, g, seed, bufs, plain, valid, card, flip_rtol=BF16_FLIP_RTOL)
            fwd_out["max_abs_err"] = max(fwd_out["max_abs_err"], agree[2])
            bwd_out["max_abs_err"] = max(bwd_out["max_abs_err"], dx_agree[2])
            del ours, again, out_b, fbufs, ref, dx_k, gw_k, bufs, dx_k2, gw_k2, dx_r, gw_r, plain
    return {"fwd": fwd_out, "bwd": bwd_out}


def phase_bf16_backward(device, card: str, block_ts=BLOCK_TS, batch: int = BATCH, depth: int = 4,
                        tag: str = "[bf16 backward]") -> dict:
    """B1's bf16 tile passes and reduction against the plain bf16 backward at
    each block shape, p=0 and p=0.1: dx and every weight gradient, taken at
    the kernel's own relu and dropout decisions (the flips printed), two
    calls bitwise equal; the reduction alone on the plain version's
    buffers; times at p=0.1 (the training configuration)."""
    w = to_bf16(block_weights(device, seed=1, depth=depth))
    seed = 12345
    out = {"dx_err": 0.0, "red_err": 0.0, "share": 1.0}
    sums = dict.fromkeys(("tiles", "tiles_call", "tiles_plain", "red", "red_call", "red_plain", "red_mm"), 0.0)
    work = {"tiles": [0, 0], "red": [0, 0], "buffers": 0}
    for p in (0.0, P_DROP):
        for i, T in enumerate(block_ts):
            x, lens, _, g = block_inputs(T, batch, 200 + i, device)
            x, g = x.to(torch.bfloat16), g.to(torch.bfloat16)
            args = (x, lens, w, g, 1.0, p, seed)
            dx_k, bufs_k = gh.backward_buffers(*args)
            gw_k = gh.weight_grad_reduce(x, bufs_k, w.kernels, w.dilations)
            dx_k2, gw_k2 = gh.gated_hifi_backward(*args)
            torch.cuda.synchronize()
            bitwise = torch.equal(dx_k, dx_k2) and all(
                torch.equal(a, b) for a, b in zip(gw_k.tensors().values(), gw_k2.tensors().values()))
            del dx_k2, gw_k2
            gates = (bufs_k.a > 0, bufs_k.h1 > 0)
            _, bufs_p = gh.backward_buffers_reference(*args)
            flips = {"a": kink_flips(bufs_k.a.float(), bufs_p.a.float()),
                     "h1": kink_flips(bufs_k.h1.float(), bufs_p.h1.float())}
            del bufs_p
            dx_r, bufs_r = gh.backward_buffers_reference(*args, gates=gates)
            gw_r = gh.weight_grad_reduce_reference(x, bufs_r, w.kernels, w.dilations)
            dx_agree = bf16_agreement(dx_k, dx_r)
            leaves = {n: bf16_agreement(t, gw_r.tensors()[n]) for n, t in gw_k.tensors().items()}
            red_k = gh.weight_grad_reduce(x, bufs_r, w.kernels, w.dilations)
            red = {n: bf16_agreement(t, gw_r.tensors()[n]) for n, t in red_k.tensors().items()}
            worst = max(leaves, key=lambda n: leaves[n][3])
            red_worst = max(red, key=lambda n: red[n][3])
            times = ""
            if p == P_DROP:
                frames_flops = batch * T * block_flops_per_frame(w)
                w_bytes = 2 * sum(t.numel() for t in w.tensors().values())
                buf_bytes = sum(getattr(bufs_r, f).numel() * getattr(bufs_r, f).element_size()
                                for f in ("a", "h1", "dzp", "dc", "dz", "u", "gv"))
                # the VJP's own bytes: the tile passes read x, g and the
                # weights and write dx; the reduction reads x and g and
                # writes the weight gradients
                work["tiles"][0] += 2 * frames_flops
                work["tiles"][1] += 2 * 3 * x.numel() + w_bytes
                work["red"][0] += frames_flops
                work["red"][1] += 2 * 2 * x.numel() + w_bytes
                work["buffers"] += buf_bytes
                mm = wgrad_mm_calls(x, bufs_r, w.kernels, w.dilations, bf16=True)
                t_ = {"tiles": device_ms(lambda: gh.backward_buffers(*args)),
                      "tiles_call": cuda_ms(lambda: gh.backward_buffers(*args), reps=5, warmup=1),
                      "tiles_plain": cuda_ms(lambda: gh.backward_buffers_reference(*args), reps=3, warmup=1),
                      "red": device_ms(lambda: gh.weight_grad_reduce(x, bufs_r, w.kernels, w.dilations)),
                      "red_call": cuda_ms(lambda: gh.weight_grad_reduce(x, bufs_r, w.kernels, w.dilations),
                                          reps=5, warmup=1),
                      "red_plain": cuda_ms(lambda: gh.weight_grad_reduce_reference(x, bufs_r, w.kernels, w.dilations),
                                           reps=3, warmup=1),
                      "red_mm": device_ms(mm)}
                for k, v in t_.items():
                    sums[k] += v
                del mm
                times = (f"; over {DEVICE_REPS} back-to-back calls tile passes {t_['tiles']:.3f} ms, reduction "
                         f"{t_['red']:.3f} ms vs its products as bf16 torch.mm {t_['red_mm']:.3f} ms; a call: tile "
                         f"passes {t_['tiles_call']:.3f} vs plain {t_['tiles_plain']:.3f}, reduction "
                         f"{t_['red_call']:.3f} vs plain {t_['red_plain']:.3f}")
            print(f"{tag} p={p} B={batch} T={T}: decisions flipped against the plain forward: "
                  + ", ".join(f"{k} {n_} (largest value {v:.1e} of max {m:.1e})" for k, (n_, v, m) in flips.items())
                  + f"; at the kernel's decisions dx {dx_agree[0]:.5f} within one bf16 ulp (need {BF16_ULP_SHARE}), "
                  f"max {dx_agree[1]:.2e} of max|ref|; weight grads worst {worst}: relative L2 {leaves[worst][3]:.2e} "
                  f"(tol {BF16_SUM_RTOL:.4g}), max {max(a[1] for a in leaves.values()):.2e} of max|ref| (tol "
                  f"{BF16_MAX_RTOL:.4g}), {min(a[0] for a in leaves.values()):.5f} within one ulp at the worst; "
                  f"reduction alone worst {red_worst} relative L2 {red[red_worst][3]:.2e}, "
                  f"{min(a[0] for a in red.values()):.5f} within one ulp; two calls bitwise equal {bitwise}{times} "
                  f"[{card}]")
            for name, (_, value, scale) in flips.items():
                require(value <= BF16_FLIP_RTOL * scale, f"bf16 {name}: a decision flipped at {value} of {scale}")
            require(bf16_ok(dx_agree), f"bf16 dx differs at p={p} T={T}: {dx_agree}")
            for name, agree in {**leaves, **{f"reduction {k}": v for k, v in red.items()}}.items():
                require(bf16_ok(agree, summed=True), f"bf16 grad {name} differs at p={p} T={T}: {agree}")
            require(bitwise, f"two bf16 backward calls differ at p={p} T={T}")
            out["dx_err"] = max(out["dx_err"], dx_agree[2])
            out["red_err"] = max(out["red_err"], max(a[2] for a in leaves.values()))
            out["share"] = min(out["share"], dx_agree[0])
            del dx_k, bufs_k, gw_k, gates, dx_r, bufs_r, gw_r, red_k
            torch.cuda.empty_cache()
    out.update(ms=sums["tiles"], call_ms=sums["tiles_call"], plain_ms=sums["tiles_plain"], red_ms=sums["red"],
               red_call_ms=sums["red_call"], red_plain_ms=sums["red_plain"], red_library_ms=sums["red_mm"])
    out["bound_ms"], out["bound_by"] = bf16_bound(*work["tiles"])
    out["red_bound_ms"], out["red_bound_by"] = bf16_bound(*work["red"])
    # the port's own buffers between the two (written by the tile passes,
    # read by the reduction), which the TPU kernel's VJP does not store: a
    # bound of this design, not of the function
    out["bound_buffers_ms"] = bf16_bound(work["tiles"][0], work["tiles"][1] + work["buffers"])[0]
    out["red_bound_buffers_ms"] = bf16_bound(work["red"][0], work["red"][1] + work["buffers"])[0]
    per_frame = b1_bf16_bytes_per_frame(depth)
    print(f"{tag} bytes a frame by design, not measured (reads and writes of device memory): tile passes "
          f"{per_frame['tiles']:.0f} (" + ", ".join(f"{k} {v}" for k, v in per_frame["by_stage"].items())
          + f"), reduction {per_frame['reduction']:.0f}")
    print(f"{tag} p={P_DROP} sums over the {len(block_ts)} block shapes: tile passes {sums['tiles']:.3f} ms "
          f"over {DEVICE_REPS} back-to-back calls ({sums['tiles_call']:.3f} a call, plain {sums['tiles_plain']:.3f}), "
          f"bound {out['bound_ms']:.3f} ms by {out['bound_by']} ({work['tiles'][0] / 1e9:.1f} GFLOP, "
          f"{work['tiles'][1] / 1e6:.1f} MB); reduction {sums['red']:.3f} ms ({sums['red_call']:.3f} a call, plain "
          f"{sums['red_plain']:.3f}), bound {out['red_bound_ms']:.3f} ms by {out['red_bound_by']} "
          f"({work['red'][0] / 1e9:.1f} GFLOP, {work['red'][1] / 1e6:.1f} MB), its products as bf16 torch.mm with "
          f"fp32 outputs {sums['red_mm']:.3f} ms; counting the port's buffers between them too "
          f"({work['buffers'] / 1e6:.1f} MB): tile passes {out['bound_buffers_ms']:.3f} ms, reduction "
          f"{out['red_bound_buffers_ms']:.3f} ms [{card}]")
    return out


def bf16_counts() -> tuple:
    return gh.gated_hifi.bf16_launches, gh.backward_buffers.bf16_launches, gh.weight_grad_reduce.bf16_launches


def zero_b1_counts() -> None:
    for fn in (gh.gated_hifi, gh.backward_buffers, gh.weight_grad_reduce):
        fn.launches = fn.bf16_launches = 0


def busy_share(fn) -> tuple:
    """(kernel ms, wall ms) of one call of ``fn`` under torch.profiler: the
    kernels' device time summed (one stream) against the host's clock."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and not e.key.startswith(
                ("Optimizer.", "ProfilerStep")):
            total += next((float(getattr(e, n)) for n in ("self_device_time_total", "self_cuda_time_total")
                           if hasattr(e, n)), 0.0)
    return total / 1e3, wall


def phase_bf16_train(device, card: str) -> dict:
    """The bf16 mixed-precision train step at 16 x 66048 samples (vqvae_tpu,
    AdamW + codebook EMA + parameter EMA, dropout 0.1), built by
    harness.make_train_step_for from ``train: {bf16: true}``, in turns with the
    fp32 step (information, no claim)."""
    audio, lengths = audio_batch(BATCH, SAMPLES, seed=8)
    batch = {"audio": audio.to(device), "audio_len": lengths.to(device)}
    runs = {}
    for name, bf16 in (("bf16", True), ("fp32", False)):
        model = harness.get_model({"model": copy.deepcopy(configs.VQVAE_TPU)}, device=device)
        harness.init_model_variables(model, batch, seed=TRAIN_SEED)
        opt, schedule = build_optimizer(model.parameters(), configs.VQVAE_TPU_OPTIMIZER)
        state = TrainState.create(model, opt, use_ema=True)
        runs[name] = (state, harness.make_train_step_for({"train": {"ema": True, "bf16": bf16}}, schedule,
                                                         default_mu(BATCH, 1)))
    times = {"bf16": [], "fp32": []}
    per_step = {"bf16": [], "fp32": []}
    losses, peaks = {"bf16": [], "fp32": []}, {}

    def run(name: str) -> None:
        state, step = runs[name]
        before = launch_counts() + bf16_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scalars = step(state, batch, TRAIN_SEED)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        peaks[name] = max(peaks.get(name, 0.0), torch.cuda.max_memory_allocated() / 2 ** 30)
        per_step[name].append(tuple(a - b for a, b in zip(launch_counts() + bf16_counts(), before)))
        raise_if_not_finite(scalars, state.step)
        losses[name].append(float(scalars["loss"]))

    state16 = runs["bf16"][0]
    bn16 = state16.model.bottleneck.level_blocks[0]
    params0 = {k: v.detach().clone() for k, v in state16.params.items()}
    ema0 = {k: v.clone() for k, v in state16.ema_params.items()}
    k0 = bn16.k.clone()
    zero_b1_counts()
    order = ["bf16", "fp32"] + ["bf16", "fp32", "fp32", "bf16"] * (BF16_TRAIN_ROUNDS // 2)
    for name in order:
        run(name)
    counts = bf16_counts()
    moved = sum(not torch.equal(p.detach(), params0[k]) for k, p in state16.params.items())
    ema_moved = sum(not torch.equal(e, ema0[k]) for k, e in state16.ema_params.items())
    dk = (bn16.k - k0).abs().max().item()
    del params0, ema0, k0
    kernel_ms, wall_ms = busy_share(lambda: runs["bf16"][1](state16, batch, TRAIN_SEED))
    medians = {n: statistics.median(t[1:]) for n, t in times.items()}
    fps = {n: BATCH * SAMPLES / HOP / (m / 1e3) for n, m in medians.items()}
    masters = all(p.dtype == torch.float32 for p in state16.params.values())
    codebook = bn16.k.dtype == torch.float32
    print(f"[bf16 train] B={BATCH} x {SAMPLES} samples, vqvae_tpu, dropout {P_DROP}, AdamW + codebook EMA + parameter "
          f"EMA: bf16 step losses {[round(l, 6) for l in losses['bf16']]}, fp32 step losses "
          f"{[round(l, 6) for l in losses['fp32']]}; masters fp32 {masters}, codebook fp32 {codebook}; over the "
          f"{len(times['bf16'])} bf16 steps {moved}/{len(state16.params)} masters and {ema_moved}/"
          f"{len(state16.ema_params)} EMA parameters moved, codebook k moved by up to {dk:.3e}")
    print(f"[bf16 train] launches per step (fp32 fwd, bwd, red, bf16 fwd, bwd, red): bf16 step {per_step['bf16']}; "
          f"fp32 step {per_step['fp32']}")
    print(f"[bf16 train] in turns (bf16, fp32, then fp32, bf16, bf16, fp32, ...): bf16 step ms "
          f"{', '.join(f'{t:.3f}' for t in times['bf16'])}; fp32 step ms {', '.join(f'{t:.3f}' for t in times['fp32'])}; "
          f"medians of steps 2-{len(times['bf16'])}: bf16 {medians['bf16']:.3f} ms, fp32 {medians['fp32']:.3f} ms "
          f"(bf16 / fp32 {medians['bf16'] / medians['fp32']:.4f}); max_memory_allocated a step: bf16 "
          f"{peaks['bf16']:.3f} GiB, fp32 {peaks['fp32']:.3f} GiB; one bf16 step under torch.profiler: kernels "
          f"{kernel_ms:.3f} ms of {wall_ms:.3f} ms wall, device busy {kernel_ms / wall_ms:.3f} [{card}]")
    print(json.dumps({"vqvae_train_mel_frames_per_sec_per_chip": fps["bf16"],
                      "vqvae_train_mel_frames_per_sec_per_chip_f32": fps["fp32"],
                      "step_ms": medians["bf16"], "step_ms_f32": medians["fp32"], "peak_gib": peaks["bf16"],
                      "peak_gib_f32": peaks["fp32"], "device_busy": kernel_ms / wall_ms, "card": card}))
    require(all(s_ == (0, 0, 0, 14, 14, 14) for s_ in per_step["bf16"]),
            f"bf16 launches per step {per_step['bf16']} != (0, 0, 0, 14, 14, 14)")
    require(all(s_ == (14, 14, 14, 0, 0, 0) for s_ in per_step["fp32"]),
            f"fp32 launches per step {per_step['fp32']} != (14, 14, 14, 0, 0, 0)")
    require(masters and codebook, "the bf16 step changed the masters' or the codebook's dtype")
    require(moved == len(state16.params), f"only {moved}/{len(state16.params)} masters moved in the bf16 steps")
    require(ema_moved == len(state16.ema_params),
            f"only {ema_moved}/{len(state16.ema_params)} EMA parameters moved in the bf16 steps")
    require(dk > 0, "the codebook did not change in the bf16 steps")
    require(all(np.isfinite(l) for l in losses["bf16"]), "a bf16 loss is not finite")
    return {"fwd": counts[0], "bwd": counts[1], "red": counts[2], "step_ms": medians["bf16"]}


def glow_bf16_counts() -> tuple:
    """(fp32 B5 fwd, bwd, B3 fwd, bwd, bf16 B5 fwd, bwd, B3 fwd, bwd, B4, fp32 B6 fwd, bwd, bf16 B6 fwd, bwd)
    launches so far."""
    e, eb, w_, wb = enc_ops.enc_layer, enc_ops.enc_layer_backward, wn_ops.wn_coupling, wn_ops.wn_coupling_backward
    f, fb = fs_ops.flow_step, fs_ops.flow_step_backward
    return (e.launches, eb.launches, w_.launches, wb.launches, e.bf16_launches, eb.bf16_launches, w_.bf16_launches,
            wb.bf16_launches, mas_ops.maximum_path_auto.launches, f.launches, fb.launches, f.bf16_launches,
            fb.bf16_launches)


def zero_glow_bf16_counts() -> None:
    for fn in (enc_ops.enc_layer, enc_ops.enc_layer_backward, wn_ops.wn_coupling, wn_ops.wn_coupling_backward,
               fs_ops.flow_step, fs_ops.flow_step_backward):
        fn.launches = fn.bf16_launches = 0
    mas_ops.maximum_path_auto.launches = 0


def vqtts_bf16_counts() -> tuple:
    """(fp32 B1 fwd, bwd, red, bf16 B1 fwd, bwd, red, B4, fp32 B5 fwd, bwd, bf16 B5 fwd, bwd) launches so far."""
    e, eb = enc_ops.enc_layer, enc_ops.enc_layer_backward
    return (*launch_counts(), *bf16_counts(), mas_ops.maximum_path_auto.launches, e.launches, eb.launches,
            e.bf16_launches, eb.bf16_launches)


def zero_vqtts_bf16_counts() -> None:
    zero_b1_counts()
    zero_glow_bf16_counts()


def bf16_steps(tag: str, state: TrainState, step, batch: dict, n: int, counts, card: str,
               frozen: frozenset = frozenset()) -> dict:
    """``n`` bf16 train steps of ``state``: wall times, launches per step (``counts()``), losses, the
    peak above what was held before, every master and EMA parameter moved (the ``frozen`` masters
    bitwise unchanged instead), fp32 masters, and one more step under torch.profiler for the
    device's busy share."""
    held = torch.cuda.memory_allocated()
    params0 = {k: v.detach().clone() for k, v in state.params.items()}
    ema0 = {k: v.clone() for k, v in state.ema_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, per_step, losses = [], [], []
    for _ in range(n):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scalars = step(state, batch, TRAIN_SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(a - b for a, b in zip(counts(), before)))
        raise_if_not_finite(scalars, state.step)
        losses.append({k: round(float(v), 5) for k, v in scalars.items() if "loss" in k})
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    trained = [k for k in state.params if k not in frozen]
    moved = sum(not torch.equal(state.params[k].detach(), params0[k]) for k in trained)
    ema_moved = sum(not torch.equal(state.ema_params[k], ema0[k]) for k in trained)
    still = all(torch.equal(state.params[k].detach(), params0[k]) for k in frozen)
    masters = all(p.dtype == torch.float32 for p in state.params.values())
    del params0, ema0
    kernel_ms, wall_ms = busy_share(lambda: raise_if_not_finite(step(state, batch, TRAIN_SEED), state.step))
    median = statistics.median(times[1:])
    print(f"{tag} losses per step {losses}; masters fp32 {masters}; {moved}/{len(trained)} masters and "
          f"{ema_moved}/{len(trained)} EMA parameters moved over the {n} steps"
          + (f"; the {len(frozen)} frozen masters unchanged {still}" if frozen else ""))
    print(f"{tag} step ms {', '.join(f'{t:.3f}' for t in times)}; median of steps 2-{n} {median:.3f} ms; "
          f"max_memory_allocated {peak:.3f} GiB above the {held / 2 ** 30:.3f} GiB held before; one more step under "
          f"torch.profiler: kernels {kernel_ms:.3f} ms of {wall_ms:.3f} ms wall, device busy {kernel_ms / wall_ms:.3f} "
          f"[{card}]")
    require(masters, f"{tag}: the masters are not fp32")
    require(moved == len(trained), f"{tag}: only {moved}/{len(trained)} masters moved")
    require(ema_moved == len(trained), f"{tag}: only {ema_moved}/{len(trained)} EMA parameters moved")
    require(still, f"{tag}: a frozen master changed")
    return {"per_step": per_step, "step_ms": median, "peak": peak, "busy": kernel_ms / wall_ms, "losses": losses}


def glow_mel_batch(model: GlowTTS, batch: int, device, seed: int) -> dict:
    """A Glow batch with the mel computed once on the card, as the loader's
    mel (with ``spect`` the bf16 step's flows run in bf16, as the JAX
    package's do; from audio its mel is fp32 and so are the flows)."""
    audio = glow_val_batch(batch, device, seed=seed)
    with torch.no_grad():
        spect, spect_len = spect_from_audio(model, audio)
    return {"token": audio["token"], "token_len": audio["token_len"], "spect": spect, "spect_len": spect_len}


def phase_bf16_glow_train(device, card: str, flow_step: bool = False) -> dict:
    """Glow-TTS's bf16 train step (configs.GLOW_TTS_TPU: B3's route, or with
    ``flow_step`` B6's, fused_flow_step: true; dropout on, AdamW + Noam +
    parameter EMA) at GLOW_BATCH x GLOW_FRAMES frames: ddi_init in fp32 (as
    JAX), then BF16_TRAIN_STEPS steps built by harness.make_train_step_for
    from ``train: {bf16: true}``. B3 (or B6) and B5 run their bf16 modes, 12
    and 6 calls a step each way, their fp32 modes none."""
    tag = "[bf16 glow train B6]" if flow_step else "[bf16 glow train]"
    model = build_glow(device, GLOW_SEED + 4, flow_step=flow_step)
    batch = glow_mel_batch(model, GLOW_BATCH, device, seed=34)
    model.ddi_init(batch, {"device_dropout": torch.Generator(device=device).manual_seed(18)})
    opt, schedule = build_optimizer(model.parameters(), configs.GLOW_TTS_TPU_OPTIMIZER,
                                    configs.GLOW_TTS_TPU_SCHEDULER, configs.GLOW_TTS_TPU)
    state = TrainState.create(model, opt, use_ema=True)
    step = harness.make_train_step_for({"train": {"ema": True, "bf16": True}}, schedule, default_mu(GLOW_BATCH, 1))
    zero_glow_bf16_counts()
    print(f"{tag} B={GLOW_BATCH} x {GLOW_FRAMES} frames ({int(batch['spect_len'].sum())} valid), {GLOW_TOKENS} "
          f"tokens, ragged, the mel computed on the card once; dropout (encoder {model.encoder.p_dropout}, decoder "
          f"{model.decoder.flows[2].p_dropout}, prenet {model.encoder.pre.P_DROPOUT}), AdamW + Noam + parameter EMA")
    out = bf16_steps(tag, state, step, batch, BF16_TRAIN_STEPS, glow_bf16_counts, card)
    expect = (0, 0, 0, 0, 6, 6, 0, 0, 1, 0, 0, 12, 12) if flow_step else (0, 0, 0, 0, 6, 6, 12, 12, 1, 0, 0, 0, 0)
    print(f"{tag} launches per step (fp32 B5 fwd, bwd, B3 fwd, bwd, bf16 B5 fwd, bwd, B3 fwd, bwd, B4, fp32 B6 "
          f"fwd, bwd, bf16 B6 fwd, bwd) {out['per_step']}")
    require(all(c == expect for c in out["per_step"]), f"{tag} launches {out['per_step']} != {expect}")
    frames = GLOW_BATCH * GLOW_FRAMES
    out.update(launches=glow_bf16_counts(), frames_per_s=frames / (out["step_ms"] / 1e3))
    print(json.dumps({f"glow_train_bf16{'_b6' if flow_step else ''}_mel_frames_per_sec_per_chip":
                      out["frames_per_s"], "step_ms": out["step_ms"], "peak_gib": out["peak"],
                      "device_busy": out["busy"], "card": card}))
    return out


def phase_bf16_vqtts_train(device, card: str, fused_encoder: bool) -> dict:
    """VQ-TTS's bf16 train step (configs.VQTTS_TPU, every dropout site on,
    Adam + codebook and parameter EMAs, the lazy codebook init in step 1) at
    VQTTS_BATCH x VQTTS_SAMPLES, on the config's encoder route or B5's: B1's
    bf16 mode 16 calls a step each way, B5's 6 on its route, the fp32 modes
    none."""
    tag = "[bf16 vqtts train B5]" if fused_encoder else "[bf16 vqtts train]"
    model = build_vqtts(device, VQTTS_SEED + 2, fused_encoder)
    batch = vqtts_batch(VQTTS_BATCH, VQTTS_SAMPLES, device, seed=43)
    opt, schedule = build_optimizer(model.parameters(), configs.VQTTS_TPU_OPTIMIZER)
    state = TrainState.create(model, opt, use_ema=True)
    step = harness.make_train_step_for({"train": {"ema": True, "bf16": True}}, schedule, default_mu(VQTTS_BATCH, 1))
    k0 = model.quant_bottleneck.k.clone()
    zero_vqtts_bf16_counts()
    print(f"{tag} B={VQTTS_BATCH} x {VQTTS_SAMPLES} samples and {VQTTS_TOKENS} tokens, ragged, dropout on, Adam + "
          f"codebook EMA + parameter EMA, the codebook's lazy init in step 1")
    out = bf16_steps(tag, state, step, batch, BF16_TRAIN_STEPS, vqtts_bf16_counts, card)
    b5 = 6 if fused_encoder else 0
    expect = (0, 0, 0, 16, 16, 16, 1, 0, 0, b5, b5)
    bn = model.quant_bottleneck
    dk = (bn.k - k0).abs().max().item()
    print(f"{tag} launches per step (fp32 B1 fwd, bwd, red, bf16 B1 fwd, bwd, red, B4, fp32 B5 fwd, bwd, bf16 B5 "
          f"fwd, bwd) {out['per_step']}; codebook fp32 {bn.k.dtype == torch.float32}, moved by up to {dk:.3e}")
    require(all(c == expect for c in out["per_step"]), f"{tag} launches {out['per_step']} != {expect}")
    require(bn.k.dtype == torch.float32 and dk > 0, f"{tag}: the codebook is {bn.k.dtype}, moved {dk}")
    seconds = VQTTS_BATCH * VQTTS_SAMPLES / configs.LJSPEECH_TPU["sample_rate"]
    out.update(launches=vqtts_bf16_counts(), audio_s_per_s=seconds / (out["step_ms"] / 1e3))
    print(json.dumps({f"vqtts_train_bf16{'_b5' if fused_encoder else ''}_audio_sec_per_sec_per_chip":
                      out["audio_s_per_s"], "step_ms": out["step_ms"], "peak_gib": out["peak"],
                      "device_busy": out["busy"], "card": card}))
    return out


def teacher_forced(x0: torch.Tensor, lens: torch.Tensor, w: wn_ops.WNWeights, xins: torch.Tensor, seed,
                   p: float) -> torch.Tensor:
    """The conditioner's plain bf16 layers held at the kernel's own rounded
    intermediates: layer i's conv output (post-dropout x_in) formed from the
    h_i that the kernel's x_in of layers 0 .. i-1 give (through the gate,
    the res/skip product and the residual). Returns [L, B, T, 2H] fp32."""
    rnd, xf, wf = wn_ops._operands(x0, w)
    H, L, T = wf.hidden, len(wf.win), xf.shape[1]
    valid = (torch.arange(T, device=xf.device)[None, :] < lens[:, None]).to(xf.dtype)[..., None]
    h = wn_ops.pointwise(rnd(xf), rnd(wf.ws), wf.bs) * valid
    plain = []
    for i in range(L):
        x_in = wn_ops._dilated(rnd(h), rnd(wf.win[i]), wf.bin[i], wf.dilations[i])
        if p > 0.0:
            x_in = x_in * wn_ops.keep_mask(seed, lens, T, i, 2 * H, p, xf.dtype)
        plain.append(x_in)
        acts = torch.tanh(xins[i][..., :H]) * torch.sigmoid(xins[i][..., H:])
        rs = wn_ops.pointwise(rnd(acts), rnd(wf.wrs[i]), wf.brs[i])
        if i < L - 1:
            h = (h + rs[..., :H]) * valid
    return torch.stack(plain)


def end_conv(skip: torch.Tensor, lens: torch.Tensor, w: wn_ops.WNWeights) -> torch.Tensor:
    """The conditioner's end conv, plain, on a skip sum (the kernel's own:
    ``return_buffers``' skip), its operands rounded to bf16 as the plain
    bf16 version rounds them."""
    rnd, _, wf = wn_ops._operands(skip.to(w.ws.dtype), w)
    valid = (torch.arange(skip.shape[1], device=skip.device)[None, :] < lens[:, None]).float()[..., None]
    return wn_ops.pointwise(rnd(skip.float() * valid), rnd(wf.wend), wf.bend).to(w.ws.dtype)


def phase_bf16_flow_step(model: GlowTTS, device, card: str) -> dict:
    """B6's bf16 forward and backward kernels against the plain bf16 versions
    at B3_SHAPES (the first flow step's weights in bf16; aln, alb and mt fp32
    holding the bf16 parameters' values, as the decoder passes them) and
    B3_OTHER_SHAPES, p=0 and B3_DROP: xc, out, dx and every gradient (daln,
    dalb, dmt in fp32) by phase_bf16_wn_coupling's measures, two calls bitwise
    equal; the forward's x_in and skip sum (``return_buffers``) and its xc's
    first half equal to the backward's recomputed x_in, skip sum and x0 bit
    for bit; then each conditioner layer at the kernel's own rounded
    intermediates (teacher_forced on its x_in): every layer's x_in, and the
    forward's out against the plain end conv on its skip sum (end_conv), at
    least BF16_ULP_SHARE within one bf16 ulp; the bf16 kernels' dropout
    masks read back bit for bit; times, and the forward and backward by
    launch kind, at (8, 384)."""
    act, inv, cpl = model.decoder.flows[0], model.decoder.flows[1], model.decoder.flows[2]
    w0 = wn_bf16(cpl.conditioner_weights())
    w0 = wn_ops.WNWeights.from_flat([t.detach() for t in w0.flat()], w0.dilations)
    with torch.no_grad():
        prefix0 = tuple(t.detach().to(torch.bfloat16).float().contiguous()
                        for t in (act.logs.view(-1), act.bias.view(-1), inv.dense_matrix_t()))
    C = model.n_mels * model.n_sqz
    seed = torch.tensor([4646], dtype=torch.int64, device=device)
    fwd_out, bwd_out = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    cases = [("glow", B, T) for B, T in B3_SHAPES] + [("other", j, None) for j in range(len(B3_OTHER_SHAPES))]
    for i, (kind, a, b) in enumerate(cases):
        if kind == "glow":
            B, T = a, b
            rng = np.random.RandomState(790 + i)
            lens_np = ragged(rng, B, max(1, T // 2), T).astype(np.int32)
            lens = torch.from_numpy(lens_np).to(device)
            valid = torch.arange(T, device=device)[None, :] < lens[:, None]
            x = (torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device) * valid[..., None])
            g_xc, g_out = (torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device) for _ in range(2))
            w, (aln, alb, mt), L = w0, prefix0, len(w0.win)
            tag = f"B={B} T={T}"
        else:
            w32, lens, valid, (x, _, aln, alb, mt), (g_xc, g_out) = other_shape_inputs(a, device, flow_step=True)
            B, T, hf, H, taps, rate, L = B3_OTHER_SHAPES[a]
            w = wn_bf16(w32)
            aln, alb, mt = (t.to(torch.bfloat16).float() for t in (aln, alb, mt))
            lens_np = lens.cpu().numpy()
            tag = f"B={B} T={T} half={hf} H={H} k={taps} rate={rate} L={L}"
        x, g_xc, g_out = (t.to(torch.bfloat16).contiguous() for t in (x, g_xc, g_out))
        half = x.shape[2] // 2
        args = (x, lens, aln, alb, mt, w)
        for p in (0.0, B3_DROP):
            with torch.no_grad():
                (xc, out), again = fs_ops.flow_step(*args, seed, p), fs_ops.flow_step(*args, seed, p)
                xc_b, out_b, fbufs = fs_ops.flow_step(*args, seed, p, return_buffers=True)
                xc_r, out_r = fs_ops.flow_step_reference(*args, seed, p)
                k1 = fs_ops.flow_step_backward(*args, g_xc, g_out, seed, p, return_buffers=True)
                k2 = fs_ops.flow_step_backward(*args, g_xc, g_out, seed, p)
                r = fs_ops.flow_step_backward_reference(*args, g_xc, g_out, seed, p)
                xins = teacher_forced(xc[..., :half], lens, w, fbufs["xin"], seed, p)
                torch.cuda.synchronize()
            fwd = {n: bf16_agreement(k[valid], ref[valid]) for n, k, ref in (("xc", xc, xc_r), ("out", out, out_r))}
            for n, agree in fwd.items():
                require(bf16_ok(agree, summed=True), f"[bf16 B6] {tag} p={p}: forward {n} {agree}")
            require(xc.dtype == out.dtype == torch.bfloat16 and torch.equal(xc, again[0]) and torch.equal(out, again[1])
                    and torch.equal(xc, xc_b) and torch.equal(out, out_b),
                    f"[bf16 B6] {tag} p={p}: the forward's dtypes, or two forward calls differ")
            recompute = (torch.equal(fbufs["xin"], k1[5]["xin"]) and torch.equal(fbufs["skip"], k1[5]["skip"])
                         and torch.equal(xc[..., :half], k1[5]["x0"]))
            require(recompute, f"[bf16 B6] {tag} p={p}: the forward's xc, x_in or skip sum is not the backward's "
                    "recompute")
            leaves = lambda o: {"daln": o[1], "dalb": o[2], "dmt": o[3], **o[4].tensors()}  # noqa: E731
            dtypes = (k1[0].dtype, k1[1].dtype, k1[3].dtype, k1[4].ws.dtype)
            require(dtypes == (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16),
                    f"[bf16 B6] {tag} p={p}: backward dtypes {dtypes}")
            bitwise = torch.equal(k1[0], k2[0]) and all(torch.equal(u, leaves(k2)[n]) for n, u in leaves(k1).items())
            dx_agree = bf16_agreement(k1[0][valid], r[0][valid])
            report = bf16_grads_ok(f"[bf16 B6 bwd] {tag} p={p}", dx_agree, bf16_leaves(leaves(k1), leaves(r)), bitwise)
            layers = [bf16_agreement(fbufs["xin"][j][valid], xins[j][valid])[0] for j in range(L)]
            end = bf16_agreement(out[valid], end_conv(fbufs["skip"], lens, w)[valid])[0]
            require(min(layers) >= BF16_ULP_SHARE and end >= BF16_ULP_SHARE,
                    f"[bf16 B6] {tag} p={p}: a layer at the kernel's own intermediates: x_in {layers}, out {end}")
            times = ""
            if i == 0:
                with torch.no_grad():
                    t = {"fwd": device_ms(lambda: fs_ops.flow_step(*args, seed, p)),
                         "fwd_call": cuda_ms(lambda: fs_ops.flow_step(*args, seed, p)),
                         "fwd_plain": cuda_ms(lambda: fs_ops.flow_step_reference(*args, seed, p), reps=5),
                         "bwd": device_ms(lambda: fs_ops.flow_step_backward(*args, g_xc, g_out, seed, p)),
                         "bwd_call": cuda_ms(lambda: fs_ops.flow_step_backward(*args, g_xc, g_out, seed, p), reps=5),
                         "bwd_plain": cuda_ms(lambda: fs_ops.flow_step_backward_reference(*args, g_xc, g_out, seed, p),
                                              reps=5, warmup=1)}
                frames = int(lens_np.sum())
                flops = frames * (wn_flops_per_frame(w) + 2 * C * C)
                weights = 2 * sum(t_.numel() for t_ in w.flat()) + 4 * (2 * C + C * C)  # bytes: bf16, fp32 prefix
                fb = bf16_bound(flops, 2 * 3 * frames * C + weights)
                bb = bf16_bound(3 * flops, 2 * 4 * frames * C + 2 * weights)
                times = (f"; forward {t['fwd']:.4f} ms b2b ({t['fwd_call']:.4f} a call), plain {t['fwd_plain']:.4f}, "
                         f"bound {fb[0]:.4f} by {fb[1]}; backward {t['bwd']:.4f} ms b2b ({t['bwd_call']:.4f} a call), "
                         f"plain {t['bwd_plain']:.4f}, bound {bb[0]:.4f} by {bb[1]}")
                with torch.no_grad():
                    fkinds = launch_kinds(lambda: fs_ops.flow_step(*args, seed, p))
                    kinds = launch_kinds(lambda: fs_ops.flow_step_backward(*args, g_xc, g_out, seed, p))
                if p == 0.0:
                    fwd_out.update(ms=t["fwd"], call_ms=t["fwd_call"], plain_ms=t["fwd_plain"], bound_ms=fb[0],
                                   bound_by=fb[1], kinds={n: [ms, c] for n, (ms, c) in fkinds.items()})
                else:
                    bwd_out.update(ms=t["bwd"], call_ms=t["bwd_call"], plain_ms=t["bwd_plain"], bound_ms=bb[0],
                                   bound_by=bb[1])
                print(f"[bf16 B6 fwd] {tag} p={p}: by launch kind (ms a call, launches a call): {kinds_line(fkinds)}; "
                      f"bytes a frame by design {wn16_fwd_bytes_per_frame(w, half, C, True)} [{card}]")
                print(f"[bf16 B6 bwd] {tag} p={p}: by launch kind (ms a call, launches a call): {kinds_line(kinds)}; "
                      f"bytes a frame by design {wn16_bytes_per_frame(w, half, C, True)} [{card}]")
            print(f"[bf16 B6] {tag} p={p}: forward xc {fwd['xc'][0]:.5f} / out {fwd['out'][0]:.5f} within one bf16 "
                  f"ulp, relative L2 {fwd['xc'][3]:.2e} / {fwd['out'][3]:.2e} (tol {BF16_SUM_RTOL:.4g}), max_abs_err "
                  f"{fwd['xc'][1]:.2e} / {fwd['out'][1]:.2e} of max|ref|; its xc's first half, x_in and skip sum the "
                  f"backward's recompute bit for bit {recompute}; at the kernel's own intermediates, within one ulp: "
                  f"x_in of layers 0-{L - 1} {', '.join(f'{v:.5f}' for v in layers)}, out against the end conv on "
                  f"its skip sum {end:.5f} (need {BF16_ULP_SHARE}); backward {report}{times} [{card}]")
            fwd_out["max_abs_err"] = max(fwd_out["max_abs_err"], fwd["xc"][2], fwd["out"][2])
            bwd_out["max_abs_err"] = max(bwd_out["max_abs_err"], dx_agree[2])
            del xc, out, again, xc_b, out_b, fbufs, xc_r, out_r, k1, k2, r, xins
    # the masks, as in phase 26: with conv biases of 10 every pre-dropout x_in is positive
    B, T = B3_SHAPES[0]
    H, L = w0.hidden, len(w0.win)
    rng = np.random.RandomState(791)
    lens = torch.from_numpy(ragged(rng, B, T // 2, T).astype(np.int32)).to(device)
    x = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device).to(torch.bfloat16)
    g = torch.zeros(B, T, C, device=device, dtype=torch.bfloat16)
    probe = wn_ops.WNWeights(ws=w0.ws, bs=w0.bs, win=tuple(t * 0.01 for t in w0.win),
                             bin=tuple(torch.full_like(b_, 10.0) for b_ in w0.bin), wrs=w0.wrs, brs=w0.brs,
                             wend=w0.wend, bend=w0.bend, dilations=w0.dilations)
    with torch.no_grad():
        plain = fs_ops.flow_step_backward(x, lens, *prefix0, probe, g, g, seed, 0.0, return_buffers=True)[5]["xin"]
        require(bool((plain > 0).all()), "the bf16 B6 dropout probe's conv outputs are not all positive")
        bufs = [fs_ops.flow_step_backward(x, lens, *prefix0, probe, g, g, s_, B3_DROP,
                                          return_buffers=True)[5]["xin"] > 0 for s_ in (seed, seed + 1)]
    for i in range(L):
        require(torch.equal(bufs[0][i], wn_ops.keep_mask(seed, lens, T, i, 2 * H, B3_DROP) > 0),
                f"bf16 B6 layer {i}: the kernel's masks differ from the plain version's")
    keep_rates_ok({"x_in": (int(bufs[0].sum()), bufs[0].numel())}, B3_DROP)
    changed = (bufs[0] != bufs[1]).float().mean().item()
    print(f"[bf16 B6 dropout] p={B3_DROP} B={B} T={T}: the bf16 kernels' masks of all {L} layers equal the plain "
          f"version's bit for bit; keep rate {bufs[0].float().mean().item():.6f} (expect {1 - B3_DROP:.6f}); another "
          f"seed changes {changed:.4f} [{card}]")
    require(changed > B3_DROP, f"bf16 B6: another seed changed only {changed} of the masks")
    return {"fwd": fwd_out, "bwd": bwd_out}


def phase_bf16_attention(device, card: str) -> dict:
    """B2's bf16 forward and backward kernels against the plain bf16 versions
    at ATTN_SHAPES (the LM's train shapes and the route's bound: packed bf16
    projections, ragged lengths) and ATTN_BF16_EDGES (odd T, lens from T
    down to 1), p=0 and P_DROP: o, dq, dk, dv by relative L2
    (BF16_SUM_RTOL) and every element within BF16_MAX_RTOL of max|ref| (the
    ulp share printed: the kernel's exp and sums in another order round a
    probability an ulp apart now and then), two calls bitwise equal; the
    kernel's dropout masks read back bit for bit (phase 11's way) at every
    shape, another seed's at (8, 258); times at ATTN_SHAPES: both kernels
    over DEVICE_REPS back-to-back calls (the forward through its C entry
    point), one call, the plain versions, the kernels' device time by
    launch kind (torch.profiler over 3 calls, taken again until it counts
    each kernel once a call, else left out), and bf16 SDPA's forward and
    backward at p=0 on the same inputs and mask."""
    scale = 1.0 / np.sqrt(ATTN_DIM)
    out = {"fwd_err": 0.0, "bwd_err": 0.0}
    for i, (B, T) in enumerate(ATTN_SHAPES + ATTN_BF16_EDGES):
        timed = i < len(ATTN_SHAPES)
        packed, lens, g = packed_qkv(B, T, 520 + i, device)
        if not timed:
            lens[-1] = 1
        packed, g = packed.to(torch.bfloat16), g.to(torch.bfloat16)
        for p in (0.0, P_DROP):
            seed = torch.tensor([22345 + i], dtype=torch.int64, device=device)
            qkv = packed.clone().requires_grad_(True)
            o = att.fused_attention(*heads(qkv), lens, seed, scale, p)
            grads = torch.autograd.grad(o, qkv, g, retain_graph=True)[0]
            again = torch.autograd.grad(o, qkv, g, retain_graph=True)[0]
            with torch.no_grad():
                fwd_bitwise = torch.equal(o, att.fused_attention(*heads(packed), lens, seed, scale, p))
                ref = att.attention_reference(*heads(packed), lens, seed, scale, p)
                grads_ref = att.attention_backward_reference(*heads(packed), lens, seed, g, scale, p)
            torch.cuda.synchronize()
            fwd = bf16_agreement(o, ref)
            bwd = {n: bf16_agreement(a, b_) for n, a, b_ in zip(("dq", "dk", "dv"), heads(grads), grads_ref)}
            bitwise = torch.equal(grads, again)
            require(o.dtype == grads.dtype == torch.bfloat16, f"[bf16 attention] B={B} T={T}: dtypes")
            require(bf16_ok(fwd, summed=True), f"[bf16 attention] B={B} T={T} p={p}: forward {fwd}")
            for n, agree in bwd.items():
                require(bf16_ok(agree, summed=True), f"[bf16 attention] B={B} T={T} p={p}: {n} {agree}")
            require(fwd_bitwise and bitwise, f"[bf16 attention] B={B} T={T} p={p}: two calls differ")
            masks = ""
            if p > 0.0:
                with torch.no_grad():
                    keep = kernel_keep_mask(B, T, lens, seed, device, torch.bfloat16)
                    plain = att.dropout_bits(seed, B, ATTN_HEADS, T, device) >= att.keep_threshold(P_DROP)
                valid = att.valid_pairs(lens, T).expand(B, ATTN_HEADS, T, T)
                equal = torch.equal(keep[valid], plain[valid])
                masks = f"; the masks read back at {int(valid.sum())} valid pairs equal the plain version's {equal}"
                require(equal, f"[bf16 attention] B={B} T={T}: the kernel's masks differ from the plain version's")
                del keep, plain, valid
            out["fwd_err"] = max(out["fwd_err"], fwd[2])
            out["bwd_err"] = max(out["bwd_err"], max(a_[2] for a_ in bwd.values()))
            agreement = (f"forward relative L2 {fwd[3]:.2e} (tol {BF16_SUM_RTOL:.4g}), {fwd[0]:.5f} within one bf16 "
                         f"ulp, max_abs_err {fwd[1]:.2e} of max|ref|; "
                         + ", ".join(f"{n} relative L2 {a_[3]:.2e} ({a_[0]:.5f} within one ulp, max {a_[1]:.2e})"
                                     for n, a_ in bwd.items())
                         + "; two calls bitwise equal" + masks)
            if not timed:
                print(f"[bf16 attention] B={B} T={T} lens {lens.tolist()} p={p}: {agreement} [{card}]")
                del o, grads, again, ref, grads_ref, qkv
                continue
            with torch.no_grad():
                args = (*heads(packed), lens, seed, scale, p)
                q_, k_, v_ = heads(packed)
                o_k, stats_k = att._launch_fwd(q_, k_, v_, lens, seed, scale, p)
                bwd_call = lambda: att.attention_backward(q_, k_, v_, o_k, stats_k, lens, seed, g, scale, p)  # noqa: E731
                times = {"fwd": cuda_ms(lambda: att.fused_attention(*args)),
                         "fwd_plain": cuda_ms(lambda: att.attention_reference(*args)),
                         "fwd_dev": device_ms(attention_fwd_launch(*args)),
                         "bwd_dev": device_ms(bwd_call),
                         "bwd_plain": cuda_ms(lambda: att.attention_backward_reference(q_, k_, v_, lens, seed, g,
                                                                                       scale, p))}
                inst = f"<{'true' if p > 0.0 else 'false'}>"
                kinds = {"fwd": complete_kinds(lambda: att.fused_attention(*args),
                                               (f"attention_bf16::{B2_BF16_KERNELS[0]}{inst}",)),
                         "bwd": complete_kinds(bwd_call, tuple(f"attention_bf16::{k}{inst}" for k in B2_BF16_KERNELS[1:]))}
            times["bwd"] = cuda_ms(lambda: torch.autograd.grad(o, qkv, g, retain_graph=True))
            if p == 0.0:
                times.update(sdpa_times(packed, lens, g, scale))
            pairs = int(torch.minimum(torch.arange(1, T + 1, device=device)[None, :], lens.long()[:, None]).sum()) * ATTN_HEADS
            row = B * T * ATTN_HEADS * ATTN_DIM * 2  # bytes of one [B, T, H, D] bf16 tensor
            fb, bb = bf16_bound(4 * ATTN_DIM * pairs, 4 * row), bf16_bound(10 * ATTN_DIM * pairs, 7 * row)
            print(f"[bf16 attention] B={B} T={T} H={ATTN_HEADS} D={ATTN_DIM} p={p}: {agreement}; over {DEVICE_REPS} "
                  f"back-to-back calls: forward {times['fwd_dev']:.4f} ms, backward kernels {times['bwd_dev']:.4f}; a "
                  f"call: forward {times['fwd']:.4f}, backward (autograd) {times['bwd']:.4f}; plain "
                  f"{times['fwd_plain']:.4f} / {times['bwd_plain']:.4f}"
                  + (f"; bf16 F.scaled_dot_product_attention (same mask) forward {times['sdpa_dev']:.4f} ms b2b, "
                     f"backward {times['sdpa_bwd_dev']:.4f}" if p == 0.0 else "")
                  + f"; bounds ({pairs} valid pairs) forward {fb[0]:.4f} ms by {fb[1]}, backward {bb[0]:.4f} by "
                  f"{bb[1]}; on the card by launch kind: forward {kinds_line(kinds['fwd'])}; backward "
                  f"{kinds_line(kinds['bwd'])} [{card}]")
            if (B, T) == ATTN_SHAPES[0]:
                if p == 0.0:
                    out.update(sdpa_dev=times["sdpa_dev"], sdpa_bwd_dev=times["sdpa_bwd_dev"],
                               fwd_dev_p0=times["fwd_dev"], bwd_dev_p0=times["bwd_dev"])
                else:
                    out.update(fwd_dev=times["fwd_dev"], fwd_ms=times["fwd"], fwd_plain_ms=times["fwd_plain"],
                               bwd_dev=times["bwd_dev"], bwd_ms=times["bwd"], bwd_plain_ms=times["bwd_plain"],
                               bound=fb, bwd_bound=bb, fwd_kinds=kinds["fwd"], bwd_kinds=kinds["bwd"])
            else:
                at = f"at_{B}x{T}"
                if p == 0.0:
                    out[at] = {"library_ms": times["sdpa_dev"], "bwd_library_ms": times["sdpa_bwd_dev"]}
                else:
                    out[at].update(ms=times["fwd_dev"], call_ms=times["fwd"], plain_ms=times["fwd_plain"],
                                   bound_ms=fb[0], bound_by=fb[1], bwd_ms=times["bwd_dev"], bwd_call_ms=times["bwd"],
                                   bwd_plain_ms=times["bwd_plain"], bwd_bound_ms=bb[0], bwd_bound_by=bb[1],
                                   **{n: v for n, v in (("launch_kinds", kinds["fwd"]),
                                                        ("bwd_launch_kinds", kinds["bwd"])) if v is not None})
            del o, grads, again, ref, grads_ref, qkv, o_k, stats_k
            torch.cuda.empty_cache()
    B, T = ATTN_SHAPES[0]
    _, lens, _ = packed_qkv(B, T, 601, device)
    seed = torch.tensor([41337], dtype=torch.int64, device=device)
    with torch.no_grad():
        keep = kernel_keep_mask(B, T, lens, seed, device, torch.bfloat16)
        other = kernel_keep_mask(B, T, lens, seed + 1, device, torch.bfloat16)
        plain = att.dropout_bits(seed, B, ATTN_HEADS, T, device) >= att.keep_threshold(P_DROP)
    valid = att.valid_pairs(lens, T).expand(B, ATTN_HEADS, T, T)
    equal = torch.equal(keep[valid], plain[valid])
    changed = (keep[valid] != other[valid]).double().mean().item()
    print(f"[bf16 attention dropout] p={P_DROP} B={B} T={T}: the bf16 kernel's masks read back at {int(valid.sum())} "
          f"valid pairs equal the plain version's {equal}; keep rate {keep[valid].double().mean().item():.6f}; "
          f"another seed changes {changed:.4f} [{card}]")
    require(equal and changed > 0.1, f"bf16 attention masks: equal {equal}, another seed changes {changed}")
    return out


def lm_bf16_counts() -> tuple:
    """(fp32 B2 fwd, bwd, bf16 B2 fwd, bwd) launches so far."""
    f, b = att.fused_attention, att.attention_backward
    return f.launches, b.launches, f.bf16_launches, b.bf16_launches


def phase_bf16_lm_train(device, card: str, vq_state: dict) -> dict:
    """The LM's bf16 train step (configs.TRANSFORMER_LM_TPU, dropout 0.1, Adam
    with the LM's warm-up, parameter EMA, the codec frozen; make_train_step
    with bf16=True) at each batch of LM_BATCHES x LM_T: BF16_TRAIN_STEPS
    steps, launches (fp32 B2 fwd, bwd, bf16 B2 fwd, bwd) = (0, 0, L, L) a
    step, ms, peak, the device's busy share."""
    out = {"launches": (0, 0, 0, 0)}
    n_layers = configs.TRANSFORMER_LM_TPU["num_layers"]
    for batch_n in LM_BATCHES:
        tag = f"[bf16 lm train b{batch_n}]"
        lm = build_lm(device, vq_state, seed=LM_SEED + 2)
        opt, schedule = lm_optimizer(lm)
        state = TrainState.create(lm, opt, use_ema=True)
        step = make_train_step(schedule, default_mu(batch_n, 1), use_ema=True, bf16=True)
        batch = lm_tokens(batch_n, LM_T, seed=60 + batch_n, device=device)
        frozen = frozenset(n for n, keep in harness.frozen_param_mask(lm).items() if not keep)
        f, b_ = att.fused_attention, att.attention_backward
        f.launches = f.bf16_launches = b_.launches = b_.bf16_launches = 0
        print(f"{tag} B={batch_n} x {LM_T} tokens, dropout {lm.dropout_p}, Adam + parameter EMA, the codec frozen")
        res = bf16_steps(tag, state, step, batch, BF16_TRAIN_STEPS, lm_bf16_counts, card, frozen)
        expect = (0, 0, n_layers, n_layers)
        print(f"{tag} launches per step (fp32 B2 fwd, bwd, bf16 B2 fwd, bwd) {res['per_step']}")
        require(all(c == expect for c in res["per_step"]), f"{tag} launches {res['per_step']} != {expect}")
        out["launches"] = tuple(a + c for a, c in zip(out["launches"], lm_bf16_counts()))
        res["tokens_per_s"] = batch_n * LM_T / (res["step_ms"] / 1e3)
        print(json.dumps({f"lm_train_bf16_b{batch_n}_token_positions_per_sec_per_chip": res["tokens_per_s"],
                          "step_ms": res["step_ms"], "peak_gib": res["peak"], "device_busy": res["busy"],
                          "card": card}))
        out[batch_n] = res
        del state, lm, opt
        torch.cuda.empty_cache()
    return out


class Decisions:
    """Within the block, MAS's path (``module.maximum_path_auto``) and, for
    VQ-TTS, the grouped bottleneck's codes (the ``min`` of its distance
    table) come from a recorded step: with ``record`` set the path and codes
    are recorded, else the recorded ones are answered. A bf16 step's
    log-prior and encodings round an ulp apart from fp64's, and near a tie
    the argmax / argmin flips; the comparison holds the rest of the step at
    one set of decisions (as phase 35 holds gradients at the kernel's own
    relu decisions)."""

    def __init__(self, module, bottleneck=None):
        self.module, self.bottleneck = module, bottleneck
        self.path = self.codes = None
        self.record = True

    def __enter__(self):
        inner = mas_ops.maximum_path_auto
        outer = self

        def path(value, mask):
            if outer.record:
                outer.path = inner(value, mask).cpu()
            return outer.path.to(value.device)
        if self.module is None:  # a model without such decisions (the LM)
            return self
        self.saved = self.module.maximum_path_auto
        self.module.maximum_path_auto = path
        if self.bottleneck is not None:
            class Torch:
                def __getattr__(self, name):
                    return getattr(torch, name)

                def min(self, distance, dim):
                    if outer.record:
                        outer.codes = torch.min(distance, dim=dim)[1].cpu()
                    codes = outer.codes.to(distance.device)
                    return distance.gather(dim, codes[:, None])[:, 0], codes
            self.saved_torch = self.bottleneck.torch
            self.bottleneck.torch = Torch()
        return self

    def __exit__(self, *exc):
        if self.module is None:
            return
        self.module.maximum_path_auto = self.saved
        if self.bottleneck is not None:
            self.bottleneck.torch = self.saved_torch


def sgd_updates(first, batch: dict, device, names: tuple, decisions: Decisions) -> dict:
    """name -> update of one SGD step from ``first``'s parameters: "cpu64"
    (fp64 on the CPU, run first: its decisions are recorded), "cuda" (the
    card's bf16 step), "cpu" (the CPU's bf16 step, the plain versions)."""
    start = {k: p.detach().cpu().double() for k, p in first.named_parameters()}
    out = {}
    for name in names:
        model = copy.deepcopy(first).to("cpu" if name.startswith("cpu") else device)
        if name == "cpu64":
            model = model.double()
        dev = next(model.parameters()).device
        b = {k: (v.double() if name == "cpu64" and v.is_floating_point() else v).to(dev) for k, v in batch.items()}
        opt, schedule = build_optimizer(model.parameters(), BF16_SGD)
        state = TrainState.create(model, opt, use_ema=False)
        step = harness.make_train_step_for({"train": {"bf16": name != "cpu64"}}, schedule, 0.9)
        decisions.record = name == "cpu64"
        with decisions:
            scalars = step(state, b, TRAIN_SEED)
        out[name] = ({k: float(v) for k, v in scalars.items()},
                     {k: p.detach().cpu().double() - start[k] for k, p in model.named_parameters()})
        del model, state, opt
    return out


def phase_bf16_vs_fp64(device, card: str, kind: str, vq_state: Optional[dict] = None) -> dict:
    """One SGD step (dropout 0) of Glow-TTS (``kind`` "glow", or "glow_b6" on
    the flow-step route: GLOW_VS_CPU sequences of the mel batch), the
    Transformer LM ("lm": LM_SUBSET tokens, the codec of ``vq_state``
    frozen) or VQ-TTS ("vqtts", "vqtts_b5": 2 sequences of VQTTS_SAMPLES,
    the log-magnitude STFT term off: with it any bf16 update is 0.2-1 of its
    own norm from fp64's, PERF.md) on the card in bf16, on the CPU in bf16
    (the plain versions) and in fp64, at the fp64 step's MAS path (and
    codes): the card's update within BF16_LIN_MULTIPLE of the CPU bf16
    step's distance from fp64's by median, all and worst parameter, and the
    control (the card's update x BF16_CONTROL_SCALE) failing it. A
    parameter's distance is over its fp64 update's norm floored at 1e-4 of
    the whole update's (phase 25's floor)."""
    tag = f"[bf16 {kind} vs fp64]"
    if kind in ("glow", "glow_b6"):
        first = build_glow(device, GLOW_SEED + 5, flow_step=kind == "glow_b6")
        set_dropout(first, 0.0)
        full = glow_mel_batch(first, GLOW_BATCH, device, seed=35)
        batch = {k: v[:GLOW_VS_CPU] for k, v in full.items()}
        decisions = Decisions(glow_model_module)
    elif kind == "lm":
        first = build_lm(device, vq_state, seed=LM_SEED + 3, dropout=0.0)
        batch = lm_tokens(*LM_SUBSET, seed=51, device="cpu")
        decisions = Decisions(None)
    else:
        first = build_vqtts(device, VQTTS_SEED + 3, kind == "vqtts_b5", p_dropout=0.0, revival_threshold=0.0,
                            loss={**configs.VQTTS_TPU["loss"], "log": False})
        first.text_encoder.p_dropout = 0.0
        if first.text_encoder.pre is not None:
            first.text_encoder.pre.P_DROPOUT = 0.0
        for m in first.quant_decoder.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        full = vqtts_batch(VQTTS_BATCH, VQTTS_SAMPLES, device, seed=44)
        batch = {k: v[:2] for k, v in full.items()}
        decisions = Decisions(vqtts_model, vqtts_bottleneck)
        with torch.no_grad():  # the lazy codebook init, once, from the card's fp32 forward
            first.supervised_step(batch, train=True, generators={
                "device_dropout": torch.Generator(device=device).manual_seed(1),
                "dropout": torch.Generator().manual_seed(1),
                "codebook": torch.Generator(device=device).manual_seed(1)})
    first = first.cpu()
    batch = {k: v.cpu() for k, v in batch.items()}
    ups = sgd_updates(first, batch, device, ("cpu64", "cuda", "cpu"), decisions)
    mask = harness.frozen_param_mask(first) or {}
    ref = {k: r for k, r in ups["cpu64"][1].items() if mask.get(k, True)}  # the LM's frozen codec moves nowhere
    # per parameter over a norm floored at 1e-4 of the whole update's: the key biases' true gradients are
    # zero (the softmax ignores them), so their fp64 updates are rounding alone
    floor = 1e-4 * torch.sqrt(sum((r ** 2).sum() for r in ref.values())).item()

    def distance(update: dict) -> tuple:
        per = {k: (update[k] - r).norm().item() / max(r.norm().item(), floor) for k, r in ref.items()}
        worst = max(per, key=per.get)
        return statistics.median(per.values()), (worst, per[worst]), update_distance(update, ref)[2]

    errs = {n: distance(ups[n][1]) for n in ("cuda", "cpu")}
    control = distance({k: BF16_CONTROL_SCALE * v for k, v in ups["cuda"][1].items()})

    def ratios(d: tuple) -> tuple:
        return d[0] / errs["cpu"][0], d[2] / errs["cpu"][2], d[1][1] / errs["cpu"][1][1]

    card_r, control_r = ratios(errs["cuda"]), ratios(control)
    print(f"{tag} losses: card bf16 {ups['cuda'][0]}; cpu bf16 {ups['cpu'][0]}; cpu fp64 {ups['cpu64'][0]}")
    print(f"{tag} updates against fp64's, relative L2 (median parameter, all, worst; floored): card bf16 "
          f"{errs['cuda'][0]:.3e} {errs['cuda'][2]:.3e} {errs['cuda'][1]}; cpu bf16 {errs['cpu'][0]:.3e} "
          f"{errs['cpu'][2]:.3e} {errs['cpu'][1]}; card / cpu {card_r[0]:.3f} / {card_r[1]:.3f} / {card_r[2]:.3f} "
          f"(within {BF16_LIN_MULTIPLE}); control x{BF16_CONTROL_SCALE} {control_r[0]:.3f} / {control_r[1]:.3f} / "
          f"{control_r[2]:.3f} (must exceed it) [{card}]")
    for key in ("loss",):
        rel = abs(ups["cuda"][0][key] - ups["cpu"][0][key]) / max(abs(ups["cpu"][0][key]), 1e-12)
        require(rel <= BF16_LOSS_RTOL, f"{tag}: the card's bf16 {key} is {rel} from the CPU's")
    require(all(r <= BF16_LIN_MULTIPLE for r in card_r), f"{tag}: card / cpu {card_r}")
    require(any(r > BF16_LIN_MULTIPLE for r in control_r), f"{tag}: the control passes: {control_r}")
    return {"card_ratio": card_r, "control_ratio": control_r}


def bf16_updates(device, seed: int, log_stft: bool, names: tuple) -> dict:
    """name -> (scalars, update) of one SGD step from one start on a 2 x 11008
    subset (dropout 0, revival off): "cuda" the card's bf16 step, "cuda_fp32"
    the card's fp32 step, "cpu" the CPU's bf16 step (plain path), "cpu64" the
    CPU's step in fp64. SGD, so an update is lr times the gradient."""
    batch_n, samples = BF16_SUBSET
    cfg = {**copy.deepcopy(configs.VQVAE_TPU), "p_dropout": 0.0, "revival_threshold": 0.0, "zero_out": False}
    cfg["loss"] = {**cfg["loss"], "log": log_stft}
    audio, _ = audio_batch(BATCH, SAMPLES, seed=seed)
    other, _ = audio_batch(BATCH, SAMPLES, seed=5)
    x = audio[:batch_n, :samples].contiguous()
    n = torch.tensor([samples, samples - 2005])
    first = harness.get_model({"model": cfg}, device=device)
    harness.init_model_variables(first, {"audio": other[:batch_n, :samples], "audio_len": n}, seed=TRAIN_SEED + 1)
    start = {k: p.detach().cpu().double() for k, p in first.named_parameters()}
    out = {}
    for name in names:
        model = copy.deepcopy(first).to("cpu" if name.startswith("cpu") else device)
        if name == "cpu64":
            model = model.double()
        dev = next(model.parameters()).device
        xx = x.double() if name == "cpu64" else x
        opt, schedule = build_optimizer(model.parameters(), BF16_SGD)
        state = TrainState.create(model, opt, use_ema=False)
        step = harness.make_train_step_for({"train": {"bf16": name in ("cuda", "cpu")}}, schedule,
                                           default_mu(batch_n, 1))
        scalars = step(state, {"audio": xx.to(dev), "audio_len": n.to(dev)}, TRAIN_SEED)
        out[name] = ({k: float(v) for k, v in scalars.items()},
                     {k: p.detach().cpu().double() - start[k] for k, p in model.named_parameters()})
        del model, state, opt
    return out


def update_distance(update: dict, ref: dict) -> tuple:
    """(median over parameters, (worst parameter, its value), all parameters
    at once) of the relative L2 distance of ``update`` from ``ref``."""
    per = {k: ((update[k] - r).norm() / max(r.norm().item(), 1e-30)).item() for k, r in ref.items()}
    worst = max(per, key=per.get)
    total = (torch.sqrt(sum(((update[k] - r) ** 2).sum() for k, r in ref.items()))
             / torch.sqrt(sum((r ** 2).sum() for r in ref.values()))).item()
    return statistics.median(per.values()), (worst, per[worst]), total


def bf16_vs_cpu(device, seed: int) -> dict:
    """Phase 37's readings at one data seed (also ``bf16_seeds.py``'s):
    the steps' scalars, each bf16 update's distance from fp64's with the
    model's loss ("full") and without its log-magnitude term ("lin"), the
    card / CPU ratios and the control's without it, and the card's bf16
    update against the CPU's."""
    full = bf16_updates(device, seed, True, ("cuda", "cpu", "cpu64"))
    errs = {name: update_distance(full[name][1], full["cpu64"][1]) for name in ("cuda", "cpu")}
    scalars = {f"full_{k}": v[0] for k, v in full.items()}
    del full
    lin = bf16_updates(device, seed, False, ("cuda", "cuda_fp32", "cpu", "cpu64"))
    ref = lin["cpu64"][1]
    cond = {name: update_distance(lin[name][1], ref) for name in ("cuda", "cpu", "cuda_fp32")}
    control = update_distance({k: BF16_CONTROL_SCALE * v for k, v in lin["cuda"][1].items()}, ref)
    direct = update_distance(lin["cuda"][1], lin["cpu"][1])

    def ratios(d: tuple) -> tuple:
        """(median, all parameters, worst parameter) over the CPU bf16 step's."""
        return d[0] / cond["cpu"][0], d[2] / cond["cpu"][2], d[1][1] / cond["cpu"][1][1]

    return {"scalars": {**scalars, **{f"lin_{k}": v[0] for k, v in lin.items()}}, "full": errs,
            "full_ratio": (errs["cuda"][0] / errs["cpu"][0], errs["cuda"][2] / errs["cpu"][2]), "lin": cond,
            "lin_ratio": ratios(cond["cuda"]), "control_ratio": ratios(control), "direct": direct,
            "direct_ratio": ratios(direct)}


def phase_bf16_train_vs_cpu(device, card: str) -> dict:
    """The card's bf16 train step against the CPU's, one SGD step each on a
    2 x 11008 subset, dropout 0, revival off, each held against the same
    step in fp64 on the CPU.

    (1) The model's loss: the card's error within BF16_VS_CPU_MULTIPLE of the
    CPU's. Its log-magnitude STFT term makes this a weak check: the gradient
    weighs each STFT bin by 1/|Y|, a bf16 waveform's small bins are mostly
    rounding, so a bf16 update is 0.2-1 of its own norm from fp64's.
    (2) So the same steps again without the log term, where a bf16 update is
    4-9% from fp64's and an fp32 one 1e-4: the card's error within
    BF16_LIN_MULTIPLE of the CPU's by median, all parameters and worst
    parameter; and a control that must fail it, the card's update made
    BF16_CONTROL_SCALE times too large. Printed, no claim: the card's bf16
    update against the CPU's. The two share their rounding points, yet
    through the codec's depth an ulp's difference spreads until they are
    about as far apart as either is from fp64 (0.3-2x over data seeds), so
    that distance cannot hold the card.
    """
    r = bf16_vs_cpu(device, BF16_DATA_SEED)
    sc, errs, cond = r["scalars"], r["full"], r["lin"]
    print(f"[bf16 vs cpu] {BF16_SUBSET[0]} x {BF16_SUBSET[1]}, data seed {BF16_DATA_SEED}, p_dropout 0, revival off, SGD: losses "
          f"card bf16 {sc['full_cuda']}; cpu bf16 {sc['full_cpu']}; cpu fp64 {sc['full_cpu64']}")
    print(f"[bf16 vs cpu] (1) the model's loss: each bf16 step's update against the fp64 step's, relative L2: card "
          f"median {errs['cuda'][0]:.3e}, all parameters {errs['cuda'][2]:.3e}; cpu bf16 median {errs['cpu'][0]:.3e}, "
          f"all {errs['cpu'][2]:.3e}; card / cpu {r['full_ratio'][0]:.3f} and {r['full_ratio'][1]:.3f} (tol "
          f"{BF16_VS_CPU_MULTIPLE}) [{card}]")
    print(f"[bf16 vs cpu] (2) without the log-magnitude term: losses card bf16 {sc['lin_cuda']['loss']!r}, cpu bf16 "
          f"{sc['lin_cpu']['loss']!r}, card fp32 {sc['lin_cuda_fp32']['loss']!r}, cpu fp64 {sc['lin_cpu64']['loss']!r}; "
          f"updates against fp64's, median / all / worst parameter: card bf16 {cond['cuda'][0]:.3e} / "
          f"{cond['cuda'][2]:.3e} / {cond['cuda'][1][0]} {cond['cuda'][1][1]:.3e}, cpu bf16 {cond['cpu'][0]:.3e} / "
          f"{cond['cpu'][2]:.3e} / {cond['cpu'][1][0]} {cond['cpu'][1][1]:.3e}, card fp32 {cond['cuda_fp32'][0]:.3e} / "
          f"{cond['cuda_fp32'][2]:.3e} [{card}]")
    card_r, control_r, direct_r = r["lin_ratio"], r["control_ratio"], r["direct_ratio"]
    print(f"[bf16 vs cpu] (2) card / cpu: median {card_r[0]:.3f}, all {card_r[1]:.3f}, worst {card_r[2]:.3f} (tol "
          f"{BF16_LIN_MULTIPLE}); control, the card's update x {BF16_CONTROL_SCALE}: {control_r[0]:.3f}, "
          f"{control_r[1]:.3f}, {control_r[2]:.3f} (must fail); no claim: the card's bf16 update against the cpu's "
          f"bf16 update, over the cpu's own error {direct_r[0]:.3f}, {direct_r[1]:.3f}, {direct_r[2]:.3f} [{card}]")
    for step in ("full", "lin"):
        for key in ("loss", "loss_recon", "loss_stft", "loss_commit"):
            g_, c_ = sc[f"{step}_cuda"][key], sc[f"{step}_cpu"][key]
            require(abs(g_ - c_) <= BF16_LOSS_RTOL * abs(c_), f"bf16 train step ({step}) {key}: card {g_} cpu {c_}")
    for i, what in enumerate(("median", "all parameters")):
        require(r["full_ratio"][i] <= BF16_VS_CPU_MULTIPLE,
                f"bf16 step error against fp64 ({what}): card {errs['cuda']} vs cpu {errs['cpu']}")
    require(max(card_r) <= BF16_LIN_MULTIPLE,
            f"bf16 step error against fp64 without the log term: card / cpu {card_r} > {BF16_LIN_MULTIPLE}")
    require(max(control_r) > BF16_LIN_MULTIPLE, f"the control passes the bf16 step's limit: {control_r}")
    return r


CLI_CLIPS = 42                 # 10 val, 32 train: 4 steps an epoch at batch 8
CLI_SECONDS = (2.0, 6.0)
CLI_BATCH = 8
CLI_SEED = 31
CLI_RECHECK = 2                # clips whose codes are encoded again on the CPU


def all_counts() -> dict:
    """Every kernel wrapper's launches so far, by the kernels line's names."""
    fns = {"gated_hifi_fwd": gh.gated_hifi, "gated_hifi_bwd": gh.backward_buffers,
           "gated_hifi_wgrad": gh.weight_grad_reduce, "attention_fwd": att.fused_attention,
           "attention_bwd": att.attention_backward, "wn_coupling_fwd": wn_ops.wn_coupling,
           "wn_coupling_bwd": wn_ops.wn_coupling_backward, "enc_layer_fwd": enc_ops.enc_layer,
           "enc_layer_bwd": enc_ops.enc_layer_backward, "flow_step_fwd": fs_ops.flow_step,
           "flow_step_bwd": fs_ops.flow_step_backward}
    counts = {"mas": mas_ops.maximum_path_auto.launches}
    for name, fn in fns.items():
        counts[name] = fn.launches
        counts[name + "_bf16"] = fn.bf16_launches
    return counts


def zero_all_counts() -> None:
    zero_glow_bf16_counts()
    zero_b1_counts()
    for fn in (att.fused_attention, att.attention_backward):
        fn.launches = fn.bf16_launches = 0


class LogLines(logging.Handler):
    """Collects the CLI's log records (and echoes the epoch, checkpoint and restore lines)."""

    NAMES = ("train", "generate_vq_dataset", "speech_masters_thesis_tpu_torch")

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        line = record.getMessage()
        self.lines.append(line)
        if line.startswith(("epoch", "Restored", "Saved", "Wrote", "metadata", "Loaded", "Reached")):
            print(f"[cli log] {line}")

    def __enter__(self):
        for name in self.NAMES:
            logging.getLogger(name).addHandler(self)
            logging.getLogger(name).setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            logging.getLogger(name).removeHandler(self)


def cli_run(tag: str, argv: list, card: str, expect: tuple, logs: LogLines) -> dict:
    """One in-process run of scripts/train.py's main: wall time, steps, the
    median step (each step synced before and after, on the host clock),
    peak memory, and the launches of the run; every kernel in ``expect``
    must have launched."""
    times = []
    factory = harness.make_train_step_for

    def timed_factory(config, schedule, mu):
        step = factory(config, schedule, mu)

        def timed(state, batch, seed):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, batch, seed)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            return out
        return timed

    zero_all_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    first = len(logs.lines)
    t0 = time.perf_counter()
    harness.make_train_step_for = timed_factory
    try:
        state = train_cli.main(argv)
    finally:
        harness.make_train_step_for = factory
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in all_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[cli {tag}] wall {wall:.3f} s, {len(times)} train steps, median step {statistics.median(times):.3f} ms "
          f"(steps {', '.join(f'{t:.1f}' for t in times)}), peak {peak:.3f} GiB, launches {counts} [{card}]")
    missing = [k for k in expect if not counts.get(k)]
    require(not missing, f"{tag}: the run launched no {missing}")
    return {"state": state, "wall_s": wall, "steps": len(times), "step_ms": statistics.median(times), "peak": peak,
            "counts": counts, "log": logs.lines[first:]}


def scalars_ok(log_dir: str, tag: str) -> dict:
    """The run's train and val losses are logged and finite; returns the last of each."""
    rows = read_scalars(log_dir)
    last = {}
    for row in rows:
        require(np.isfinite(row["value"]), f"{tag}: {row} is not finite")
        last[row["tag"]] = row["value"]
    require("loss/train_loss" in last and "loss/val_loss" in last, f"{tag}: losses missing from scalars.jsonl")
    return last


def phase_cli_pipeline(device, card: str) -> dict:
    """The user's workflow through the port's own entry points (module docstring's last paragraph)."""
    out = {}
    codec_cfg = configs.MODELS["vqvae_tpu"]["model"]
    with tempfile.TemporaryDirectory() as root, LogLines() as logs:
        corpus, cmudict = os.path.join(root, "LJSpeech-1.1"), os.path.join(root, "cmudict.dict")
        write_corpus(corpus, cmudict, n=CLI_CLIPS, min_sec=CLI_SECONDS[0], max_sec=CLI_SECONDS[1], seed=CLI_SEED)

        def dataset_json(name: str, section: dict) -> str:
            path = os.path.join(root, f"{name}.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump({"dataset": section}, f)
            return path

        lj = dataset_json("ljspeech", dict(configs.LJSPEECH, dataset_path=corpus, cmudict_path=cmudict))
        common = ["--batch_size", str(CLI_BATCH), "--seed", str(CLI_SEED), "--eval_every_n_epochs", "1",
                  "--log_every_n_steps", "2"]

        # the codec
        vq_dir = os.path.join(root, "vqvae")
        codec = cli_run("codec", ["--model", "vqvae_tpu", "--dataset", lj, "--log_dir", vq_dir, "--bf16", "--ema",
                                  "--total_epochs", "2", "--ckpt_every_n_steps", "4", *common], card,
                        ("gated_hifi_fwd", "gated_hifi_fwd_bf16", "gated_hifi_bwd_bf16", "gated_hifi_wgrad_bf16"),
                        logs)
        for name in ("ckpts/ckpt.4", "ckpts/ckpt.last", "config.json", "scalars.jsonl",
                     "audio/val_audio_1_gt.wav", "audio/val_audio_2_pred.wav", "spect/val_spect_2.npy"):
            require(os.path.exists(os.path.join(vq_dir, name)), f"codec: {name} missing")
        losses = scalars_ok(vq_dir, "codec")
        at4 = checkpoint.load_payload(checkpoint.ckpt_dir(vq_dir, 4))
        last = checkpoint.load_payload(checkpoint.ckpt_dir(vq_dir, "last"))
        params = [n for n, _ in codec["state"].model.named_parameters()]
        still = [n for n in params if torch.equal(at4["model"][n], last["model"][n])]
        still += [f"ema {n}" for n in params if torch.equal(at4["ema"][n], last["ema"][n])]
        still += [f"codebook {n}" for n in at4["codebook"] if "initialized" not in n
                  and torch.equal(at4["codebook"][n], last["codebook"][n])]
        print(f"[cli codec] step {last['step']}: train loss {losses['loss/train_loss']:.6g}, val loss "
              f"{losses['loss/val_loss']:.6g}; {len(params)} parameters, their EMA and the codebook moved between "
              f"ckpt.4 and ckpt.last except {still} [{card}]")
        require(last["step"] == 8 and not still, f"codec: step {last['step']}, unmoved {still}")
        del codec["state"]
        out["codec"] = codec

        # a resume from ckpt.4: restored at step 4 (restore raises on a missing or unexpected key), it
        # reruns epoch 0 (the loader restarts at seed + 0) to step 8; that a restored state equals the
        # live one bit for bit is tests/test_torch_checkpoint.py's, on the CPU
        resume_dir = os.path.join(root, "vqvae_resume")
        resume = cli_run("resume", ["--model", "vqvae_tpu", "--dataset", lj, "--log_dir", resume_dir, "--bf16",
                                    "--ema", "--total_epochs", "2", "--ckpt_every_n_steps", "4", "--load_ckpt",
                                    os.path.join(vq_dir, "ckpts", "ckpt.4"), "--max_steps", "6", *common],
                         card, ("gated_hifi_fwd_bf16", "gated_hifi_bwd_bf16", "gated_hifi_wgrad_bf16"), logs)
        logged = [line for line in resume["log"] if line.startswith("Restored checkpoint") and "at step 4 " in line]
        resumed = checkpoint.load_payload(checkpoint.ckpt_dir(resume_dir, "last"))
        still = [n for n in params if torch.equal(at4["model"][n], resumed["model"][n])]
        resume_losses = scalars_ok(resume_dir, "resume")
        print(f"[cli resume] {logged}; {resume['steps']} steps to ckpt.last at step {resumed['step']}, schedule "
              f"step {resumed['sched']}; train loss {resume_losses['loss/train_loss']:.6g}; parameters unmoved from "
              f"ckpt.4: {still} [{card}]")
        require(logged, "resume: no restore at step 4")
        require(resume["steps"] == 4 and resumed["step"] == resumed["sched"] == 8 and not still,
                f"resume: {resume['steps']} steps, step {resumed['step']}, schedule {resumed['sched']}, unmoved {still}")
        del resume["state"]
        out["resume"] = resume

        # the tokenizer on the codec's last checkpoint
        tokens = os.path.join(root, "VQ-Latent")
        zero_all_counts()
        t0 = time.perf_counter()
        metadata = generate_vq_dataset.main(["--log_dir", vq_dir, "--ckpt_num", "last", "--save_path", tokens,
                                             "--batch_size", str(CLI_BATCH)])
        torch.cuda.synchronize()
        tok_wall = time.perf_counter() - t0
        tok_counts = {k: v for k, v in all_counts().items() if v}
        factor = compression_factor(codec_cfg)
        expect_meta = {"compression_factor": factor, "vocab_size": codec_cfg["l_bins"]}
        with open(os.path.join(tokens, "metadata.json"), encoding="utf-8") as f:
            require(json.load(f) == expect_meta == metadata, f"tokenize: metadata {metadata}")
        require(tok_counts.get("gated_hifi_fwd", 0) > 0, "tokenize: no GatedHiFi launch")
        vq_config = load_config(os.path.join(vq_dir, "config.json"))
        vq_config.dataset.segment_length = -1
        cpu_model = harness.get_model(vq_config, device="cpu")
        harness.elide_features(vq_config, cpu_model)
        pickles = {}
        for split, n_clips in (("train", CLI_CLIPS - 10), ("val", 10)):
            files = sorted(os.listdir(os.path.join(tokens, split)))
            require(len(files) == n_clips, f"tokenize: {len(files)} {split} pickles")
            data = LJSpeech(vq_config, split)
            for i, name in enumerate(files):
                with open(os.path.join(tokens, split, name), "rb") as f:
                    item = pickle.load(f)
                audio = data[i]["audio"]
                require(np.array_equal(item["x"], audio) and len(item["q"]) == len(audio) // factor,
                        f"tokenize: {split} pickle {i} differs from the loader's clip")
                pickles[(split, i)] = item
        checkpoint.load_model_state(cpu_model, checkpoint.restore_model_state(checkpoint.ckpt_dir(vq_dir, "last")))
        cpu_model.eval()
        shortest = sorted((k for k in pickles if k[0] == "train"), key=lambda k: len(pickles[k]["x"]))[:CLI_RECHECK]
        agree, frames, gaps = 0, 0, []
        with torch.inference_mode():
            for key in shortest:
                x = torch.from_numpy(pickles[key]["x"])[None]
                q = torch.tensor(pickles[key]["q"])
                mask = torch.ones_like(x)
                codes_c, _ = cpu_model.encode(x, mask)
                h, _ = cpu_model.encoders[0](x[..., None], mask[..., None])
                dist = cpu_model.bottleneck.level_blocks[0]._distances(h[0])
                agree += int((codes_c[0] == q).sum())
                frames += q.numel()
                for t in (codes_c[0] != q).nonzero().flatten().tolist():
                    gaps.append(((dist[t, q[t]] - dist[t, codes_c[0, t]]).item(), 1e-4 * (h[0, t] ** 2).sum().item() + 1e-6))
        share = agree / frames
        print(f"[cli tokenize] wall {tok_wall:.3f} s, {CLI_CLIPS} pickles (train {CLI_CLIPS - 10}, val 10), metadata "
              f"{metadata}, launches {tok_counts}; {CLI_RECHECK} clips encoded again on the CPU: codes agree on "
              f"{share:.6f} of {frames} frames (need {CODE_AGREEMENT}), mismatch gaps {gaps} [{card}]")
        require(share >= CODE_AGREEMENT, f"tokenize: codes agree on {share}")
        require(all(gap <= tol for gap, tol in gaps), f"tokenize: a code mismatch is no near-tie: {gaps}")
        out["tokenize"] = {"wall_s": tok_wall, "counts": tok_counts}

        # the LM on the tokens, through the codec grafted from ckpt.last
        lm_json = os.path.join(root, "transformer_lm.json")
        lm_cfg = copy.deepcopy(configs.MODELS["transformer_lm_tpu"])
        lm_cfg["model"]["vqvae"] = {"log_dir": vq_dir, "ckpt_num": "last"}
        with open(lm_json, "w", encoding="utf-8") as f:
            json.dump(lm_cfg, f)
        vql = dataset_json("vqlatent", dict(configs.VQLATENT, dataset_path=tokens))
        lm_dir = os.path.join(root, "lm")
        lm = cli_run("lm", ["--model", lm_json, "--dataset", vql, "--log_dir", lm_dir, "--bf16", "--ema",
                            "--total_epochs", "1", *common], card,
                     ("attention_fwd", "attention_fwd_bf16", "attention_bwd_bf16", "gated_hifi_fwd"), logs)
        decoder = {f"decoders.0.{k[len('vqvae_decoder.'):]}": v for k, v in lm["state"].model.state_dict().items()
                   if k.startswith("vqvae_decoder.")}
        grafted = all(torch.equal(v.cpu(), last["model"][k]) for k, v in decoder.items()) and torch.equal(
            lm["state"].model.vqvae_bottleneck.k.cpu(), last["model"]["bottleneck.level_blocks.0.k"])
        lm_losses = scalars_ok(lm_dir, "lm")
        print(f"[cli lm] the frozen codec ({len(decoder)} decoder tensors and the codebook) equals the codec's "
              f"ckpt.last: {grafted}; train loss {lm_losses['loss/train_loss']:.6g}, val loss "
              f"{lm_losses['loss/val_loss']:.6g} [{card}]")
        require(grafted and len(decoder) > 0, "lm: the frozen codec is not the codec's ckpt.last")
        require(os.path.exists(checkpoint.ckpt_dir(lm_dir, "last")), "lm: ckpt.last missing")
        del lm["state"]
        out["lm"] = lm

        # Glow-TTS with DDI
        glow_json = os.path.join(root, "glow_tts.json")
        glow_cfg = copy.deepcopy(configs.MODELS["glow_tts_tpu"])
        glow_cfg["model"]["ddi"] = True
        with open(glow_json, "w", encoding="utf-8") as f:
            json.dump(glow_cfg, f)
        lj_tpu = dataset_json("ljspeech_tpu", dict(configs.LJSPEECH_TPU, dataset_path=corpus, cmudict_path=cmudict))
        glow_dir = os.path.join(root, "glow")
        glow = cli_run("glow", ["--model", glow_json, "--dataset", lj_tpu, "--log_dir", glow_dir, "--bf16",
                                "--total_epochs", "1", *common], card,
                       ("enc_layer_fwd_bf16", "enc_layer_bwd_bf16", "wn_coupling_fwd", "wn_coupling_bwd", "mas",
                        "enc_layer_fwd"), logs)
        at0 = checkpoint.load_payload(checkpoint.ckpt_dir(glow_dir, 0))
        actnorms = [k for k in at0["model"] if k.startswith("decoder.") and k.endswith((".logs", ".bias"))
                    and at0["model"][k].dim() == 3 and at0["model"][k].shape[0] == 1]
        zero = [k for k in actnorms if not bool(at0["model"][k].abs().sum() > 0)]
        glow_losses = scalars_ok(glow_dir, "glow")
        wav = os.path.join(glow_dir, "audio", "val_audio_1_pred.wav")
        print(f"[cli glow] DDI then ckpt.0 (step {at0['step']}): {len(actnorms)} ActNorm tensors, zero {zero}; "
              f"train loss {glow_losses['loss/train_loss']:.6g}, val loss {glow_losses['loss/val_loss']:.6g}; "
              f"Griffin-Lim val wav {os.path.exists(wav)} [{card}]")
        require(at0["step"] == 0 and actnorms and not zero, "glow: ckpt.0 holds no DDI'd ActNorm")
        require(os.path.exists(wav) and os.path.exists(checkpoint.ckpt_dir(glow_dir, "last")), "glow: files missing")
        del glow["state"]
        out["glow"] = glow
    totals = {}
    for run in out.values():
        for k, v in run["counts"].items():
            totals[k] = totals.get(k, 0) + v
    print(f"[cli] runs (wall s, train steps, median step ms, peak GiB): "
          f"{ {k: (round(v['wall_s'], 3), v.get('steps'), v.get('step_ms'), v.get('peak')) for k, v in out.items()} }; "
          f"launches over the runs {totals} [{card}]")
    return totals


def main() -> None:
    t0 = time.perf_counter()
    card = phase_device()
    device = cuda_device()
    phase_build()
    kernel = phase_kernel(device, card, BLOCK_TS, BATCH)
    model = build_model(device, *audio_batch(BATCH, SAMPLES, seed=5))
    audio, lengths = audio_batch(BATCH, SAMPLES, seed=4)
    inference_launches, decode_launches = phase_slice(model, device, audio, lengths, card)
    phase_vs_cpu(model, device, audio)
    phase_timing(model, device, audio, lengths, card)
    vq_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}  # the LM's codec
    del model
    backward = phase_backward(device, card, BLOCK_TS, BATCH)
    dropout_err = phase_dropout(device, card)
    train = phase_train(device, card)
    phase_train_vs_cpu(device, card)
    attention = phase_attention(device, card)
    phase_attention_dropout(device, card)
    lm = phase_lm_train(device, card, vq_state)
    phase_lm_val(lm.pop("state"), device, card, decode_launches)
    phase_lm_sample(lm.pop("model"), device, card, decode_launches)
    torch.cuda.empty_cache()
    phase_lm_vs_cpu(device, card, vq_state)

    glow = build_glow(device, GLOW_SEED)
    b3 = phase_wn_coupling(glow, device, card)
    b5 = phase_enc_layer(glow, device, card)
    b4 = phase_mas(device, card)
    val = phase_glow_val(glow, device, card)
    synthesis = phase_synthesis(glow, device, card)
    phase_glow_vs_cpu(glow, val["batch"], device, card)
    glow_launches = tuple(a + b for a, b in zip(val["launches"], synthesis["launches"]))
    b3_bwd = phase_wn_coupling_bwd(glow, device, card)
    b5_bwd = phase_enc_layer_bwd(glow, device, card)
    del glow, val, synthesis
    torch.cuda.empty_cache()
    glow_train = phase_glow_train(device, card)
    phase_glow_train_vs_cpu(device, card)
    b5_fwd_n, b5_bwd_n, b3_fwd_n, b3_bwd_n, b4_n, _, _ = glow_train["launches"]
    torch.cuda.empty_cache()

    glow = build_glow(device, GLOW_SEED, flow_step=True)
    b6 = phase_flow_step(glow, device, card)
    del glow
    torch.cuda.empty_cache()
    glow_train_b6 = phase_glow_train(device, card, flow_step=True)
    route_rel = abs(glow_train_b6["loss1"] - glow_train["loss1"]) / abs(glow_train["loss1"])
    print(f"[glow train A/B] {GLOW_TRAIN_STEPS} steps each, the same model seed, batch and dropout draws; median "
          f"of steps {GLOW_STEADY_FROM}-{GLOW_TRAIN_STEPS}: B3 route {glow_train['step_ms']:.3f} ms = "
          f"{glow_train['frames_per_s']:.1f} mel-frames/s, peak {glow_train['peak']:.3f} GiB; B6 route "
          f"{glow_train_b6['step_ms']:.3f} ms = {glow_train_b6['frames_per_s']:.1f} mel-frames/s, peak "
          f"{glow_train_b6['peak']:.3f} GiB; B6 / B3 step time {glow_train_b6['step_ms'] / glow_train['step_ms']:.4f}; "
          f"step 1 loss B3 {glow_train['loss1']} B6 {glow_train_b6['loss1']} (relative {route_rel:.2e}, tol "
          f"{ROUTE_LOSS_RTOL:g}) [{card}]")
    require(route_rel <= ROUTE_LOSS_RTOL, f"step 1's loss differs between the routes: {route_rel}")
    turns = steps_in_turns({"B3": glow_train.pop("step"), "B6": glow_train_b6.pop("step")}, GLOW_AB_ROUNDS)
    medians = {n: statistics.median(t) for n, t in turns.items()}
    print(f"[glow train A/B] then {GLOW_AB_ROUNDS} more steps of each, in turns (B3, B6, B6, B3, ...): step ms B3 "
          f"{', '.join(f'{t:.3f}' for t in turns['B3'])}; B6 {', '.join(f'{t:.3f}' for t in turns['B6'])}; median "
          f"B3 {medians['B3']:.3f} ms = {GLOW_BATCH * GLOW_FRAMES / (medians['B3'] / 1e3):.1f} mel-frames/s, B6 "
          f"{medians['B6']:.3f} ms = {GLOW_BATCH * GLOW_FRAMES / (medians['B6'] / 1e3):.1f} mel-frames/s; B6 / B3 "
          f"{medians['B6'] / medians['B3']:.4f} [{card}]")
    del glow_train["model"]
    val_b6 = phase_glow_val(glow_train_b6.pop("model"), device, card, expect=(6, 12, 1, 12))
    del val_b6["state"], val_b6["batch"]
    torch.cuda.empty_cache()
    phase_glow_train_vs_cpu(device, card, flow_step=True)
    b6_fwd_n = glow_train_b6["launches"][5] + val_b6["launches"][3]
    b6_bwd_n = glow_train_b6["launches"][6]

    torch.cuda.empty_cache()

    vq_blocks = phase_vqtts_blocks(device, card)
    torch.cuda.empty_cache()
    vq_train = phase_vqtts_train(device, card)
    vq_train_b5 = phase_vqtts_train(device, card, fused_encoder=True)
    turns = steps_in_turns({"config": vq_train.pop("step"), "B5": vq_train_b5.pop("step")}, VQTTS_AB_ROUNDS)
    medians = {n: statistics.median(t) for n, t in turns.items()}
    seconds = VQTTS_BATCH * VQTTS_SAMPLES / configs.LJSPEECH_TPU["sample_rate"]
    print(f"[vqtts train A/B] median of steps {VQTTS_STEADY_FROM}-{VQTTS_STEPS}: the config's encoder route "
          f"(fused_encoder: false, the plain layer) {vq_train['step_ms']:.3f} ms = {vq_train['audio_s_per_s']:.2f} "
          f"audio seconds/s, peak {vq_train['peak']:.3f} GiB; B5's route {vq_train_b5['step_ms']:.3f} ms = "
          f"{vq_train_b5['audio_s_per_s']:.2f}, peak {vq_train_b5['peak']:.3f} GiB; then {VQTTS_AB_ROUNDS} more steps "
          f"of each in turns: config {', '.join(f'{t:.3f}' for t in turns['config'])}; B5 "
          f"{', '.join(f'{t:.3f}' for t in turns['B5'])}; median config {medians['config']:.3f} ms = "
          f"{seconds / (medians['config'] / 1e3):.2f} audio seconds/s, B5 {medians['B5']:.3f} ms = "
          f"{seconds / (medians['B5'] / 1e3):.2f}; B5 / config {medians['B5'] / medians['config']:.4f} [{card}]")
    del vq_train_b5["state"], vq_train_b5["batch"]
    vq_val = phase_vqtts_val(vq_train.pop("state"), vq_train.pop("batch"), card)
    torch.cuda.empty_cache()
    phase_vqtts_train_vs_cpu(device, card)
    phase_vqtts_train_vs_cpu(device, card, fused_encoder=True)
    torch.cuda.empty_cache()

    bf16_truncates = phase_bf16_mma(device, card)
    wgmma_truncates = phase_wgmma(device, card)
    bf16_fwd = phase_bf16_kernel(device, card)
    bf16_bwd = phase_bf16_backward(device, card)
    bf16_train = phase_bf16_train(device, card)
    torch.cuda.empty_cache()
    phase_bf16_train_vs_cpu(device, card)
    torch.cuda.empty_cache()

    # the bf16 modes of B3 and B5, Glow-TTS's and VQ-TTS's bf16 train steps
    glow = build_glow(device, GLOW_SEED)
    b3_bf16 = phase_bf16_wn_coupling(glow, device, card)
    b5_bf16 = phase_bf16_enc_layer(glow, device, card)
    del glow
    torch.cuda.empty_cache()
    vq_fwd_bf16 = phase_bf16_kernel(device, card, VQTTS_BLOCK_TS, VQTTS_BATCH, VQTTS_DEPTH, "[bf16 kernel vqtts]")
    vq_bwd_bf16 = phase_bf16_backward(device, card, VQTTS_BLOCK_TS, VQTTS_BATCH, VQTTS_DEPTH,
                                      "[bf16 backward vqtts]")
    torch.cuda.empty_cache()
    glow_bf16 = phase_bf16_glow_train(device, card)
    torch.cuda.empty_cache()
    vq_bf16 = phase_bf16_vqtts_train(device, card, fused_encoder=False)
    vq_bf16_b5 = phase_bf16_vqtts_train(device, card, fused_encoder=True)
    torch.cuda.empty_cache()
    for kind in ("glow", "vqtts", "vqtts_b5"):
        phase_bf16_vs_fp64(device, card, kind)
        torch.cuda.empty_cache()

    # the bf16 modes of B6 and B2, Glow-TTS's bf16 step on the flow-step route and the LM's bf16 step
    glow = build_glow(device, GLOW_SEED, flow_step=True)
    b6_bf16 = phase_bf16_flow_step(glow, device, card)
    del glow
    torch.cuda.empty_cache()
    b2_bf16 = phase_bf16_attention(device, card)
    glow_bf16_b6 = phase_bf16_glow_train(device, card, flow_step=True)
    torch.cuda.empty_cache()
    lm_bf16 = phase_bf16_lm_train(device, card, vq_state)
    torch.cuda.empty_cache()
    for kind in ("glow_b6", "lm"):
        phase_bf16_vs_fp64(device, card, kind, vq_state)
        torch.cuda.empty_cache()

    cli = phase_cli_pipeline(device, card)
    torch.cuda.empty_cache()

    print(f"[launches] inference path {inference_launches} forward; training path {train['fwd']} "
          f"forward, {train['bwd']} backward tile passes, {train['red']} reductions; LM training "
          f"path {lm['fwd']} attention forward, {lm['bwd']} attention backward; Glow-TTS val step and "
          f"one synthesis call (B5, B3, B4, B6) {glow_launches}; Glow-TTS training path (B5 fwd, B5 bwd, "
          f"B3 fwd, B3 bwd, B4, B6 fwd, B6 bwd) {glow_train['launches']}; on the B6 route "
          f"{glow_train_b6['launches']} and one val step {val_b6['launches']}; VQ-TTS training path (B1 fwd, B1 bwd, "
          f"B1 red, B4, B5 fwd, B5 bwd) {vq_train['launches']}, on B5's encoder route {vq_train_b5['launches']}, one "
          f"val step {vq_val['launches']}; the bf16 training path (bf16 fwd, bwd, red) "
          f"{(bf16_train['fwd'], bf16_train['bwd'], bf16_train['red'])}; the bf16 Glow-TTS training path (fp32 B5 fwd, "
          f"bwd, B3 fwd, bwd, bf16 B5 fwd, bwd, B3 fwd, bwd, B4, fp32 B6 fwd, bwd, bf16 B6 fwd, bwd) "
          f"{glow_bf16['launches']}; the bf16 VQ-TTS training "
          f"path (fp32 B1 fwd, bwd, red, bf16 B1 fwd, bwd, red, B4, fp32 B5 fwd, bwd, bf16 B5 fwd, bwd) "
          f"{vq_bf16['launches']}, on B5's encoder route {vq_bf16_b5['launches']}; the bf16 Glow-TTS training path on "
          f"the B6 route (the same counts) {glow_bf16_b6['launches']}; the bf16 LM "
          f"training path (fp32 B2 fwd, bwd, bf16 B2 fwd, bwd) {lm_bf16['launches']}")

    def at_vqtts(kernel: dict, **extra) -> dict:
        return {"shapes": f"{len(VQTTS_BLOCK_TS)} block shapes, B={VQTTS_BATCH}, depth {VQTTS_DEPTH}, summed",
                **{k: kernel[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, **extra}

    vq_fwd, vq_bwd = vq_blocks["fwd"], vq_blocks["bwd"]
    vq_b1_bf16 = {n: vq_bf16["launches"][i] + vq_bf16_b5["launches"][i] for n, i in (("fwd", 3), ("bwd", 4), ("red", 5))}
    vqtts_bf16 = {
        "fwd": {"launches": vq_b1_bf16["fwd"], "at_vqtts": at_vqtts(vq_fwd_bf16, max_abs_err=vq_fwd_bf16["max_abs_err"],
                                                                     ulp_share=vq_fwd_bf16["share"])},
        "bwd": {"launches": vq_b1_bf16["bwd"], "at_vqtts": at_vqtts(vq_bwd_bf16, max_abs_err=vq_bwd_bf16["dx_err"])},
        "red": {"launches": vq_b1_bf16["red"], "at_vqtts": dict(
            shapes=f"{len(VQTTS_BLOCK_TS)} block shapes, B={VQTTS_BATCH}, depth {VQTTS_DEPTH}, summed",
            ms=vq_bwd_bf16["red_ms"], plain_ms=vq_bwd_bf16["red_plain_ms"], bound_ms=vq_bwd_bf16["red_bound_ms"],
            bound_by=vq_bwd_bf16["red_bound_by"], library_ms=vq_bwd_bf16["red_library_ms"],
            max_abs_err=vq_bwd_bf16["red_err"])}}
    glow_b5_bf16 = glow_bf16["launches"][4] + vq_bf16_b5["launches"][9]
    glow_b5_bwd_bf16 = glow_bf16["launches"][5] + vq_bf16_b5["launches"][10]
    vqtts_b1 = {"launches": vq_train["launches"][0], "launches_b5_route": vq_train_b5["launches"][0],
                "launches_val_step": vq_val["launches"][0],
                "at_vqtts": at_vqtts(vq_fwd, max_abs_err=max(vq_fwd["max_abs_err"], vq_blocks["fwd_drop_err"]),
                                     bound_3xtf32_ms=vq_fwd["tf32_ms"])}
    vqtts_bwd = {"launches": vq_train["launches"][1], "launches_b5_route": vq_train_b5["launches"][1],
                 "at_vqtts": at_vqtts(vq_bwd, max_abs_err=vq_bwd["dx_err"], bound_3xtf32_ms=vq_bwd["tf32_ms"])}
    vqtts_red = {"launches": vq_train["launches"][2], "launches_b5_route": vq_train_b5["launches"][2],
                 "at_vqtts": dict(shapes=vqtts_bwd["at_vqtts"]["shapes"], ms=vq_bwd["red_ms"],
                                  plain_ms=vq_bwd["red_plain_ms"], bound_ms=vq_bwd["red_bound_ms"],
                                  bound_by=vq_bwd["red_bound_by"], library_ms=vq_bwd["red_library_ms"],
                                  max_abs_err=vq_bwd["red_err"], bound_3xtf32_ms=vq_bwd["red_tf32_ms"])}

    print(f"[chip_smoke] every phase passed in {time.perf_counter() - t0:.1f} s [{card}]")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound_ms, bound_by, library_ms=None, **extra):
        return {"name": name, "route": "cuda", "source": SOURCE_DIR + source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, **extra}

    kernels = [
        entry("gated_hifi_fwd", "gated_hifi_fwd.cu", PALLAS + ":591", train["fwd"],
              max(kernel["max_abs_err"], dropout_err), kernel["ms"], kernel["plain_ms"], kernel["bound_ms"],
              kernel["bound_by"], call_ms=kernel["call_ms"], bound_3xtf32_ms=kernel["tf32_ms"], vqtts=vqtts_b1),
        entry("gated_hifi_bwd", "gated_hifi_bwd.cu", PALLAS + ":612", train["bwd"], backward["dx_err"],
              backward["ms"], backward["plain_ms"], backward["bound_ms"], backward["bound_by"],
              call_ms=backward["tiles_call_ms"], bound_3xtf32_ms=backward["tf32_ms"], vqtts=vqtts_bwd),
        entry("gated_hifi_wgrad", "gated_hifi_bwd.cu", PALLAS + ":360", train["red"], backward["red_err"],
              backward["red_ms"], backward["red_plain_ms"], backward["red_bound_ms"], backward["red_bound_by"],
              backward["red_library_ms"], call_ms=backward["red_call_ms"], bound_3xtf32_ms=backward["red_tf32_ms"],
              vqtts=vqtts_red),
        entry("gated_hifi_fwd_bf16", "gated_hifi_fwd_bf16.cu", PALLAS + ":591", bf16_train["fwd"], bf16_fwd["max_abs_err"],
              bf16_fwd["ms"], bf16_fwd["plain_ms"], bf16_fwd["bound_ms"], bf16_fwd["bound_by"],
              call_ms=bf16_fwd["call_ms"], ulp_share=bf16_fwd["share"], mma_truncates=bf16_truncates,
              vqtts=vqtts_bf16["fwd"]),
        entry("gated_hifi_bwd_bf16", "gated_hifi_bwd_bf16.cu", PALLAS + ":612", bf16_train["bwd"],
              bf16_bwd["dx_err"], bf16_bwd["ms"], bf16_bwd["plain_ms"], bf16_bwd["bound_ms"], bf16_bwd["bound_by"],
              call_ms=bf16_bwd["call_ms"], ulp_share=bf16_bwd["share"],
              bound_with_buffers_ms=bf16_bwd["bound_buffers_ms"], vqtts=vqtts_bf16["bwd"]),
        entry("gated_hifi_wgrad_bf16", "gated_hifi_bwd_bf16.cu", PALLAS + ":360", bf16_train["red"],
              bf16_bwd["red_err"], bf16_bwd["red_ms"], bf16_bwd["red_plain_ms"], bf16_bwd["red_bound_ms"],
              bf16_bwd["red_bound_by"], bf16_bwd["red_library_ms"], call_ms=bf16_bwd["red_call_ms"],
              bound_with_buffers_ms=bf16_bwd["red_bound_buffers_ms"], wgmma_truncates=wgmma_truncates,
              vqtts=vqtts_bf16["red"]),
        entry("attention_fwd", "attention_fwd.cu", PALLAS_ATTENTION + ":226", lm["fwd"], attention["fwd_err"],
              attention["fwd_dev"], attention["fwd_plain_ms"], *attention["bound"], attention["sdpa_dev"],
              ms_p0=attention["fwd_dev_p0"], call_ms=attention["fwd_ms"], bound_3xtf32_ms=attention["tf32"],
              at_64x258=dict(attention["b64"], library_ms=attention["b64_sdpa_dev"])),
        entry("attention_bwd", "attention_bwd.cu", PALLAS_ATTENTION + ":253", lm["bwd"], attention["bwd_err"],
              attention["bwd_dev"], attention["bwd_plain_ms"], *attention["bwd_bound"], attention["sdpa_bwd_dev"],
              ms_p0=attention["bwd_dev_p0"], call_ms=attention["bwd_ms"], bound_3xtf32_ms=attention["bwd_tf32"]),
        entry("wn_coupling_fwd", "wn_coupling_fwd.cu", PALLAS_WN + ":442", glow_launches[1] + b3_fwd_n,
              b3["max_abs_err"], b3["ms"], b3["plain_ms"], b3["bound_ms"], b3["bound_by"], call_ms=b3["call_ms"],
              bound_3xtf32_ms=b3["tf32_ms"]),
        entry("wn_coupling_bwd", "wn_coupling_bwd.cu", PALLAS_WN + ":484", b3_bwd_n, b3_bwd["max_abs_err"],
              b3_bwd["ms"], b3_bwd["plain_ms"], b3_bwd["bound_ms"], b3_bwd["bound_by"],
              call_ms=b3_bwd["call_ms"], bound_3xtf32_ms=b3_bwd["tf32_ms"]),
        entry("mas", "mas.cu", PALLAS_MAS + ":123", glow_launches[2] + b4_n, b4["max_abs_err"], b4["ms"],
              b4["plain_ms"], b4["bound_ms"], b4["bound_by"], call_ms=b4["call_ms"],
              ns_per_frame=b4["ns_per_frame"], vqtts={"launches": vq_train["launches"][3],
                                                      "launches_b5_route": vq_train_b5["launches"][3],
                                                      "launches_val_step": vq_val["launches"][3]}),
        entry("enc_layer_fwd", "enc_layer_fwd.cu", PALLAS_ENC + ":470", glow_launches[0] + b5_fwd_n,
              b5["max_abs_err"], b5["ms"], b5["plain_ms"], b5["bound_ms"], b5["bound_by"], call_ms=b5["call_ms"],
              bound_3xtf32_ms=b5["tf32_ms"], vqtts={"launches_b5_route": vq_train_b5["launches"][4]}),
        entry("enc_layer_bwd", "enc_layer_bwd.cu", PALLAS_ENC + ":496", b5_bwd_n, b5_bwd["max_abs_err"],
              b5_bwd["ms"], b5_bwd["plain_ms"], b5_bwd["bound_ms"], b5_bwd["bound_by"],
              call_ms=b5_bwd["call_ms"], bound_3xtf32_ms=b5_bwd["tf32_ms"],
              vqtts={"launches_b5_route": vq_train_b5["launches"][5]}),
        entry("wn_coupling_fwd_bf16", "wn_coupling_bf16.cu", PALLAS_WN + ":442", glow_bf16["launches"][6],
              b3_bf16["fwd"]["max_abs_err"], b3_bf16["fwd"]["ms"], b3_bf16["fwd"]["plain_ms"],
              b3_bf16["fwd"]["bound_ms"], b3_bf16["fwd"]["bound_by"], call_ms=b3_bf16["fwd"]["call_ms"],
              sources=[SOURCE_DIR + s for s in WN16_SOURCES], launch_kinds=b3_bf16["fwd"]["kinds"]),
        entry("wn_coupling_bwd_bf16", "wn_coupling_bf16.cu", PALLAS_WN + ":484", glow_bf16["launches"][7],
              b3_bf16["bwd"]["max_abs_err"], b3_bf16["bwd"]["ms"], b3_bf16["bwd"]["plain_ms"],
              b3_bf16["bwd"]["bound_ms"], b3_bf16["bwd"]["bound_by"], call_ms=b3_bf16["bwd"]["call_ms"],
              sources=[SOURCE_DIR + s for s in WN16_SOURCES]),
        entry("enc_layer_fwd_bf16", "enc_layer_bf16.cu", PALLAS_ENC + ":470", glow_b5_bf16,
              b5_bf16["fwd"]["max_abs_err"], b5_bf16["fwd"]["ms"], b5_bf16["fwd"]["plain_ms"],
              b5_bf16["fwd"]["bound_ms"], b5_bf16["fwd"]["bound_by"], call_ms=b5_bf16["fwd"]["call_ms"],
              sources=[SOURCE_DIR + s for s in ENC16_SOURCES], launch_kinds=b5_bf16["fwd"]["kinds"],
              vqtts={"launches_b5_route": vq_bf16_b5["launches"][9]}),
        entry("enc_layer_bwd_bf16", "enc_layer_bf16.cu", PALLAS_ENC + ":496", glow_b5_bwd_bf16,
              b5_bf16["bwd"]["max_abs_err"], b5_bf16["bwd"]["ms"], b5_bf16["bwd"]["plain_ms"],
              b5_bf16["bwd"]["bound_ms"], b5_bf16["bwd"]["bound_by"], call_ms=b5_bf16["bwd"]["call_ms"],
              sources=[SOURCE_DIR + s for s in ENC16_SOURCES],
              launch_kinds=b5_bf16["bwd"]["kinds"],
              vqtts={"launches_b5_route": vq_bf16_b5["launches"][10]}),
        entry("flow_step_fwd", "flow_step_fwd.cu", PALLAS_WN + ":521", b6_fwd_n, b6["fwd_err"], b6["fwd_ms"],
              b6["fwd_plain_ms"], b6["fwd_bound_ms"], b6["fwd_bound_by"], call_ms=b6["fwd_call_ms"],
              bound_3xtf32_ms=b6["fwd_tf32_ms"]),
        entry("flow_step_bwd", "flow_step_bwd.cu", PALLAS_WN + ":569", b6_bwd_n, b6["max_abs_err"], b6["ms"],
              b6["plain_ms"], b6["bound_ms"], b6["bound_by"], call_ms=b6["call_ms"],
              bound_3xtf32_ms=b6["tf32_ms"]),
        entry("flow_step_fwd_bf16", "wn_coupling_bf16.cu", PALLAS_WN + ":521", glow_bf16_b6["launches"][11],
              b6_bf16["fwd"]["max_abs_err"], b6_bf16["fwd"]["ms"], b6_bf16["fwd"]["plain_ms"],
              b6_bf16["fwd"]["bound_ms"], b6_bf16["fwd"]["bound_by"], call_ms=b6_bf16["fwd"]["call_ms"],
              sources=[SOURCE_DIR + s for s in WN16_SOURCES], launch_kinds=b6_bf16["fwd"]["kinds"]),
        entry("flow_step_bwd_bf16", "wn_coupling_bf16.cu", PALLAS_WN + ":569", glow_bf16_b6["launches"][12],
              b6_bf16["bwd"]["max_abs_err"], b6_bf16["bwd"]["ms"], b6_bf16["bwd"]["plain_ms"],
              b6_bf16["bwd"]["bound_ms"], b6_bf16["bwd"]["bound_by"], call_ms=b6_bf16["bwd"]["call_ms"],
              sources=[SOURCE_DIR + s for s in WN16_SOURCES]),
        entry("attention_fwd_bf16", "attention_bf16.cu", PALLAS_ATTENTION + ":226", lm_bf16["launches"][2],
              b2_bf16["fwd_err"], b2_bf16["fwd_dev"], b2_bf16["fwd_plain_ms"], *b2_bf16["bound"], b2_bf16["sdpa_dev"],
              ms_p0=b2_bf16["fwd_dev_p0"], call_ms=b2_bf16["fwd_ms"], sources=[SOURCE_DIR + s for s in B2_BF16_SOURCES],
              **({"launch_kinds": b2_bf16["fwd_kinds"]} if b2_bf16["fwd_kinds"] is not None else {}),
              **{at: {k: v for k, v in shape.items() if not k.startswith("bwd_")} for at, shape in b2_bf16.items()
                 if at.startswith("at_")}),
        entry("attention_bwd_bf16", "attention_bf16.cu", PALLAS_ATTENTION + ":253", lm_bf16["launches"][3],
              b2_bf16["bwd_err"], b2_bf16["bwd_dev"], b2_bf16["bwd_plain_ms"], *b2_bf16["bwd_bound"],
              b2_bf16["sdpa_bwd_dev"], ms_p0=b2_bf16["bwd_dev_p0"], call_ms=b2_bf16["bwd_ms"],
              sources=[SOURCE_DIR + s for s in B2_BF16_SOURCES],
              **({"launch_kinds": b2_bf16["bwd_kinds"]} if b2_bf16["bwd_kinds"] is not None else {}),
              **{at: {k[4:]: v for k, v in shape.items() if k.startswith("bwd_")} for at, shape in b2_bf16.items()
                 if at.startswith("at_")})]
    for k in kernels:
        k["cli_launches"] = cli.get(k["name"], 0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
