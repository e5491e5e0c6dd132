#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the VQ-VAE codec's inference path and its training step
(configs.VQVAE_TPU, full published width, random seeded weights) through
the entry points a user calls, with every kernel built from csrc/ in this
checkout:

  1. device: torch/CUDA versions, the card's name and power limit;
  2. build: nvcc for sm_90a, one process per source, with ptxas's register
     and shared-memory report;
  3. each GatedHiFi block shape of the path (batch 16, W=64), forward kernel
     against its plain PyTorch version in fp32 (TF32 off), with both times;
  4. the inference path at batch 16 x 66048 samples: encode, decode and the
     eval forward, counting kernel launches (7 per encode, 7 per decode, 14
     per forward);
  5. the same model on the CPU (plain path) on a 2 x 22016 subset: codes,
     reconstruction and losses;
  6. encode + decode wall time at batch 16 x 66048;
  7. each block shape, backward kernels (tile passes and weight-gradient
     reduction) against plain autograd, at p=0 and at p=0.1: dx and every
     weight gradient, two calls bitwise equal, both times;
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
     backward calls bitwise equal, both times; the kernel's dropout masks
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

Every phase raises on failure, so the script exits non-zero; there is no CPU
fallback. The line before the last is the kernels' JSON summary; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.device import cuda_device
from speech_masters_thesis_tpu_torch.models.ema import default_mu
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
from speech_masters_thesis_tpu_torch.ops import gated_hifi as gh
from speech_masters_thesis_tpu_torch.train import harness
from speech_masters_thesis_tpu_torch.train.loop import make_train_step, make_val_step, raise_if_not_finite
from speech_masters_thesis_tpu_torch.train.optim import build_optimizer
from speech_masters_thesis_tpu_torch.train.state import TrainState
from speech_masters_thesis_tpu_torch.utils.registry import get_model

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


def phase_device() -> str:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False: this script needs a GPU")
    cuda_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)} count {torch.cuda.device_count()}")
    print(card)
    return card


KERNEL_NAMES = ("attention_fwd_kernel", "attention_bwd_dq_kernel", "attention_bwd_dkdv_kernel",
                "gated_hifi_fwd_kernel", "bwd_recompute_kernel", "bwd_transpose_kernel",
                "wgrad_partial_kernel", "wgrad_reduce_kernel")


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


def phase_kernel(device: torch.device, card: str, block_ts, batch: int) -> dict:
    """Kernel against its plain version at each block shape of the path."""
    block = GatedHiFiBlock(64, 4, dilation_growth_rate=3, kernel_size_growth_rate=2, zero_out=True)
    randomize(block, seed=1)
    block.to(device)
    w = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    max_err, ms_total, plain_total = 0.0, 0.0, 0.0
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
            print(f"[kernel] B={batch} T={T} W=64: max_abs_err {err:.3e} (tol {tol:.3e} = "
                  f"{KERNEL_RTOL:g} * max|ref| {scale:.3e}), exact zeros past lens {zeros}; "
                  f"kernel {ms:.3f} ms, plain {plain:.3f} ms (median of 10) [{card}]")
            require(np.isfinite(err) and err <= tol, f"kernel disagrees at T={T}: {err} > {tol}")
            require(zeros, f"kernel output not zero past lens at T={T}")
            max_err = max(max_err, err)
            ms_total += ms
            plain_total += plain
    print(f"[kernel] sum over the {len(block_ts)} block shapes: kernel {ms_total:.3f} ms, "
          f"plain {plain_total:.3f} ms [{card}]")
    return {"max_abs_err": max_err, "ms": ms_total, "plain_ms": plain_total}


def build_model(device: torch.device, audio: torch.Tensor, lengths: torch.Tensor):
    """The vqvae_tpu codec with seeded weights; the codebook is 512 seeded
    draws (with replacement) of valid encoder outputs of ``audio`` plus
    0.01/sqrt(C) noise, as the JAX package's first-batch init does. The
    batches encoded later are other audio, so codes are not self-matches."""
    model = get_model(copy.deepcopy(configs.VQVAE_TPU))
    randomize(model, seed=2)
    model.to(device).eval()
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
          f"{statistics.median(times):.3f} ms of {len(times)} ({', '.join(f'{t:.3f}' for t in times)}) "
          f"[{card}]")


def block_weights(device: torch.device, seed: int) -> gh.GatedHiFiWeights:
    """Packed weights of a vqvae_tpu-width block (W=64, depth 4), all seeded."""
    block = GatedHiFiBlock(64, 4, dilation_growth_rate=3, kernel_size_growth_rate=2, zero_out=True)
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


def phase_backward(device, card: str, block_ts, batch: int) -> dict:
    """Backward kernels against plain autograd at each block shape, p=0 and p=0.1."""
    w = block_weights(device, seed=1)
    seed = 12345
    out = {"dx_err": 0.0, "red_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "red_ms": 0.0, "red_plain_ms": 0.0}
    for p in (0.0, P_DROP):
        sums = {"bwd": 0.0, "plain": 0.0, "tiles": 0.0, "tiles_plain": 0.0, "red": 0.0, "red_plain": 0.0}
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
            }
            for key, ms in times.items():
                sums[key] += ms
            print(f"[backward] p={p} B={batch} T={T}: relu/dropout decisions flipped against the "
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
                  f"{times['red_plain']:.3f} (median of 5) [{card}]")
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
        print(f"[backward] p={p} sums over the {len(block_ts)} block shapes: backward kernels "
              f"{sums['bwd']:.3f} ms vs plain autograd {sums['plain']:.3f} ms; tile passes "
              f"{sums['tiles']:.3f} vs {sums['tiles_plain']:.3f} ms; reduction {sums['red']:.3f} vs "
              f"{sums['red_plain']:.3f} ms [{card}]")
        if p == P_DROP:  # the training configuration
            out.update(ms=sums["tiles"], plain_ms=sums["tiles_plain"], red_ms=sums["red"],
                       red_plain_ms=sums["red_plain"])
    return out


def phase_dropout(device, card: str) -> float:
    """The dropout law on the card; returns the train-mode forward's error."""
    T, batch, seed = 4128, 16, 777
    x, lens, valid, g = block_inputs(T, batch, 400, device)
    # expand and conv biases of 10 (conv weights scaled down) make z > 0 and
    # c > 0 everywhere, so the kernel's a > 0 and h1 > 0 exactly where kept
    block = GatedHiFiBlock(64, 4, dilation_growth_rate=3, kernel_size_growth_rate=2, zero_out=True)
    randomize(block, seed=7)
    with torch.no_grad():
        for d in range(4):
            block.blocks[d][0].bias.fill_(10.0)
            block.blocks[d][1].model[2].weight.mul_(0.01)
            block.blocks[d][1].model[2].bias.fill_(10.0)
        block.to(device)
        w = gh.pack_weights(dict(block.named_parameters()), block.dilations)
        _, plain = gh.backward_buffers(x, lens, w, g, 1.0, 0.0, seed)
        require(bool((plain.a > 0).all()) and bool((plain.h1 > 0).all()),
                "the dropout probe's expands and convs are not all positive")
        _, bufs = gh.backward_buffers(x, lens, w, g, 1.0, P_DROP, seed)
        _, again = gh.backward_buffers(x, lens, w, g, 1.0, P_DROP, seed)
        _, other = gh.backward_buffers(x, lens, w, g, 1.0, P_DROP, seed + 1)
        H = 128
        keep = 1.0 - gh.keep_threshold(P_DROP) / 65536.0
        n0 = n1 = n01 = 0
        for d in range(4):
            k0 = bufs.a[..., d * H:(d + 1) * H] > 0
            k1 = bufs.h1[..., d * H:(d + 1) * H] > 0
            m0, m1 = gh.branch_masks(seed, batch, d, 0, T, H, P_DROP, device)
            require(torch.equal(k0, m0 > 0) and torch.equal(k1, m1 > 0),
                    f"branch {d}: the kernel's masks differ from the plain version's")
            n0 += int(k0.sum())
            n1 += int(k1.sum())
            n01 += int((k0 & k1).sum())
        n = batch * T * H * 4
        rates = {"site 0": (n0 / n, keep), "site 1": (n1 / n, keep), "both": (n01 / n, keep * keep)}
        same = torch.equal(bufs.a, again.a) and torch.equal(bufs.h1, again.h1)
        changed = ((bufs.a > 0) != (other.a > 0)).float().mean().item()
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
    model = harness.get_model({"model": copy.deepcopy(configs.VQVAE_TPU)}).to(device)
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
    models = {"cuda": harness.get_model({"model": cfg}).to(device)}
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


def kernel_keep_mask(B: int, T: int, lens: torch.Tensor, seed: torch.Tensor, device) -> torch.Tensor:
    """The forward kernel's dropout decisions [B, H, T, T] at p=P_DROP, read
    back through its output: with q = k = 0 every valid key of row r has
    probability 1/n_r exactly (n_r = min(r + 1, len_b)), and with v one-hot
    over a window of D keys, o[b, r, h, d] * n_r * (1 - p) is 1 where the
    kernel kept key c0 + d and 0 where it dropped it."""
    H, D = ATTN_HEADS, ATTN_DIM
    zeros = torch.zeros(B, T, H, D, device=device)
    n = torch.minimum(torch.arange(1, T + 1, device=device)[None, :], lens[:, None].long())
    keep = torch.zeros(B, H, T, T, dtype=torch.bool, device=device)
    for c0 in range(0, T, D):
        w = min(D, T - c0)
        v = torch.zeros(B, T, H, D, device=device)
        v[:, c0:c0 + w, :, :w] = torch.eye(w, device=device)[None, :, None, :]
        o = att.fused_attention(zeros, zeros, v, lens, seed, 1.0, P_DROP)
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


def phase_attention(device, card: str) -> dict:
    """Forward and recompute backward kernels against their plain versions.

    The kernel's gradients come through autograd (``FusedAttentionFunction``,
    whose backward launches both kernels of attention_bwd.cu), the plain
    ones through autograd of ``attention_reference``; times are of those two
    backward passes (CUDA events, median of 10, each with a retained graph).
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
            torch.cuda.synchronize()
            fwd_scale = ref.abs().max().item()
            fwd_err = (o - ref).abs().max().item()
            errs = {name: ((a - b).abs().max().item(), b.abs().max().item())
                    for name, a, b in zip(("dq", "dk", "dv"), heads(grads), heads(grads_ref))}
            bitwise = torch.equal(grads, again)
            with torch.no_grad():
                args = (*heads(packed), lens, seed, scale, p)
                times = {"fwd": cuda_ms(lambda: att.fused_attention(*args)),
                         "fwd_plain": cuda_ms(lambda: att.attention_reference(*args))}
            times["bwd"] = cuda_ms(lambda: torch.autograd.grad(o, qkv, g, retain_graph=True))
            times["bwd_plain"] = cuda_ms(lambda: torch.autograd.grad(ref, qkv_ref, g, retain_graph=True))
            print(f"[attention] B={B} T={T} H={ATTN_HEADS} D={ATTN_DIM} p={p}: forward max_abs_err "
                  f"{fwd_err:.3e} (tol {ATTN_FWD_RTOL * fwd_scale:.3e}); " + ", ".join(
                      f"{k} {e:.3e} (tol {ATTN_GRAD_RTOL * s_:.3e})" for k, (e, s_) in errs.items())
                  + f"; two backward calls bitwise equal {bitwise}; ms: forward kernel "
                  f"{times['fwd']:.4f} vs plain {times['fwd_plain']:.4f}, backward kernels "
                  f"{times['bwd']:.4f} vs plain autograd {times['bwd_plain']:.4f} (median of 10) [{card}]")
            require(np.isfinite(fwd_err) and fwd_err <= ATTN_FWD_RTOL * fwd_scale,
                    f"attention forward differs at B={B} T={T} p={p}: {fwd_err}")
            for name, (err, s_) in errs.items():
                require(np.isfinite(err) and err <= ATTN_GRAD_RTOL * s_,
                        f"attention {name} differs at B={B} T={T} p={p}: {err} > {ATTN_GRAD_RTOL} * {s_}")
            require(bitwise, f"two attention backward calls differ at B={B} T={T} p={p}")
            out["fwd_err"] = max(out["fwd_err"], fwd_err)
            out["bwd_err"] = max(out["bwd_err"], max(e for e, _ in errs.values()))
            if (B, T) == ATTN_SHAPES[0] and p == P_DROP:  # the LM's training call
                out.update(fwd_ms=times["fwd"], fwd_plain_ms=times["fwd_plain"],
                           bwd_ms=times["bwd"], bwd_plain_ms=times["bwd_plain"])
            del o, ref, grads, again, grads_ref, qkv, qkv_ref
            torch.cuda.empty_cache()
    return out


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
    lm = harness.get_model({"model": cfg}, vqvae_model_config=configs.VQVAE_TPU)
    harness.init_model_variables(lm, None, seed=seed)
    load_vqvae_into_lm(lm, vq_state)
    return lm.to(device)


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


def main() -> None:
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
    print(f"[launches] inference path {inference_launches} forward; training path {train['fwd']} "
          f"forward, {train['bwd']} backward tile passes, {train['red']} reductions; LM training "
          f"path {lm['fwd']} attention forward, {lm['bwd']} attention backward")
    print(json.dumps({"kernels": [
        {"name": "gated_hifi_fwd", "route": "cuda", "source": SOURCE_DIR + "gated_hifi_fwd.cu",
         "replaces": PALLAS + ":591", "launches": train["fwd"],
         "max_abs_err": max(kernel["max_abs_err"], dropout_err), "ms": kernel["ms"],
         "plain_ms": kernel["plain_ms"]},
        {"name": "gated_hifi_bwd", "route": "cuda", "source": SOURCE_DIR + "gated_hifi_bwd.cu",
         "replaces": PALLAS + ":612", "launches": train["bwd"], "max_abs_err": backward["dx_err"],
         "ms": backward["ms"], "plain_ms": backward["plain_ms"]},
        {"name": "gated_hifi_wgrad", "route": "cuda", "source": SOURCE_DIR + "gated_hifi_bwd.cu",
         "replaces": PALLAS + ":360", "launches": train["red"], "max_abs_err": backward["red_err"],
         "ms": backward["red_ms"], "plain_ms": backward["red_plain_ms"]},
        {"name": "attention_fwd", "route": "cuda", "source": SOURCE_DIR + "attention_fwd.cu",
         "replaces": PALLAS_ATTENTION + ":226", "launches": lm["fwd"],
         "max_abs_err": attention["fwd_err"], "ms": attention["fwd_ms"],
         "plain_ms": attention["fwd_plain_ms"]},
        {"name": "attention_bwd", "route": "cuda", "source": SOURCE_DIR + "attention_bwd.cu",
         "replaces": PALLAS_ATTENTION + ":253", "launches": lm["bwd"],
         "max_abs_err": attention["bwd_err"], "ms": attention["bwd_ms"],
         "plain_ms": attention["bwd_plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
