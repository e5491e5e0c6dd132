#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the VQ-VAE codec's inference path (configs.VQVAE_TPU, full published
width, random seeded weights) through the entry points a user calls, with
every kernel built from csrc/ in this checkout:

  1. device: torch/CUDA versions, the card's name and power limit;
  2. build: nvcc for sm_90a, with ptxas's register and shared-memory report;
  3. each GatedHiFi block shape of the path (batch 16, W=64), kernel against
     its plain PyTorch version in fp32 (TF32 off), with both times;
  4. the slice at batch 16 x 66048 samples: encode, decode and the eval
     forward, counting kernel launches (7 per encode, 7 per decode, 14 per
     forward);
  5. the same model on the CPU (plain path) on a 2 x 22016 subset: codes,
     reconstruction and losses;
  6. encode + decode wall time at batch 16 x 66048.

Every phase raises on failure, so the script exits non-zero; there is no CPU
fallback. The line before the last is the kernels' JSON summary; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.device import cuda_device
from speech_masters_thesis_tpu_torch.models.vqvae.blocks import GatedHiFiBlock
from speech_masters_thesis_tpu_torch.models.vqvae.model import compression_factor
from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops import gated_hifi as gh
from speech_masters_thesis_tpu_torch.utils.registry import get_model

BATCH = 16
SAMPLES = 66048                # 3 s at 22.05 kHz, a multiple of 128
BLOCK_TS = [33024, 16512, 8256, 4128, 2064, 1032, 516]  # every block length on the path
SUBSET = (2, 22016)            # the CPU comparison's batch and samples
KERNEL_RTOL = 1e-4             # of max|ref|: fp32, but another summation order
RECON_RTOL = 1e-4              # of max|y|: 14 blocks and 16 convs, fp32, TF32 off
LOSS_RTOL = 1e-4
CODE_AGREEMENT = 0.999
SOURCE = "speech_masters_thesis_tpu_torch/csrc/gated_hifi_fwd.cu"
REPLACES = "speech_masters_thesis_tpu/ops/pallas/gated_hifi.py:591"


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


def phase_build() -> None:
    t0 = time.perf_counter()
    report = _build.compile_library(_build.library_path())
    _build.build()
    ptxas = [line.strip() for line in report.splitlines()
             if "registers" in line or "spill" in line or "smem" in line]
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} -> {_build.library_path().name} "
          f"in {time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(ptxas)}")


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


def phase_slice(model, device, audio, lengths, card: str) -> int:
    """encode -> decode and the eval forward on the card; returns the launches."""
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
    return launches


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


def main() -> None:
    card = phase_device()
    device = cuda_device()
    phase_build()
    kernel = phase_kernel(device, card, BLOCK_TS, BATCH)
    model = build_model(device, *audio_batch(BATCH, SAMPLES, seed=5))
    audio, lengths = audio_batch(BATCH, SAMPLES, seed=4)
    launches = phase_slice(model, device, audio, lengths, card)
    phase_vs_cpu(model, device, audio)
    phase_timing(model, device, audio, lengths, card)
    print(json.dumps({"kernels": [{
        "name": "gated_hifi_fwd", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches, **kernel}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
