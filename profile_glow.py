#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's Glow-TTS paths on one GPU.

    python3 profile_glow.py

Builds the kernels, then the Glow-TTS of chip_smoke.py (GLOW_TTS_TPU width,
seeded weights), and runs torch.profiler over 3 calls each of: the train step
(dropout on, AdamW + Noam, parameter EMA) on the conditioner-only route (B3)
and on the whole-flow-step route (B6, fused_flow_step: true), and the val
step at batch 8 x 768 frames and 256 tokens, and synthesize_ids at batch 1 and 8 (100-256 tokens,
max_frames 1024, 32 Griffin-Lim iterations). For each it
prints the wall time per call, the device's busy share (the sum of kernel
times over the wall time; one stream, so kernels do not overlap), the
kernel launches per call, and the kernels that take the most device time,
with the card's name and power limit. It needs one card; it does nothing
useful elsewhere.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from speech_masters_thesis_tpu_torch.device import cuda_device
from speech_masters_thesis_tpu_torch.inference import GlowTTSSynthesizer
from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.models.ema import default_mu
from speech_masters_thesis_tpu_torch.train.loop import make_train_step, make_val_step
from speech_masters_thesis_tpu_torch.train.optim import build_optimizer
from speech_masters_thesis_tpu_torch.train.state import TrainState

CALLS = 3
TOP = 16


def device_time_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def is_kernel(event) -> bool:
    """A kernel on the card, not a range annotation over kernels (the
    optimizer's step is one), which would count their time twice."""
    return (getattr(event, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not event.key.startswith(("Optimizer.", "ProfilerStep")))


def report(name: str, fn, card: str) -> None:
    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if is_kernel(e)]
    busy = sum(device_time_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"[{name}] {wall_us / CALLS / 1e3:.3f} ms a call (under the profiler), kernels {busy / CALLS / 1e3:.3f} "
          f"ms a call, device busy {busy / wall_us:.3f} of the wall time, {launches / CALLS:.0f} kernel launches "
          f"a call [{card}]")
    for e in sorted(kernels, key=device_time_us, reverse=True)[:TOP]:
        print(f"[{name}]   {device_time_us(e) / CALLS / 1e3:8.3f} ms {e.count // CALLS:5d}x  {e.key[:110]}")


def main() -> None:
    card = cs.phase_device()
    device = cuda_device()
    _build.build()
    batch = cs.glow_val_batch(cs.GLOW_BATCH, device, seed=31)
    for flow_step in (False, True):
        train_model = cs.build_glow(device, cs.GLOW_SEED + 1, flow_step)
        opt, schedule = build_optimizer(train_model.parameters(), cs.configs.GLOW_TTS_TPU_OPTIMIZER,
                                        cs.configs.GLOW_TTS_TPU_SCHEDULER, cs.configs.GLOW_TTS_TPU)
        train_state = TrainState.create(train_model, opt, use_ema=True)
        train_step = make_train_step(schedule, default_mu(cs.GLOW_BATCH, 1), use_ema=True)
        report(f"train step, {'B6' if flow_step else 'B3'} route",
               lambda: train_step(train_state, batch, cs.TRAIN_SEED), card)
        del train_model, train_state, opt
    model = cs.build_glow(device, cs.GLOW_SEED)
    opt, _ = build_optimizer(model.parameters(), cs.configs.GLOW_TTS_TPU_OPTIMIZER,
                             cs.configs.GLOW_TTS_TPU_SCHEDULER, cs.configs.GLOW_TTS_TPU)
    state = TrainState.create(model, opt, use_ema=True)
    batch = cs.glow_val_batch(cs.GLOW_BATCH, device, seed=30)
    val_step = make_val_step(use_ema=True)
    report("val step", lambda: val_step(state, batch), card)
    synth = GlowTTSSynthesizer(model, cs.glow_config(), max_frames=cs.SYNTH_MAX_FRAMES, gl_iters=cs.GL_ITERS)
    ids, lens = batch["token"], batch["token_len"]
    for B in cs.SYNTH_BATCHES:
        gen = torch.Generator(device=device).manual_seed(B)
        report(f"synthesis B={B}", lambda: synth.synthesize_ids(ids[:B], gen, 0.667, lens[:B]), card)


if __name__ == "__main__":
    main()
