#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's Glow-TTS paths on one GPU.

    python3 profile_glow.py
    python3 profile_glow.py --backward-split
    python3 profile_glow.py --forward-split
    python3 profile_glow.py --enc-split
    python3 profile_glow.py --vqtts

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

``--backward-split`` instead profiles B3's and B6's backward wrappers
(``wn_coupling_backward``, ``flow_step_backward``) at chip_smoke's train
shape, (8, 384) squeezed frames, p = 0.05, and splits one call's device
time by the place of each kernel in the chain: the weight packing (kernels
named ``pack``), B6's prefix, the recompute (1 + 2 L launches), the
transposed products (2 + 2 L), B6's dx1, and the weight-gradient reduction
(the rest), and prints the host's time a call beside the device's.
``--forward-split`` lists one call of B3's forward (p = 0) and of B6's
(p = 0.05) at the same shape kernel by kernel, in launch order (the
packing, B6's prefix, then per layer the gate conv and the res/skip 1x1,
the start and end 1x1s), with their sums and the host's time a call.
``--enc-split`` lists one call of B5's forward and one of its backward
(``enc_layer``, ``enc_layer_backward``) at chip_smoke's shape, (8, 256)
tokens at p = 0.1, on the seeded Glow-TTS's first encoder layer (phase
23's inputs), kernel by kernel in launch order, with each call's device
time split into the weight packing, the products, the attention kernels
and the weight-gradient reduction (by the kernels' names), the host's
time a call and the device's over back-to-back calls.
``--vqtts`` profiles VQ-TTS instead (chip_smoke.py's phases 30 and 31:
VQTTS_TPU width, batch 4 x 2 s, 64 tokens, seeded weights): the train step
(dropout on, Adam, codebook and parameter EMAs, after a first step that runs
the codebook's lazy init) on the config's encoder route (the plain layer)
and on B5's (``fused_encoder: true``), and the val step, with the same
report.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from speech_masters_thesis_tpu_torch.device import cuda_device
from speech_masters_thesis_tpu_torch.inference import GlowTTSSynthesizer
from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops import enc_layer as enc_ops
from speech_masters_thesis_tpu_torch.ops import flow_step as fs_ops
from speech_masters_thesis_tpu_torch.ops import wn_coupling as wn_ops
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


def kernel_sequence(fn) -> list:
    """(name, device us) of each kernel of ``CALLS`` calls of ``fn``, in launch order."""
    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if is_kernel(e)), key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in kernels]


def host_ms(fn, n: int = 20) -> float:
    """The host's time for one call of ``fn``, issued ``n`` times without a
    synchronisation (the card's queue takes them all) after a synchronised
    warm-up: the wrapper's Python, ctypes and launch work alone."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return ms


def split_report(name: str, seq: list, layers: int, prefix: bool, card: str) -> None:
    """One call's kernels grouped by their place in the backward chain."""
    per_call = len(seq) // CALLS
    calls = [seq[i * per_call:(i + 1) * per_call] for i in range(CALLS)]
    sizes = [("recompute", 1 + 2 * layers), ("transposed", 2 + 2 * layers)]
    if prefix:
        sizes = [("prefix", 1), *sizes, ("dx1", 1)]
    sums = []
    for call in calls:
        n_pack = sum(1 for k, _ in call if "pack" in k)
        groups, at = {"pack": call[:n_pack]}, n_pack
        for group, n in sizes:
            groups[group], at = call[at:at + n], at + n
        groups["reduction"] = call[at:]
        sums.append({g: sum(us for _, us in ks) / 1e3 for g, ks in groups.items()})
    total = [sum(s.values()) for s in sums]
    print(f"[{name}] {per_call} kernels a call; device ms a call, median of {CALLS}: total "
          f"{float(np.median(total)):.4f}; " + ", ".join(
              f"{g} {float(np.median([s[g] for s in sums])):.4f}" for g in sums[0]) + f" [{card}]")
    for k, us in calls[-1]:
        print(f"[{name}]   {us / 1e3:8.4f} ms  {k[:120]}")


def forward_report(name: str, seq: list, card: str) -> None:
    """One call's kernels in launch order, and the median sum of a call."""
    per_call = len(seq) // CALLS
    calls = [seq[i * per_call:(i + 1) * per_call] for i in range(CALLS)]
    total = float(np.median([sum(us for _, us in call) for call in calls])) / 1e3
    print(f"[{name}] {per_call} kernels a call; device ms a call, median of {CALLS}: total {total:.4f} [{card}]")
    for k, us in calls[-1]:
        print(f"[{name}]   {us / 1e3:8.4f} ms  {k[:120]}")


def kernel_group(name: str) -> str:
    """The part of a B5 call a kernel belongs to, by its name."""
    for key, group in (("pack", "packing"), ("attention", "attention"), ("wgrad", "reduction")):
        if key in name:
            return group
    return "products"


def enc_report(name: str, seq: list, card: str) -> None:
    """One call's kernels in launch order, and the median split of a call by
    ``kernel_group``."""
    per_call = len(seq) // CALLS
    calls = [seq[i * per_call:(i + 1) * per_call] for i in range(CALLS)]
    groups = ("packing", "products", "attention", "reduction")
    sums = [{g: sum(us for k, us in call if kernel_group(k) == g) / 1e3 for g in groups} for call in calls]
    total = float(np.median([sum(s.values()) for s in sums]))
    print(f"[{name}] {per_call} kernels a call; device ms a call, median of {CALLS}: total {total:.4f}; "
          + ", ".join(f"{g} {float(np.median([s[g] for s in sums])):.4f}" for g in groups) + f" [{card}]")
    for k, us in calls[-1]:
        print(f"[{name}]   {us / 1e3:8.4f} ms  {kernel_group(k):9s}  {k[:110]}")


def enc_split(card: str, device) -> None:
    cs.phase_build()
    w = cs.build_glow(device, cs.GLOW_SEED).encoder.layer_weights(0)
    w = w.with_tensors([t.detach() for t in w.tensors().values()])
    B, T = cs.B5_SHAPES[0]
    rng = np.random.RandomState(820)  # chip_smoke.phase_enc_layer_bwd's first shape
    lens = torch.from_numpy(cs.ragged(rng, B, max(1, T // 2), T).astype(np.int32)).to(device)
    x = torch.from_numpy(rng.randn(B, T, w.wq.shape[0]).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(device)
    seed, p = torch.tensor([5151], dtype=torch.int64, device=device), cs.B5_DROP
    calls = {f"B5 forward B={B} T={T} p={p}": lambda: enc_ops.enc_layer(x, lens, w, seed, p),
             f"B5 backward B={B} T={T} p={p}": lambda: enc_ops.enc_layer_backward(x, lens, w, g, seed, p)}
    with torch.no_grad():
        for name, fn in calls.items():
            enc_report(name, kernel_sequence(fn), card)
            print(f"[{name}] host ms a call (wrapper and launches, no synchronisation): {host_ms(fn):.4f}; "
                  f"device ms a call over {cs.DEVICE_REPS} back-to-back calls: {cs.device_ms(fn):.4f} [{card}]")


def flow_step_inputs(device) -> tuple:
    """chip_smoke's train shape on the first flow step's weights of a seeded
    Glow-TTS: (x, lens, aln, alb, mt, w, g_xc, g_out, seed)."""
    model = cs.build_glow(device, cs.GLOW_SEED)
    act, inv, cpl = model.decoder.flows[0], model.decoder.flows[1], model.decoder.flows[2]
    w = cpl.conditioner_weights()
    w = wn_ops.WNWeights.from_flat([t.detach() for t in w.flat()], w.dilations)
    with torch.no_grad():
        aln, alb, mt = act.logs.view(-1).clone(), act.bias.view(-1).clone(), inv.dense_matrix_t()
    B, T = cs.B3_SHAPES[0]
    C = model.n_mels * model.n_sqz
    rng = np.random.RandomState(720)
    lens = torch.from_numpy(cs.ragged(rng, B, T // 2, T).astype(np.int32)).to(device)
    valid = (torch.arange(T, device=device)[None, :] < lens[:, None])[..., None]
    x = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device) * valid
    g_xc, g_out = (torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device) for _ in range(2))
    seed = torch.tensor([4242], dtype=torch.int64, device=device)
    return x, lens, aln, alb, mt, w, g_xc, g_out, seed


def forward_split(card: str, device) -> None:
    cs.phase_build()
    x, lens, aln, alb, mt, w, _, _, seed = flow_step_inputs(device)
    B, T, C = x.shape
    calls = {f"B3 forward B={B} T={T} p=0.0": lambda: wn_ops.wn_coupling(x[..., :C // 2], lens, w, seed, 0.0),
             f"B6 forward B={B} T={T} p={cs.B3_DROP}": lambda: fs_ops.flow_step(x, lens, aln, alb, mt, w, seed,
                                                                                cs.B3_DROP)}
    with torch.no_grad():
        for name, fn in calls.items():
            forward_report(name, kernel_sequence(fn), card)
            print(f"[{name}] host ms a call (wrapper and launches, no synchronisation): {host_ms(fn):.4f}; "
                  f"device ms a call over {cs.DEVICE_REPS} back-to-back calls: {cs.device_ms(fn):.4f} [{card}]")


def backward_split(card: str, device) -> None:
    cs.phase_build()
    x, lens, aln, alb, mt, w, g_xc, g_out, seed = flow_step_inputs(device)
    B, T, C = x.shape
    x0 = x[..., :C // 2]
    calls = {"B3": (lambda: wn_ops.wn_coupling_backward(x0, lens, w, g_out, seed, cs.B3_DROP), False),
             "B6": (lambda: fs_ops.flow_step_backward(x, lens, aln, alb, mt, w, g_xc, g_out, seed, cs.B3_DROP), True)}
    with torch.no_grad():
        for kernel, (fn, prefix) in calls.items():
            name = f"{kernel} backward B={B} T={T} p={cs.B3_DROP}"
            split_report(name, kernel_sequence(fn), len(w.win), prefix, card)
            print(f"[{name}] host ms a call (wrapper and launches, no synchronisation): {host_ms(fn):.4f}; "
                  f"device ms a call over {cs.DEVICE_REPS} back-to-back calls: {cs.device_ms(fn):.4f} [{card}]")


def vqtts(card: str, device) -> None:
    _build.build()
    batch = cs.vqtts_batch(cs.VQTTS_BATCH, cs.VQTTS_SAMPLES, device, seed=41)
    states = {}
    for fused_encoder in (False, True):
        model = cs.build_vqtts(device, cs.VQTTS_SEED, fused_encoder)
        opt, schedule = build_optimizer(model.parameters(), cs.configs.VQTTS_TPU_OPTIMIZER)
        state = states[fused_encoder] = TrainState.create(model, opt, use_ema=True)
        train_step = make_train_step(schedule, default_mu(cs.VQTTS_BATCH, 1), use_ema=True)
        train_step(state, batch, cs.TRAIN_SEED)  # the codebook's lazy init
        report(f"vqtts train step, {'B5' if fused_encoder else 'config'} encoder route",
               lambda: train_step(state, batch, cs.TRAIN_SEED), card)
    val_step = make_val_step(use_ema=True)
    report("vqtts val step, config encoder route", lambda: val_step(states[False], batch), card)


def main() -> None:
    card = cs.phase_device()
    device = cuda_device()
    if sys.argv[1:] == ["--backward-split"]:
        backward_split(card, device)
        return
    if sys.argv[1:] == ["--forward-split"]:
        forward_split(card, device)
        return
    if sys.argv[1:] == ["--enc-split"]:
        enc_split(card, device)
        return
    if sys.argv[1:] == ["--vqtts"]:
        vqtts(card, device)
        return
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
