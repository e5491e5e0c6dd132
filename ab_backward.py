"""Parent against change on one card: B2's backward, B1's forward, backward
tile passes and weight-gradient reduction, the VQ-VAE train step, the
codec's encode + decode and the LM train step, B3's, B5's and B6's forward
and backward, the Glow-TTS train step on both routes, its val step and
synthesis, each tree in its own process, in the order given (parent,
change, change, parent, ...).

``--b2b4`` measures, for each tree, B2's forward back to back at
chip_smoke's three ATTN_SHAPES, p=0 and 0.1, B4 back to back at
B4_SHAPES, B2's backward, B1's forward, tile passes and reduction, B3's,
B5's and B6's forwards and backwards (as below), the LM train step at batch 8
and 64 (``chip_smoke.phase_lm_train``), phase 15's gradient median (the
card's LM step against the CPU's, ``chip_smoke.phase_lm_vs_cpu``), the Glow
train step on the B3 route (``chip_smoke.phase_glow_train``) and the val
step. ``--b5`` measures, for each tree, B5's forward and backward back to back
(as below) and phase 25's step (``chip_smoke.phase_glow_train_vs_cpu``'s
models, batch and seeds) with each parameter's gradient error against the
fp64 step: the median and worst of B5's parameters (the encoder layers'),
of the rest and of all, the CPU fp32 step's beside them, and the worst
parameters. ``--bf16-fwd`` measures, for each tree, B1's bf16 forward back to
back at p=0 and 0.1, summed over the VQ-VAE's 7 block shapes (batch 16,
depth 4) and VQ-TTS's 8 (batch 4, depth 3), its device time by kernel
(torch.profiler over 3 calls at 16 x 33024 frames, p=0.1) and a sha256 of
its output there, the bf16 tile passes' and reduction's sums as ``--bf16``
has them, and the bf16 VQ-VAE train step as ``--bf16`` has it. ``--bf16``
measures, for each tree, B1's bf16 tile passes and
reduction back to back at p=0.1, summed over the VQ-VAE's 7 block shapes
(batch 16, depth 4) and VQ-TTS's 8 (batch 4, depth 3), and the bf16
VQ-VAE train step (``chip_smoke.phase_bf16_train``: the median bf16 step in
turns with the fp32 one, and its max_memory_allocated). ``--bf16-tiles``
measures the same two kernels' sums without the step, the tile passes'
device time by kernel (each stage, torch.profiler over 3 calls at 16 x
33024 frames, p=0.1) and a sha256 of their outputs there (dx, the buffers
and the bias partials), so that two trees can be held bit for bit; it
loads each tree's library from its build cache (building it there if it
is missing) without ``chip_smoke.phase_build``'s checks. ``--ptxas`` builds
each tree and compares its ptxas lines (each kernel by its mangled name,
an anonymous namespace's path hash and an fp32 instance's float IO
argument removed: without_io) outside the instances
PTXAS_CHANGED names with the first tree's, as multisets, the fp32 instances
apart from the bf16 ones. ``--bf16-wn`` measures, for each tree, B3's and
B6's bf16 forwards and backwards at (8, 384) squeezed frames (``glow_inputs`` cast as
``chip_smoke.phase_bf16_flow_step`` casts them: the conditioner's weights,
x and the cotangents bf16, aln, alb and mt fp32 of their bf16 values; B3's
x0 the first-half view of x), p = 0 and B3_DROP: back to back, a call
(``chip_smoke.cuda_ms``: the wrapper's host time included), the device time
and launches by launch kind (torch.profiler over 3 calls), and at B3_DROP a
sha256 of the forwards' out (B6: xc and out) and of dx and every gradient, and
of B5's bf16 forward at every B5_SHAPES (p = 0 and 0.1) and its backward
(bf16_enc_hashes: B5 shares the engine); then the bf16 Glow train step
(``chip_smoke.phase_bf16_glow_train``) on the B3 and the B6 route in turns
(b3, b6, b6, b3): the median of steps 2-10, the peak, the kernels' ms and
the busy share of one step under torch.profiler, the median of each
route's two runs. ``--bf16-wn-kernels`` measures the two forwards and backwards alone,
without the steps (about 2 min a tree, most of it the build).
``--bf16-enc`` measures, for each tree, B5's bf16 forward and backward
(``enc_layer.enc_layer`` and ``enc_layer.enc_layer_backward`` on the Glow
encoder's first layer cast as ``chip_smoke.enc_bf16`` casts it,
phase_bf16_enc_layer's inputs) at (8, 256) and VQ-TTS's (4, 64), p = 0 and
B5_DROP, each beside B5's fp32 kernel on the same values in fp32: back to
back, a call (``chip_smoke.cuda_ms``), the bf16 kernels' device time and
launches by launch kind (torch.profiler over 3 calls); a sha256 of the bf16
backward's dx and every gradient at (8, 256), p = B5_DROP, and of B3's
and B6's bf16 forwards and backwards as ``--bf16-wn`` takes them (the
shared engine must not move them); then the bf16 Glow train step on the B3
and the B6 route and the bf16 VQ-TTS train step on B5's route
(``chip_smoke.phase_bf16_vqtts_train``, fused_encoder: true) in turns (b3,
b6, vqtts, vqtts, b6, b3): each run's median step, peak, the kernels' ms and
the busy share of one step under torch.profiler, the medians of a route's
two runs. ``--bf16-enc-kernels`` measures the same without the steps
(``--worker TREE --bf16-enc-kernels`` measures one tree alone).
``--bf16-attn`` measures, for each tree, B2's bf16 forward and backward at
chip_smoke's ATTN_SHAPES ((8, 258), (64, 258), (8, 1024)), p = 0 and
P_DROP, on phase_bf16_attention's inputs (packed bf16 projections, ragged
lengths): back to back (the forward through its C entry point, the backward
through ``attention.attention_backward``), a call (``chip_smoke.cuda_ms``: the
forward through ``fused_attention``, the backward through
``attention_backward`` and through autograd on the packed views), the host
time a call without waiting for the card (the wrappers' enqueue), the
kernels' device time and launches by launch kind (torch.profiler over 3
calls), a sha256 of o, dq, dk and dv over every shape and p; the sha256 of
B2's fp32 forward and backward at (8, 258) and of B5's bf16 forward and
backward (bf16_enc_hashes), which share B2's headers; then the bf16 LM
train step at batch 8 and 64 (``chip_smoke.phase_bf16_lm_train``'s model,
batch and seeds; ``chip_smoke.bf16_steps``: the median of steps 2-10, the
peak, launches a step, the busy share) and the kernels of one more step by
launch kind, with B2's share of them. ``--bf16-attn-kernels`` measures the
same without the steps.

    python3 ab_backward.py build/parent . . build/parent
    python3 ab_backward.py --glow build/parent . . build/parent ...   # the Glow pairs only
    python3 ab_backward.py --b5 build/parent . ...      # B5's times and phase 25's errors by group
    python3 ab_backward.py --b2b4 build/parent . . build/parent   # B2's forward, B4, the LM and Glow steps
    python3 ab_backward.py --bf16 build/parent . . build/parent   # B1's bf16 backward, the bf16 VQ-VAE step
    python3 ab_backward.py --bf16-fwd build/parent . . build/parent   # B1's bf16 forward (and backward), the step
    python3 ab_backward.py --bf16-tiles build/parent . . build/parent   # the same kernels by stage, no step
    python3 ab_backward.py --bf16-wn build/parent . . build/parent   # B3's and B6's bf16 kernels, the bf16 Glow steps
    python3 ab_backward.py --bf16-wn-kernels build/v1 build/v2 build/v2 build/v1   # the four kernels alone
    python3 ab_backward.py --bf16-enc build/parent . . build/parent   # B5's bf16 kernels, the bf16 Glow/VQ-TTS steps
    python3 ab_backward.py --bf16-enc-kernels build/parent . . build/parent   # B5's bf16 kernels alone
    python3 ab_backward.py --bf16-attn build/parent . . build/parent   # B2's bf16 kernels, the bf16 LM steps
    python3 ab_backward.py --bf16-attn-kernels build/parent . . build/parent   # B2's bf16 kernels alone
    python3 ab_backward.py --ptxas build/parent .       # ptxas lines outside PTXAS_CHANGED against the first tree

Each argument is the root of a checkout of the port (its package and its
``chip_smoke.py``); a worker puts that root first on ``sys.path``, builds
that tree's kernels and measures through the wrappers both trees share
(``attention.attention_backward``, ``gated_hifi.gated_hifi``,
``gated_hifi.backward_buffers``, ``gated_hifi.weight_grad_reduce``) and
``chip_smoke``'s phases. Kernel times are CUDA events around back-to-back
calls over their count (device time), summed over the 7 block shapes of
the VQ-VAE path at batch 16: the forward at p=0 and p=0.1, the tile passes
and the reduction at p=0.1. Step times are those of
``chip_smoke.phase_train`` (median of steps 2-5, with its peak memory) and
``chip_smoke.phase_lm_train`` (batch 64); encode + decode is timed as
``chip_smoke.phase_timing`` times it (batch 16 x 66048, median of 5 after a
warm-up, with its peak memory). B3's and B6's backward
(``wn_coupling.wn_coupling_backward``, ``flow_step.flow_step_backward``) are
timed back to back at chip_smoke's train shape, (8, 384) squeezed frames,
p = 0.05, on a seeded Glow-TTS's first flow step, and their forwards
(``wn_coupling.wn_coupling`` at p = 0, ``flow_step.flow_step`` at p =
0.05, the rows of chip_smoke's kernels line) the same way, each with its
largest error against its plain version over chip_smoke's B3_RTOL; B5's
forward (``enc_layer.enc_layer``, p = 0, with its largest error over
B5_RTOL) and backward (``enc_layer.enc_layer_backward``, p = 0.1) back to
back at chip_smoke's (8, 256) tokens on the seeded Glow-TTS's first
encoder layer (phase 23's inputs); the
Glow train step on the B3 and the B6 route is ``chip_smoke.phase_glow_train`` (median of steps
4-10, with its peak memory), then ``chip_smoke.steps_in_turns`` (20 steps of
each route in turns, medians), the val step ``chip_smoke.phase_glow_val``
(median of 3, with its peak memory) and synthesis
``chip_smoke.phase_synthesis`` at batch 1 and 8 (median of 5: the mel, and
text to waveform). Prints one JSON line per worker, then the pairs.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

ATTN_SHAPES = ((8, 258), (64, 258))
ATTN_REPS = 50
TILE_REPS = 20
TILE_P = 0.1
STAGE_T = 33024  # --bf16-tiles: the frames of the stages' profile (the VQ-VAE's largest block shape)
FWD_PS = (0.0, 0.1)
FWD_REPS = 20
GLOW_BWD_REPS = 50
B4_SHAPES = ((8, 256, 768), (8, 512, 1024), (8, 256, 1536))  # [B, t_x, t_y]
# instances the change may alter, by a piece of their mangled names: B2's bf16 kernels (attention_bf16.cu's
# anonymous namespace); every other instance, fp32 and bf16, is held with the rest
PTXAS_CHANGED = ("attention_bf16_",)
BF16_ENC_SHAPES = (0, 4)  # chip_smoke.B5_SHAPES' (8, 256) and VQ-TTS's (4, 64)
BF16_ATTN_REPS = 50


def back_to_back_ms(torch, fn, n: int, warmup: int = 3) -> float:
    """chip_smoke.device_ms, kept here because a parent tree's chip_smoke.py
    may not have it: one event pair around n calls, over n."""
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


def attention_fwd_launch(torch, att, q, k, v, lens, seed, scale: float, p: float):
    """chip_smoke.attention_fwd_launch, kept here because a parent tree's
    chip_smoke.py may not have it: one launch of B2's forward through its C
    entry point on outputs allocated once, without the wrapper's host time."""
    from speech_masters_thesis_tpu_torch.ops import _build

    B, T, H, D = q.shape
    o = torch.empty(B, T, H, D, device=q.device)
    stats = torch.empty(B, H, T, 2, device=q.device)
    lib = _build.build()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(1), lens.data_ptr(), seed.data_ptr(), o.data_ptr(),
            stats.data_ptr(), B, T, H, D, float(scale), *att._dropout_args(p),
            torch.cuda.current_stream(q.device).cuda_stream)

    def launch():
        if lib.attention_fwd(*args) != 0:
            raise RuntimeError("attention_fwd launch failed")
    launch.outputs = (o, stats)  # the pointers in args live as long as the closure
    return launch


def encode_decode(torch, cs, model, device) -> tuple:
    """(median ms, peak GiB) of encode + decode as chip_smoke.phase_timing
    runs it; kept here because a parent tree's phase_timing returns nothing."""
    audio, lengths = cs.audio_batch(cs.BATCH, cs.SAMPLES, seed=4)
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
    return sorted(times)[len(times) // 2], torch.cuda.max_memory_allocated() / 2 ** 30


def glow_inputs(torch, np, cs, wn_ops, device) -> tuple:
    """chip_smoke's train shape, (8, 384) squeezed frames, on the first flow
    step's weights of a seeded Glow-TTS (phases 22 and 26): (x, lens, valid,
    aln, alb, mt, w, g_xc, g_out, seed)."""
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
    valid = torch.arange(T, device=device)[None, :] < lens[:, None]
    x = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device) * valid[..., None]
    g_xc, g_out = (torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).to(device) for _ in range(2))
    seed = torch.tensor([4242], dtype=torch.int64, device=device)
    return x, lens, valid, aln, alb, mt, w, g_xc, g_out, seed


def glow_forwards(torch, cs, wn_ops, fs_ops, inputs: tuple) -> dict:
    """B3's forward at p = 0 and B6's at B3_DROP (the rows of chip_smoke's
    kernels line), back to back, each with its largest error against its
    plain version at valid frames over B3_RTOL of max|ref|."""
    x, lens, valid, aln, alb, mt, w, _, _, seed = inputs
    x0, p = x[..., :x.shape[2] // 2], cs.B3_DROP
    calls = {"b3": (lambda: wn_ops.wn_coupling(x0, lens, w, seed, 0.0),
                    lambda: wn_ops.wn_coupling_reference(x0, lens, w, seed, 0.0)),
             "b6": (lambda: fs_ops.flow_step(x, lens, aln, alb, mt, w, seed, p)[1],
                    lambda: fs_ops.flow_step_reference(x, lens, aln, alb, mt, w, seed, p)[1])}
    out = {}
    with torch.no_grad():
        for name, (kernel, plain) in calls.items():
            ours, ref = kernel(), plain()
            out[f"{name}_fwd_err_over_tol"] = ((ours - ref)[valid].abs().max()
                                               / (cs.B3_RTOL * ref[valid].abs().max())).item()
            out[f"{name}_fwd_ms"] = back_to_back_ms(torch, kernel, GLOW_BWD_REPS)
    return out


def glow_backwards(torch, cs, wn_ops, fs_ops, inputs: tuple) -> dict:
    """B3's and B6's backward, back to back, at p = B3_DROP."""
    x, lens, _, aln, alb, mt, w, g_xc, g_out, seed = inputs
    with torch.no_grad():
        return {
            "b3_bwd_ms": back_to_back_ms(torch, lambda: wn_ops.wn_coupling_backward(
                x[..., :x.shape[2] // 2], lens, w, g_out, seed, cs.B3_DROP), GLOW_BWD_REPS),
            "b6_bwd_ms": back_to_back_ms(torch, lambda: fs_ops.flow_step_backward(
                x, lens, aln, alb, mt, w, g_xc, g_out, seed, cs.B3_DROP), GLOW_BWD_REPS)}


def enc_layer_times(torch, np, cs, device) -> dict:
    """B5's forward at p = 0 and backward at B5_DROP back to back at
    B5_SHAPES[0], the forward with its largest error against the plain
    version at valid rows over B5_RTOL of max|ref|."""
    from speech_masters_thesis_tpu_torch.ops import enc_layer as enc_ops

    w = cs.build_glow(device, cs.GLOW_SEED).encoder.layer_weights(0)
    w = w.with_tensors([t.detach() for t in w.tensors().values()])
    B, T = cs.B5_SHAPES[0]
    rng = np.random.RandomState(820)
    lens = torch.from_numpy(cs.ragged(rng, B, max(1, T // 2), T).astype(np.int32)).to(device)
    valid = torch.arange(T, device=device)[None, :] < lens[:, None]
    x = torch.from_numpy(rng.randn(B, T, w.wq.shape[0]).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(device)
    seed = torch.tensor([5151], dtype=torch.int64, device=device)
    with torch.no_grad():
        ours, ref = enc_ops.enc_layer(x, lens, w), enc_ops.enc_layer_reference(x, lens, w)
        return {"b5_fwd_err_over_tol": ((ours - ref)[valid].abs().max()
                                        / (cs.B5_RTOL * ref[valid].abs().max())).item(),
                "b5_fwd_ms": back_to_back_ms(torch, lambda: enc_ops.enc_layer(x, lens, w), GLOW_BWD_REPS),
                "b5_bwd_ms": back_to_back_ms(torch, lambda: enc_ops.enc_layer_backward(
                    x, lens, w, g, seed, cs.B5_DROP), GLOW_BWD_REPS)}


def is_b5(name: str) -> bool:
    """A parameter of the encoder's layers, which B5 computes."""
    return any(part in name for part in ("attn_layers", "ffn_layers", "norm_layers"))


def step_grad_errors(torch, cs, device) -> dict:
    """Phase 25's train step (p=0, 2 sequences) on the card, the CPU and in
    fp64 on the CPU: each parameter's relative L2 error against fp64 (the
    denominator floored at 1e-4 of the global norm), summarised by group."""
    import copy

    from speech_masters_thesis_tpu_torch import configs
    from speech_masters_thesis_tpu_torch.models.base import spect_from_audio
    from speech_masters_thesis_tpu_torch.models.ema import default_mu
    from speech_masters_thesis_tpu_torch.train.loop import make_train_step
    from speech_masters_thesis_tpu_torch.train.optim import build_optimizer
    from speech_masters_thesis_tpu_torch.train.state import TrainState

    n = cs.GLOW_VS_CPU
    sub = {k: v[:n] for k, v in cs.glow_val_batch(cs.GLOW_BATCH, device, seed=32).items()}
    models = {"cuda": cs.build_glow(device, cs.GLOW_SEED + 2)}
    cs.set_dropout(models["cuda"], 0.0)
    with torch.no_grad():
        spect, spect_len = spect_from_audio(models["cuda"], sub)
    models["cpu"] = copy.deepcopy(models["cuda"]).to("cpu")
    models["cpu64"] = copy.deepcopy(models["cpu"]).double()
    grads = {}
    for name, model in models.items():
        dev = next(model.parameters()).device
        batch = {"token": sub["token"].to(dev), "token_len": sub["token_len"].to(dev),
                 "spect": spect.to(dev, torch.float64 if name == "cpu64" else torch.float32),
                 "spect_len": spect_len.to(dev)}
        opt, schedule = build_optimizer(model.parameters(), configs.GLOW_TTS_TPU_OPTIMIZER,
                                        configs.GLOW_TTS_TPU_SCHEDULER, configs.GLOW_TTS_TPU)
        make_train_step(schedule, default_mu(n, 1), use_ema=True)(TrainState.create(model, opt, use_ema=True),
                                                                   batch, cs.TRAIN_SEED)
        grads[name] = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()}
    ref = grads["cpu64"]
    floor = 1e-4 * torch.sqrt(sum((r * r).sum() for r in ref.values())).item()
    errs = {side: {k: ((grads[side][k] - r).norm() / max(r.norm().item(), floor)).item() for k, r in ref.items()}
            for side in ("cuda", "cpu")}
    out = {}
    for group, keep in (("all", lambda k: True), ("b5", is_b5), ("rest", lambda k: not is_b5(k))):
        for side in ("cuda", "cpu"):
            vals = [e for k, e in errs[side].items() if keep(k)]
            out[f"grad_{group}_{side}_median"] = statistics.median(vals)
            out[f"grad_{group}_{side}_worst"] = max(vals)
    out["grad_worst_params"] = [(k, errs["cuda"][k], errs["cpu"][k])
                                for k in sorted(ref, key=lambda k: -errs["cuda"][k])[:5]]
    return out


def glow_steps(torch, cs, device, card) -> dict:
    """The Glow train step on both routes (phases 24 and 27, then the steps
    in turns) and the val step with their peak memory."""
    out = {}
    steps = {}
    for route, flow_step in (("b3", False), ("b6", True)):
        res = cs.phase_glow_train(device, card, flow_step=flow_step)
        out[f"glow_step_{route}_ms"], out[f"glow_step_{route}_peak_gib"] = res["step_ms"], res["peak"]
        steps[route] = res["step"]
        del res["model"]
    turns = cs.steps_in_turns(steps, cs.GLOW_AB_ROUNDS)
    for route, times in turns.items():
        out[f"glow_turns_{route}_ms"] = statistics.median(times)
    del steps, turns
    torch.cuda.empty_cache()
    model = cs.build_glow(device, cs.GLOW_SEED)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out["glow_val_ms"] = cs.phase_glow_val(model, device, card)["step_ms"]
    out["glow_val_peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    synthesis = cs.phase_synthesis(model, device, card)
    for B in cs.SYNTH_BATCHES:
        out[f"synth_b{B}_mel_ms"], out[f"synth_b{B}_total_ms"] = (synthesis[B][k] for k in ("mel_ms", "total_ms"))
    return out


def codec_kernels(torch, np, cs, att, gh, device) -> dict:
    """B2's backward, B1's forward, tile passes and reduction, back to back."""
    out = {"attention_bwd": {}, "tiles": {}, "reduction": {}, **{f"forward p={p}": {} for p in FWD_PS}}
    scale = 1.0 / np.sqrt(cs.ATTN_DIM)
    with torch.no_grad():
        for i, (B, T) in enumerate(ATTN_SHAPES):
            packed, lens, g = cs.packed_qkv(B, T, 500 + i, device)
            q, k, v = cs.heads(packed)
            for p in (0.0, cs.P_DROP):
                seed = torch.tensor([12345 + i], dtype=torch.int64, device=device)
                o, stats = att._launch_fwd(q, k, v, lens, seed, scale, p)
                out["attention_bwd"][f"{B}x{T} p={p}"] = back_to_back_ms(
                    torch, lambda: att.attention_backward(q, k, v, o, stats, lens, seed, g, scale, p), ATTN_REPS)
        w = cs.block_weights(device, seed=1)
        for i, T in enumerate(cs.BLOCK_TS):
            x, lens, _, g = cs.block_inputs(T, cs.BATCH, 200 + i, device)
            for p in FWD_PS:
                out[f"forward p={p}"][T] = back_to_back_ms(
                    torch, lambda: gh.gated_hifi(x, lens, w, 1.0, p, 12345), TILE_REPS, warmup=1)
            out["tiles"][T] = back_to_back_ms(
                torch, lambda: gh.backward_buffers(x, lens, w, g, 1.0, TILE_P, 12345), TILE_REPS, warmup=1)
            _, bufs = gh.backward_buffers(x, lens, w, g, 1.0, TILE_P, 12345)
            out["reduction"][T] = back_to_back_ms(
                torch, lambda: gh.weight_grad_reduce(x, bufs, w.kernels, w.dilations), TILE_REPS, warmup=1)
            del x, lens, g, bufs
            torch.cuda.empty_cache()
    for key in ("tiles", "reduction", *(f"forward p={p}" for p in FWD_PS)):
        out[f"{key} sum"] = sum(out[key].values())
    return out


def codec_and_lm(torch, np, cs, att, gh, device, card) -> dict:
    """codec_kernels, then the VQ-VAE step, encode + decode and the LM b64
    step."""
    out = codec_kernels(torch, np, cs, att, gh, device)
    out["vqvae_step_ms"] = cs.phase_train(device, card)["step_ms"]
    out["vqvae_step_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30  # phase_train resets it
    torch.cuda.empty_cache()
    model = cs.build_model(device, *cs.audio_batch(cs.BATCH, cs.SAMPLES, seed=5))
    out["encode_decode_ms"], out["encode_decode_peak_gib"] = encode_decode(torch, cs, model, device)
    vq_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    out["lm_b64_step_ms"] = cs.phase_lm_train(device, card, vq_state)[64]["step_ms"]
    torch.cuda.empty_cache()
    return out


def b2_b4_times(torch, np, cs, att, device) -> dict:
    """B2's forward back to back at chip_smoke's ATTN_SHAPES, p=0 and 0.1
    (through its C entry point, and through the wrapper), and B4 at
    B4_SHAPES (chip_smoke.mas_inputs, ragged masks)."""
    from speech_masters_thesis_tpu_torch.ops import mas as mas_ops

    out = {}
    scale = 1.0 / np.sqrt(cs.ATTN_DIM)
    with torch.no_grad():
        for i, (B, T) in enumerate(cs.ATTN_SHAPES):
            packed, lens, _ = cs.packed_qkv(B, T, 500 + i, device)
            q, k, v = cs.heads(packed)
            for p in (0.0, cs.P_DROP):
                seed = torch.tensor([12345 + i], dtype=torch.int64, device=device)
                out[f"b2_fwd_{B}x{T}_p{p}_ms"] = back_to_back_ms(
                    torch, attention_fwd_launch(torch, att, q, k, v, lens, seed, scale, p), ATTN_REPS)
                out[f"b2_fwd_wrapper_{B}x{T}_p{p}_ms"] = back_to_back_ms(
                    torch, lambda: att.fused_attention(q, k, v, lens, seed, scale, p), ATTN_REPS)
        for i, (B, t_x, t_y) in enumerate(B4_SHAPES):
            value, mask = cs.mas_inputs(B, t_x, t_y, 900 + i, False, device)
            out[f"b4_{B}x{t_x}x{t_y}_ms"] = back_to_back_ms(
                torch, lambda: mas_ops.maximum_path_auto(value, mask), ATTN_REPS)
    return out


def lm_and_glow_steps(torch, cs, device, card) -> dict:
    """The LM train step at batch 8 and 64, phase 15's gradient median, the
    Glow train step (B3 route) and the val step."""
    out = {}
    model = cs.build_model(device, *cs.audio_batch(cs.BATCH, cs.SAMPLES, seed=5))
    vq_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    lm = cs.phase_lm_train(device, card, vq_state)
    for B in cs.LM_BATCHES:
        out[f"lm_b{B}_step_ms"] = lm[B]["step_ms"]
    del lm
    torch.cuda.empty_cache()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):  # a parent's phase_lm_vs_cpu returns nothing
        cs.phase_lm_vs_cpu(device, card, vq_state)
    out["lm_vs_cpu_grad_median"] = float(re.search(r"median ([0-9.e+-]+)", printed.getvalue()).group(1))
    torch.cuda.empty_cache()
    res = cs.phase_glow_train(device, card)
    out["glow_step_b3_ms"] = res["step_ms"]
    del res
    torch.cuda.empty_cache()
    out["glow_val_ms"] = cs.phase_glow_val(cs.build_glow(device, cs.GLOW_SEED), device, card)["step_ms"]
    return out


def profile_stages(torch, fn, keep) -> dict:
    """Device time a call by kernel name (torch.profiler over 3 calls of
    ``fn``), for the kernels whose names ``keep`` accepts; chip_smoke's
    kernel_times, kept here because a parent tree's chip_smoke.py may not
    have it."""
    return {name: ms for name, (ms, _) in launch_kinds(torch, fn).items() if keep(name)}


def bf16_forward(torch, cs, gh, device) -> dict:
    """B1's bf16 forward back to back at p=0 and 0.1 summed over the VQ-VAE's
    and VQ-TTS's block shapes, then its device time by kernel at 16 x
    STAGE_T frames (p=TILE_P; every kernel of the call, the wrapper's
    copies included) and a sha256 of its output there."""
    import hashlib

    out = {}
    shapes = (("vqvae", cs.BLOCK_TS, cs.BATCH, 4), ("vqtts", cs.VQTTS_BLOCK_TS, cs.VQTTS_BATCH, cs.VQTTS_DEPTH))
    with torch.no_grad():
        for name, block_ts, batch, depth in shapes:
            w = cs.to_bf16(cs.block_weights(device, seed=1, depth=depth))
            for p in FWD_PS:
                out[f"bf16_fwd_{name}_p{p}_ms"] = 0.0
            for i, T in enumerate(block_ts):
                x, lens, _, _ = cs.block_inputs(T, batch, 200 + i, device)
                x = x.to(torch.bfloat16)
                for p in FWD_PS:
                    out[f"bf16_fwd_{name}_p{p}_ms"] += back_to_back_ms(
                        torch, lambda: gh.gated_hifi(x, lens, w, 1.0, p, 12345), FWD_REPS, warmup=1)
                del x, lens
                torch.cuda.empty_cache()
        w = cs.to_bf16(cs.block_weights(device, seed=1, depth=4))
        x, lens, _, _ = cs.block_inputs(STAGE_T, cs.BATCH, 7, device)
        x = x.to(torch.bfloat16)
        y = gh.gated_hifi(x, lens, w, 1.0, TILE_P, 12345)
        torch.cuda.synchronize()
        out["fwd_output_sha256"] = hashlib.sha256(y.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        del y
        out["fwd_stage_ms"] = profile_stages(torch, lambda: gh.gated_hifi(x, lens, w, 1.0, TILE_P, 12345),
                                             lambda n: True)
    torch.cuda.empty_cache()
    return out


def bf16_stages(torch, cs, gh, device) -> dict:
    """The bf16 tile passes' device time by kernel at 16 x STAGE_T frames
    (p=TILE_P; torch.profiler over 3 calls, ms a call) and a sha256 of what
    one call writes."""
    import hashlib

    w = cs.to_bf16(cs.block_weights(device, seed=1, depth=4))
    x, lens, _, g = cs.block_inputs(STAGE_T, cs.BATCH, 7, device)
    x, g = x.to(torch.bfloat16), g.to(torch.bfloat16)
    args = (x, lens, w, g, 1.0, TILE_P, 12345)
    with torch.no_grad():
        dx, bufs = gh.backward_buffers(*args)
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in (dx, bufs.a, bufs.h1, bufs.dzp, bufs.dc, bufs.dz, bufs.u, bufs.gv, bufs.bias):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        del dx, bufs
        stages = profile_stages(torch, lambda: gh.backward_buffers(*args), lambda n: "bwd16" in n or "kernel" in n)
    torch.cuda.empty_cache()
    return {"stage_ms": stages, "outputs_sha256": digest.hexdigest()}


def launch_kinds(torch, fn) -> dict:
    """name -> (device ms a call, launches a call) of every kernel of ``fn``
    (torch.profiler over 3 calls, the wrapper's own copies included)."""
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
            ms, n = kinds.get(name, (0.0, 0.0))
            kinds[name] = (ms + t / 3 / 1e3, n + e.count / 3)
    return kinds


def whole_kinds(torch, fn, launches: int, tries: int = 4):
    """launch_kinds(torch, fn) once it counts ``launches`` kernels a call,
    each kind a whole number of times: torch.profiler drops a launch now
    and then, so a profile that misses one is taken again, up to ``tries``
    times; None if none was whole."""
    for _ in range(tries):
        kinds = launch_kinds(torch, fn)
        if sum(n for _, n in kinds.values()) == launches and all(n == int(n) for _, n in kinds.values()):
            return kinds
    return None


def glow_bf16_inputs(torch, np, cs, wn_ops, device) -> tuple:
    """glow_inputs cast as chip_smoke.phase_bf16_flow_step casts them: the
    conditioner's weights, x and the cotangents bf16; aln, alb and mt fp32
    of their bf16 values."""
    x, lens, valid, aln, alb, mt, w, g_xc, g_out, seed = glow_inputs(torch, np, cs, wn_ops, device)
    w = wn_ops.WNWeights.from_flat([t.to(torch.bfloat16) for t in w.flat()], w.dilations)
    aln, alb, mt = (t.to(torch.bfloat16).float().contiguous() for t in (aln, alb, mt))
    x, g_xc, g_out = (t.to(torch.bfloat16).contiguous() for t in (x, g_xc, g_out))
    return x, lens, valid, aln, alb, mt, w, g_xc, g_out, seed


def bf16_wn_backwards(torch, np, cs, wn_ops, fs_ops, device, times: bool = True) -> dict:
    """B3's and B6's bf16 backwards at (8, 384), p = 0 and B3_DROP: back to
    back and a call (median of CUDA-event timings of single calls, the
    wrapper's host time included), their device time by launch kind at
    both rates (``times``), and at B3_DROP a sha256 of dx and every
    gradient. B3's x0 is the first-half view of x, as the B3 route passes
    it."""
    x, lens, _, aln, alb, mt, w, g_xc, g_out, seed = glow_bf16_inputs(torch, np, cs, wn_ops, device)
    x0 = x[..., :x.shape[2] // 2]
    calls = {"b3": lambda p: wn_ops.wn_coupling_backward(x0, lens, w, g_out, seed, p),
             "b6": lambda p: fs_ops.flow_step_backward(x, lens, aln, alb, mt, w, g_xc, g_out, seed, p)}
    out = {}
    with torch.no_grad():
        for name, call in calls.items():
            for p in (0.0, cs.B3_DROP) if times else ():
                out[f"{name}_bf16_bwd_p{p}_ms"] = back_to_back_ms(torch, lambda: call(p), GLOW_BWD_REPS)
                out[f"{name}_bf16_bwd_p{p}_call_ms"] = cs.cuda_ms(lambda: call(p), reps=20, warmup=3)
                out[f"{name}_bf16_bwd_p{p}_kinds"] = launch_kinds(torch, lambda: call(p))
            res = call(cs.B3_DROP)
            out[f"{name}_bf16_bwd_sha256"] = sha256_of(
                torch, [leaf for t in res for leaf in (t.flat() if isinstance(t, wn_ops.WNWeights) else (t,))])
            del res
    torch.cuda.empty_cache()
    return out


def bf16_wn_forwards(torch, np, cs, wn_ops, fs_ops, device, times: bool = True) -> dict:
    """B3's and B6's bf16 forwards at (8, 384), p = 0 and B3_DROP (the
    inputs of bf16_wn_backwards): back to back, a call (the wrapper's host
    time included), their device time by launch kind at both rates
    (``times``), and at B3_DROP a sha256 of out (B6: xc, then out)."""
    x, lens, _, aln, alb, mt, w, _, _, seed = glow_bf16_inputs(torch, np, cs, wn_ops, device)
    x0 = x[..., :x.shape[2] // 2]
    calls = {"b3": lambda p: (wn_ops.wn_coupling(x0, lens, w, seed, p),),
             "b6": lambda p: fs_ops.flow_step(x, lens, aln, alb, mt, w, seed, p)}
    out = {}
    with torch.no_grad():
        for name, call in calls.items():
            for p in (0.0, cs.B3_DROP) if times else ():
                out[f"{name}_bf16_fwd_p{p}_ms"] = back_to_back_ms(torch, lambda: call(p), GLOW_BWD_REPS)
                out[f"{name}_bf16_fwd_p{p}_call_ms"] = cs.cuda_ms(lambda: call(p), reps=20, warmup=3)
                out[f"{name}_bf16_fwd_p{p}_kinds"] = launch_kinds(torch, lambda: call(p))
            res = call(cs.B3_DROP)
            out[f"{name}_bf16_fwd_sha256"] = sha256_of(torch, res)
            del res
    torch.cuda.empty_cache()
    return out


def bf16_enc_inputs(torch, np, cs, device):
    """(fp32 weights, their bf16 cast, seed, cases): the Glow encoder's first
    layer cast as chip_smoke.enc_bf16 casts it, and for each
    chip_smoke.B5_SHAPES (i, B, T, x, lens, g) in bf16 as
    phase_bf16_enc_layer draws them."""
    w32 = cs.build_glow(device, cs.GLOW_SEED).encoder.layer_weights(0)
    w32 = w32.with_tensors([t.detach() for t in w32.tensors().values()])
    w16 = cs.enc_bf16(w32)
    seed = torch.tensor([5353], dtype=torch.int64, device=device)
    cases = []
    for i, (B, T) in enumerate(cs.B5_SHAPES):
        rng = np.random.RandomState(840 + i)
        lens = torch.from_numpy(cs.ragged(rng, B, max(1, T // 2), T).astype(np.int32)).to(device)
        x = torch.from_numpy(rng.randn(B, T, w16.wq.shape[0]).astype(np.float32)).to(device).to(torch.bfloat16)
        g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(device).to(torch.bfloat16)
        cases.append((i, B, T, x, lens, g))
    return w32, w16, seed, cases


def sha256_of(torch, tensors) -> str:
    import hashlib

    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def bf16_enc_hashes(torch, np, cs, device) -> dict:
    """sha256 of B5's bf16 forward outputs at every chip_smoke.B5_SHAPES,
    p = 0 and 0.1 (phase_bf16_enc_layer's weights; bf16_enc_backwards'
    inputs), and of its bf16 backward's dx and gradients at (8, 256), p =
    B5_DROP: B5 shares the bf16 engine with B3 and B6, so a change to
    either is held bit for bit against the other tree."""
    from speech_masters_thesis_tpu_torch.ops import enc_layer as enc_ops

    _, w16, seed, cases = bf16_enc_inputs(torch, np, cs, device)
    outs, grads = [], []
    with torch.no_grad():
        for i, B, T, x, lens, g in cases:
            outs += [enc_ops.enc_layer(x, lens, w16, seed, p) for p in (0.0, 0.1)]
            if i == BF16_ENC_SHAPES[0]:
                dx, gw = enc_ops.enc_layer_backward(x, lens, w16, g, seed, cs.B5_DROP)
                grads = [dx, *gw.values()]
    out = {"b5_bf16_fwd_sha256": sha256_of(torch, outs), "b5_bf16_bwd_sha256": sha256_of(torch, grads)}
    torch.cuda.empty_cache()
    return out


def bf16_enc_forwards(torch, np, cs, device) -> dict:
    """B5's bf16 forward at B5_SHAPES[i] for i in BF16_ENC_SHAPES, p = 0 and
    B5_DROP (phase_bf16_enc_layer's inputs), B5's fp32 forward beside it on
    the same values in fp32: back to back, a call (chip_smoke.cuda_ms, the
    wrapper's host time included), the bf16 forward's device time and
    launches by launch kind (torch.profiler over 3 calls)."""
    from speech_masters_thesis_tpu_torch.ops import enc_layer as enc_ops

    w32, w16, seed, cases = bf16_enc_inputs(torch, np, cs, device)
    out = {}
    with torch.no_grad():
        for i, B, T, x, lens, _ in cases:
            if i not in BF16_ENC_SHAPES:
                continue
            for p in (0.0, cs.B5_DROP):
                for mode, args in (("bf16", (x, lens, w16)), ("fp32", (x.float(), lens, w32))):
                    call = lambda: enc_ops.enc_layer(*args, seed, p)  # noqa: E731
                    key = f"b5_{mode}_fwd_{B}x{T}_p{p}"
                    out[f"{key}_ms"] = back_to_back_ms(torch, call, GLOW_BWD_REPS)
                    out[f"{key}_call_ms"] = cs.cuda_ms(call, reps=20, warmup=3)
                    if mode == "bf16":
                        out[f"{key}_kinds"] = launch_kinds(torch, call)
    torch.cuda.empty_cache()
    return out


def bf16_glow_steps(torch, cs, device, card) -> dict:
    """The bf16 Glow train step (chip_smoke.phase_bf16_glow_train) on the B3
    and the B6 route in turns (b3, b6, b6, b3): each run's median of steps
    2-10, its peak, and the kernels' ms and the device's busy share of one
    more step under torch.profiler; the medians of the two runs a route."""
    runs = {"b3": [], "b6": []}
    for route in ("b3", "b6", "b6", "b3"):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = cs.phase_bf16_glow_train(device, card, flow_step=route == "b6")
        kernels = re.search(r"kernels ([0-9.]+) ms of ([0-9.]+) ms wall", printed.getvalue())
        runs[route].append({"ms": res["step_ms"], "peak": res["peak"], "busy": res["busy"],
                            "kernel_ms": float(kernels.group(1))})
        del res
        torch.cuda.empty_cache()
    out = {}
    for route, rs in runs.items():
        for key in ("ms", "peak", "busy", "kernel_ms"):
            out[f"bf16_glow_{route}_step_{key}"] = statistics.median(r[key] for r in rs)
        out[f"bf16_glow_{route}_step_runs"] = rs
    return out


def bf16_enc_backwards(torch, np, cs, device) -> dict:
    """B5's bf16 backward at B5_SHAPES[i] for i in BF16_ENC_SHAPES, p = 0 and
    B5_DROP (phase_bf16_enc_layer's inputs), B5's fp32 backward beside it on
    the same values in fp32: back to back, a call, the bf16 backward's device
    time by launch kind, and at the first shape and B5_DROP a sha256 of dx
    and every gradient."""
    from speech_masters_thesis_tpu_torch.ops import enc_layer as enc_ops

    w32, w16, seed, cases = bf16_enc_inputs(torch, np, cs, device)
    out = {}
    with torch.no_grad():
        for i, B, T, x, lens, g in cases:
            if i not in BF16_ENC_SHAPES:
                continue
            for p in (0.0, cs.B5_DROP):
                for mode, args in (("bf16", (x, lens, w16, g)), ("fp32", (x.float(), lens, w32, g.float()))):
                    call = lambda: enc_ops.enc_layer_backward(*args, seed, p)  # noqa: E731
                    key = f"b5_{mode}_bwd_{B}x{T}_p{p}"
                    out[f"{key}_ms"] = back_to_back_ms(torch, call, GLOW_BWD_REPS)
                    out[f"{key}_call_ms"] = cs.cuda_ms(call, reps=20, warmup=3)
                    if mode == "bf16":
                        out[f"{key}_kinds"] = launch_kinds(torch, call)
            if i == BF16_ENC_SHAPES[0]:
                dx, grads = enc_ops.enc_layer_backward(x, lens, w16, g, seed, cs.B5_DROP)
                out["b5_bf16_bwd_sha256"] = sha256_of(torch, [dx, *grads.values()])
                del dx, grads
    torch.cuda.empty_cache()
    return out


def bf16_enc_steps(torch, cs, device, card) -> dict:
    """The bf16 Glow train step on the B3 and the B6 route and the bf16
    VQ-TTS train step on B5's route in turns (b3, b6, vqtts, vqtts, b6, b3):
    each run's median step, its peak, and the kernels' ms and the device's
    busy share of one more step under torch.profiler; the medians of the two
    runs a route."""
    runs = {"glow_b3": [], "glow_b6": [], "vqtts_b5": []}
    for route in ("glow_b3", "glow_b6", "vqtts_b5", "vqtts_b5", "glow_b6", "glow_b3"):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            if route == "vqtts_b5":
                res = cs.phase_bf16_vqtts_train(device, card, fused_encoder=True)
            else:
                res = cs.phase_bf16_glow_train(device, card, flow_step=route == "glow_b6")
        kernels = re.search(r"kernels ([0-9.]+) ms of ([0-9.]+) ms wall", printed.getvalue())
        runs[route].append({"ms": res["step_ms"], "peak": res["peak"], "busy": res["busy"],
                            "kernel_ms": float(kernels.group(1))})
        del res
        torch.cuda.empty_cache()
    out = {}
    for route, rs in runs.items():
        for key in ("ms", "peak", "busy", "kernel_ms"):
            out[f"bf16_{route}_step_{key}"] = statistics.median(r[key] for r in rs)
        out[f"bf16_{route}_step_runs"] = rs
    return out


def host_ms(torch, fn, n: int = 50) -> float:
    """Host time a call of ``fn`` without waiting for the card (its checks,
    allocations and launches: the enqueue), over n calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def bf16_attn_kernels(torch, np, cs, att, device) -> dict:
    """B2's bf16 forward and backward at chip_smoke's ATTN_SHAPES, p = 0 and
    P_DROP, on phase_bf16_attention's inputs: back to back, a call, the
    host time a call, the device time by launch kind (None where no
    profile counted every launch), and one sha256 of o, dq, dk and dv over
    them all."""
    scale = 1.0 / np.sqrt(cs.ATTN_DIM)
    out, outs = {}, []
    for i, (B, T) in enumerate(cs.ATTN_SHAPES):
        packed, lens, g = cs.packed_qkv(B, T, 520 + i, device)
        packed, g = packed.to(torch.bfloat16), g.to(torch.bfloat16)
        q, k, v = cs.heads(packed)
        for p in (0.0, cs.P_DROP):
            seed = torch.tensor([22345 + i], dtype=torch.int64, device=device)
            key = f"b2_bf16_{B}x{T}_p{p}"
            with torch.no_grad():
                fwd = lambda: att.fused_attention(q, k, v, lens, seed, scale, p)  # noqa: E731
                out[f"{key}_fwd_ms"] = back_to_back_ms(
                    torch, cs.attention_fwd_launch(q, k, v, lens, seed, scale, p), BF16_ATTN_REPS)
                out[f"{key}_fwd_call_ms"] = cs.cuda_ms(fwd, reps=20, warmup=3)
                out[f"{key}_fwd_host_ms"] = host_ms(torch, fwd)
                out[f"{key}_fwd_kinds"] = whole_kinds(torch, fwd, 1)
                o, stats = att._launch_fwd(q, k, v, lens, seed, scale, p)
                bwd = lambda: att.attention_backward(q, k, v, o, stats, lens, seed, g, scale, p)  # noqa: E731
                out[f"{key}_bwd_ms"] = back_to_back_ms(torch, bwd, BF16_ATTN_REPS)
                out[f"{key}_bwd_wrapper_call_ms"] = cs.cuda_ms(bwd, reps=20, warmup=3)
                out[f"{key}_bwd_host_ms"] = host_ms(torch, bwd)
                out[f"{key}_bwd_kinds"] = whole_kinds(torch, bwd, 2)
                outs += [o, *bwd()]
            qkv = packed.clone().requires_grad_(True)
            o_grad = att.fused_attention(*cs.heads(qkv), lens, seed, scale, p)
            grad = lambda: torch.autograd.grad(o_grad, qkv, g, retain_graph=True)  # noqa: E731
            out[f"{key}_bwd_call_ms"] = cs.cuda_ms(grad, reps=20, warmup=3)
            out[f"{key}_bwd_autograd_host_ms"] = host_ms(torch, grad)
            del o_grad, qkv, o, stats
        torch.cuda.empty_cache()
    out["b2_bf16_sha256"] = sha256_of(torch, outs)
    return out


def b2_fp32_hashes(torch, np, cs, att, device) -> dict:
    """sha256 of B2's fp32 forward (o) and backward (dq, dk, dv) at
    ATTN_SHAPES[0], p = 0 and P_DROP, on phase_attention's packed inputs:
    B2's fp32 kernels share attention_common.cuh with the bf16 ones."""
    B, T = cs.ATTN_SHAPES[0]
    packed, lens, g = cs.packed_qkv(B, T, 500, device)
    q, k, v = cs.heads(packed)
    scale = 1.0 / np.sqrt(cs.ATTN_DIM)
    fwd, bwd = [], []
    with torch.no_grad():
        for p in (0.0, cs.P_DROP):
            seed = torch.tensor([12345], dtype=torch.int64, device=device)
            o, stats = att._launch_fwd(q, k, v, lens, seed, scale, p)
            fwd.append(o)
            bwd += att.attention_backward(q, k, v, o, stats, lens, seed, g, scale, p)
    return {"b2_fp32_fwd_sha256": sha256_of(torch, fwd), "b2_fp32_bwd_sha256": sha256_of(torch, bwd)}


def bf16_lm_steps(torch, cs, device, card) -> dict:
    """The bf16 LM train step (chip_smoke.phase_bf16_lm_train's model, batch
    and seeds) at each of LM_BATCHES: chip_smoke.bf16_steps (the median of
    steps 2-10, the peak, launches a step, the busy share of one more step),
    then the kernels of one more step by launch kind: their ms a step and
    B2's bf16 kernels' among them."""
    model = cs.build_model(device, *cs.audio_batch(cs.BATCH, cs.SAMPLES, seed=5))
    vq_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    out = {}
    for batch_n in cs.LM_BATCHES:
        lm = cs.build_lm(device, vq_state, seed=cs.LM_SEED + 2)
        opt, schedule = cs.lm_optimizer(lm)
        state = cs.TrainState.create(lm, opt, use_ema=True)
        step = cs.make_train_step(schedule, cs.default_mu(batch_n, 1), use_ema=True, bf16=True)
        batch = cs.lm_tokens(batch_n, cs.LM_T, seed=60 + batch_n, device=device)
        frozen = frozenset(n for n, keep in cs.harness.frozen_param_mask(lm).items() if not keep)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = cs.bf16_steps(f"[bf16 lm train b{batch_n}]", state, step, batch, cs.BF16_TRAIN_STEPS,
                                cs.lm_bf16_counts, card, frozen)
        kinds = launch_kinds(torch, lambda: step(state, batch, cs.TRAIN_SEED))
        b2 = {n: v for n, v in kinds.items() if "attention_bf16" in n}
        key = f"lm_bf16_b{batch_n}"
        out.update({f"{key}_step_ms": res["step_ms"], f"{key}_peak_gib": res["peak"], f"{key}_busy": res["busy"],
                    f"{key}_kernel_ms": sum(t for t, _ in kinds.values()),
                    f"{key}_b2_kernel_ms": sum(t for t, _ in b2.values()),
                    f"{key}_launches_per_step": [list(c) for c in res["per_step"]], f"{key}_b2_kinds": b2})
        del state, lm, opt, step, batch
        torch.cuda.empty_cache()
    return out


def bf16_backward(torch, cs, gh, device, card, step: bool = True) -> dict:
    """B1's bf16 tile passes and reduction back to back (p=TILE_P) summed
    over the VQ-VAE's and VQ-TTS's block shapes, then (``step``) the bf16
    VQ-VAE step."""
    out = {}
    shapes = (("vqvae", cs.BLOCK_TS, cs.BATCH, 4), ("vqtts", cs.VQTTS_BLOCK_TS, cs.VQTTS_BATCH, cs.VQTTS_DEPTH))
    with torch.no_grad():
        for name, block_ts, batch, depth in shapes:
            w = cs.to_bf16(cs.block_weights(device, seed=1, depth=depth))
            out[f"bf16_tiles_{name}_ms"] = out[f"bf16_reduction_{name}_ms"] = 0.0
            for i, T in enumerate(block_ts):
                x, lens, _, g = cs.block_inputs(T, batch, 200 + i, device)
                x, g = x.to(torch.bfloat16), g.to(torch.bfloat16)
                args = (x, lens, w, g, 1.0, TILE_P, 12345)
                out[f"bf16_tiles_{name}_ms"] += back_to_back_ms(
                    torch, lambda: gh.backward_buffers(*args), TILE_REPS, warmup=1)
                _, bufs = gh.backward_buffers(*args)
                out[f"bf16_reduction_{name}_ms"] += back_to_back_ms(
                    torch, lambda: gh.weight_grad_reduce(x, bufs, w.kernels, w.dilations), TILE_REPS, warmup=1)
                del x, lens, g, bufs, args
                torch.cuda.empty_cache()
    if not step:
        return out
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):  # a parent's phase_bf16_train returns no peak
        out["bf16_step_ms"] = cs.phase_bf16_train(device, card)["step_ms"]
    text = printed.getvalue()
    out["bf16_step_peak_gib"] = float(re.search(r"max_memory_allocated a step: bf16 ([0-9.]+) GiB", text).group(1))
    out["fp32_step_in_turns_ms"] = float(re.search(r"medians of steps 2-\d+: bf16 [0-9.]+ ms, fp32 ([0-9.]+) ms",
                                                   text).group(1))
    torch.cuda.empty_cache()
    return out


def worker(tree: str, glow_only: bool, mode: str = "") -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import chip_smoke as cs

    if mode == "--ptxas":
        from speech_masters_thesis_tpu_torch.ops import _build

        return {"tree": tree, "ptxas": mangled_lines(_build.compile_library(_build.library_path()))}
    from speech_masters_thesis_tpu_torch.ops import attention as att
    from speech_masters_thesis_tpu_torch.ops import flow_step as fs_ops
    from speech_masters_thesis_tpu_torch.ops import gated_hifi as gh
    from speech_masters_thesis_tpu_torch.ops import wn_coupling as wn_ops

    card = cs.phase_device()
    device = cs.cuda_device()
    if mode == "--bf16-tiles":
        from speech_masters_thesis_tpu_torch.ops import _build

        _build.build()
        out = {"tree": tree, "card": card, "attention_bwd": {}}
        out.update(bf16_backward(torch, cs, gh, device, card, step=False))
        out.update(bf16_stages(torch, cs, gh, device))
        return out
    cs.phase_build()
    out = {"tree": tree, "card": card, "attention_bwd": {}}
    if mode == "--b5":
        out.update(enc_layer_times(torch, np, cs, device))
        out.update(step_grad_errors(torch, cs, device))
        return out
    if mode == "--bf16":
        out.update(bf16_backward(torch, cs, gh, device, card))
        return out
    if mode == "--bf16-fwd":
        out.update(bf16_forward(torch, cs, gh, device))
        out.update(bf16_backward(torch, cs, gh, device, card))
        return out
    if mode in ("--bf16-wn", "--bf16-wn-kernels"):
        out.update(bf16_wn_forwards(torch, np, cs, wn_ops, fs_ops, device))
        out.update(bf16_wn_backwards(torch, np, cs, wn_ops, fs_ops, device))
        out.update(bf16_enc_hashes(torch, np, cs, device))
        if mode == "--bf16-wn":
            out.update(bf16_glow_steps(torch, cs, device, card))
        return out
    if mode in ("--bf16-enc", "--bf16-enc-kernels"):
        out.update(bf16_enc_forwards(torch, np, cs, device))
        out.update(bf16_enc_backwards(torch, np, cs, device))
        out.update(bf16_wn_forwards(torch, np, cs, wn_ops, fs_ops, device, times=False))
        out.update(bf16_wn_backwards(torch, np, cs, wn_ops, fs_ops, device, times=False))
        if mode == "--bf16-enc":
            out.update(bf16_enc_steps(torch, cs, device, card))
        return out
    if mode in ("--bf16-attn", "--bf16-attn-kernels"):
        out.update(bf16_attn_kernels(torch, np, cs, att, device))
        out.update(b2_fp32_hashes(torch, np, cs, att, device))
        out.update(bf16_enc_hashes(torch, np, cs, device))
        if mode == "--bf16-attn":
            out.update(bf16_lm_steps(torch, cs, device, card))
        return out
    if mode == "--b2b4":
        out.update(b2_b4_times(torch, np, cs, att, device))
        out.update(codec_kernels(torch, np, cs, att, gh, device))
        inputs = glow_inputs(torch, np, cs, wn_ops, device)
        out.update(glow_forwards(torch, cs, wn_ops, fs_ops, inputs))
        out.update(glow_backwards(torch, cs, wn_ops, fs_ops, inputs))
        del inputs
        out.update(enc_layer_times(torch, np, cs, device))
        torch.cuda.empty_cache()
        out.update(lm_and_glow_steps(torch, cs, device, card))
        return out
    if not glow_only:
        out.update(codec_and_lm(torch, np, cs, att, gh, device, card))
    inputs = glow_inputs(torch, np, cs, wn_ops, device)
    out.update(glow_forwards(torch, cs, wn_ops, fs_ops, inputs))
    out.update(glow_backwards(torch, cs, wn_ops, fs_ops, inputs))
    del inputs
    out.update(enc_layer_times(torch, np, cs, device))
    torch.cuda.empty_cache()
    out.update(glow_steps(torch, cs, device, card))
    return out


def mangled_lines(report: str) -> list:
    """One line per kernel of an nvcc -Xptxas -v report: its mangled name (a
    file's anonymous namespace, named after its path, with the path's hash
    and length removed), then its registers, shared memory and spills."""
    lines, name, spills = [], None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = without_io(re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N_", line.split("'")[1]))
        elif "spill stores" in line:
            spills = line.strip()
        elif "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}, {spills}")
            name = None
    return lines


def without_io(name: str) -> str:
    """A mangled name without the float IO template argument that the fp32
    instances of wgrad_rows, wgrad_mma, the encoder's kernels, conv_mma's
    weight packing (after their tag, and WHOLE or FORMS) and conv_mma's
    kernel (its last) took in trees that still had a bf16 mode there, so
    that their lines compare by kernel across that change."""
    if name.startswith("_ZN8conv_mma15conv_mma_kernel"):
        return re.sub(r"(Li\d+E)fEEv", r"\1EEv", name, count=1)
    if not re.match(r"_ZN(10wgrad_rows|9wgrad_mma|9enc_layer|8conv_mma19pack_weights_kernel)", name):
        return name
    return re.sub(r"(Tag(?:ELb[01]|ELi\d+)?E)fEEv", r"\1EEv", name, count=1)


def is_changed_kernel(line: str) -> bool:
    """A ptxas line of an instance the change may alter (PTXAS_CHANGED)."""
    return any(piece in line.split(":")[0] for piece in PTXAS_CHANGED)


def is_bf16(line: str) -> bool:
    """A ptxas line of a bf16 instance (a Bfloat* tag, the bf16 I/O type, the bf16 attention
    kernels, B1's bf16 backward or the bf16 MMA probe)."""
    name = line.split(":")[0]
    return any(piece in name for piece in ("Bfloat", "bf16", "bfloat16", "5bwd16"))


def print_attn(results: list) -> None:
    """--bf16-attn's lines: each number by tree, B2's bf16 kernels and the
    LM steps' B2 kernels by launch kind, each sha256 against the first
    tree's."""
    card = results[0]["card"]
    for key in [k for k, v in results[0].items() if isinstance(v, (int, float)) and not isinstance(v, bool)
                and k != "seconds"]:
        print(f"[ab] {key}: " + ", ".join(f"{r['tree']} {r[key]:.4f}" for r in results) + f" [{card}]")
    for key in [k for k in results[0] if k.endswith("_kinds")]:
        for res in results:
            kinds = res[key]
            print(f"[ab] {res['tree']} {key[:-6]} by launch kind (ms a call, launches a call): "
                  + ("not measured (no profile counted every launch)" if kinds is None else
                     ", ".join(f"{n} {t:.4f} x{c:g}" for n, (t, c) in sorted(kinds.items(), key=lambda kv: -kv[1][0]))
                     + f" (sum {sum(t for t, _ in kinds.values()):.4f} ms, {sum(c for _, c in kinds.values()):g} "
                     "launches)") + f" [{res['card']}]")
    for key in [k for k in results[0] if k.endswith("_launches_per_step")]:
        print(f"[ab] {key} (fp32 B2 fwd, bwd, bf16 B2 fwd, bwd): "
              + ", ".join(f"{r['tree']} {r[key]}" for r in results))
    for key in ("b2_bf16_sha256", "b2_fp32_fwd_sha256", "b2_fp32_bwd_sha256", "b5_bf16_fwd_sha256",
                "b5_bf16_bwd_sha256"):
        print(f"[ab] {key}: " + ", ".join(f"{r['tree']} {r[key][:16]}" for r in results)
              + f"; all equal: {len({r[key] for r in results}) == 1}")


def main() -> None:
    args = sys.argv[1:]
    glow_only = "--glow" in args
    modes = ("--b5", "--b2b4", "--ptxas", "--bf16", "--bf16-tiles", "--bf16-fwd", "--bf16-wn", "--bf16-wn-kernels",
             "--bf16-enc", "--bf16-enc-kernels", "--bf16-attn", "--bf16-attn-kernels")
    mode = next((a for a in args if a in modes), "")
    args = [a for a in args if a not in ("--glow", *modes)]
    if args[:1] == ["--worker"]:
        print("AB_RESULT " + json.dumps(worker(args[1], glow_only, mode)), flush=True)
        return
    trees = args
    if len(trees) < 2:
        raise SystemExit("usage: python3 ab_backward.py [--glow | --b5 | --b2b4 | --ptxas | --bf16 | --bf16-tiles | "
                         "--bf16-fwd | --bf16-wn | --bf16-wn-kernels | --bf16-enc | --bf16-enc-kernels | "
                         "--bf16-attn | --bf16-attn-kernels] "
                         "TREE TREE [TREE ...] "
                         "(e.g. parent "
                         "change change parent)")
    results = []
    for tree in trees:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree]
                              + (["--glow"] if glow_only else []) + ([mode] if mode else []),
                              capture_output=True, text=True, timeout=1800)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            raise SystemExit(f"worker for {tree} failed with exit code {proc.returncode}")
        res = json.loads(lines[-1][len("AB_RESULT "):])
        res["seconds"] = time.perf_counter() - t0
        if mode != "--ptxas":
            print(json.dumps(res), flush=True)
        results.append(res)
    if mode == "--ptxas":
        def count(res, bf16: bool):
            return collections.Counter(ln for ln in res["ptxas"] if not is_changed_kernel(ln) and is_bf16(ln) == bf16)
        for bf16, kind in ((False, "fp32"), (True, "bf16")):
            first = count(results[0], bf16)
            for res in results:
                lines = count(res, bf16)
                print(f"[ptxas] {res['tree']}: {sum(lines.values())} {kind} lines outside PTXAS_CHANGED "
                      f"{PTXAS_CHANGED}, equal to {results[0]['tree']}'s ({sum(first.values())}) as multisets: "
                      f"{lines == first}; only here {dict(lines - first)}; only there {dict(first - lines)}")
        for res in results:
            print(f"[ptxas] {res['tree']} {PTXAS_CHANGED}: "
                  + " | ".join(ln for ln in res["ptxas"] if is_changed_kernel(ln)))
        return
    if mode in ("--bf16-attn", "--bf16-attn-kernels"):
        print_attn(results)
        return
    if mode in ("--bf16-wn", "--bf16-wn-kernels", "--bf16-enc", "--bf16-enc-kernels"):
        for key in [k for k, v in results[0].items() if isinstance(v, float) and k != "seconds"]:
            print(f"[ab] {key}: " + ", ".join(f"{r['tree']} {r[key]:.4f}" for r in results)
                  + f" [{results[0]['card']}]")
        for key in [k for k in results[0] if k.endswith("_kinds")]:
            for res in results:
                kinds = res[key]
                print(f"[ab] {res['tree']} {key[:-6]} by launch kind (ms a call, launches a call): "
                      + ", ".join(f"{n} {t:.4f} x{c:g}"
                                  for n, (t, c) in sorted(kinds.items(), key=lambda kv: -kv[1][0]))
                      + f" (sum {sum(t for t, _ in kinds.values()):.4f} ms, {sum(c for _, c in kinds.values()):g} "
                      f"launches) [{res['card']}]")
        shas = ("b3_bf16_fwd_sha256", "b6_bf16_fwd_sha256", "b3_bf16_bwd_sha256", "b6_bf16_bwd_sha256",
                *(() if mode.startswith("--bf16-enc") else ("b5_bf16_fwd_sha256",)), "b5_bf16_bwd_sha256")
        for key in shas:
            what = ("out at every B5_SHAPES, p = 0 and 0.1" if key == "b5_bf16_fwd_sha256" else
                    "out (B6: xc and out) at p = B3_DROP" if "_fwd_" in key else
                    f"dx and every gradient at p = {'B5_DROP' if 'b5' in key else 'B3_DROP'}")
            print(f"[ab] {key} ({what}): "
                  + ", ".join(f"{r['tree']} {r[key][:16]}" for r in results)
                  + f"; all equal: {len({r[key] for r in results}) == 1}")
        return
    if mode in ("--bf16", "--bf16-tiles", "--bf16-fwd"):
        for key in [k for k, v in results[0].items() if k.endswith(("_ms", "_gib")) and isinstance(v, float)]:
            print(f"[ab] {key}: " + ", ".join(f"{r['tree']} {r[key]:.4f}" for r in results)
                  + f" [{results[0]['card']}]")
        if mode == "--bf16-tiles":
            for name in results[0]["stage_ms"]:
                print(f"[ab] {name} (16 x {STAGE_T}): "
                      + ", ".join(f"{r['tree']} {r['stage_ms'].get(name, float('nan')):.4f}" for r in results)
                      + f" [{results[0]['card']}]")
            print(f"[ab] outputs_sha256 at 16 x {STAGE_T}: " + ", ".join(f"{r['tree']} {r['outputs_sha256'][:16]}"
                                                              for r in results)
                  + f"; all equal: {len({r['outputs_sha256'] for r in results}) == 1}")
        if mode == "--bf16-fwd":
            for res in results:
                print(f"[ab] {res['tree']} bf16 forward by kernel (16 x {STAGE_T}, p={TILE_P}): "
                      + ", ".join(f"{n} {t:.4f}" for n, t in res["fwd_stage_ms"].items())
                      + f" (sum {sum(res['fwd_stage_ms'].values()):.4f} ms) [{res['card']}]")
            print(f"[ab] bf16 forward output sha256 at 16 x {STAGE_T}, p={TILE_P}: "
                  + ", ".join(f"{r['tree']} {r['fwd_output_sha256'][:16]}" for r in results)
                  + f"; all equal: {len({r['fwd_output_sha256'] for r in results}) == 1}")
        return
    if mode == "--b2b4":
        keys = [k for k in results[0] if k.endswith(("_ms", "_median", " sum")) and k != "seconds"]
        for key in [*results[0]["attention_bwd"], *keys]:
            vals = [r["attention_bwd"][key] if key in r["attention_bwd"] else r[key] for r in results]
            print(f"[ab] {key}: " + ", ".join(f"{r['tree']} {v:.6g}" for r, v in zip(results, vals))
                  + f" [{results[0]['card']}]")
        return
    if mode == "--b5":
        for res in results:
            groups = "; ".join(f"{g} card {res[f'grad_{g}_cuda_median']:.3e} / {res[f'grad_{g}_cuda_worst']:.3e}, "
                               f"cpu {res[f'grad_{g}_cpu_median']:.3e} / {res[f'grad_{g}_cpu_worst']:.3e}"
                               for g in ("all", "b5", "rest"))
            print(f"[b5] {res['tree']}: forward {res['b5_fwd_ms']:.4f} ms, backward {res['b5_bwd_ms']:.4f} ms back to "
                  f"back; phase 25's gradient errors against fp64, median / worst: {groups}; worst parameters "
                  + ", ".join(f"{k} {e:.2e} (cpu {c:.2e})" for k, e, c in res["grad_worst_params"])
                  + f" [{res['card']}]")
        return
    for key in (*results[0]["attention_bwd"], *(f"forward p={p} sum" for p in FWD_PS), "tiles sum",
                "reduction sum", "vqvae_step_ms", "vqvae_step_peak_gib", "encode_decode_ms",
                "encode_decode_peak_gib", "lm_b64_step_ms", "b3_fwd_ms", "b3_fwd_err_over_tol", "b6_fwd_ms",
                "b6_fwd_err_over_tol", "b3_bwd_ms", "b6_bwd_ms", "b5_fwd_ms", "b5_fwd_err_over_tol", "b5_bwd_ms",
                "glow_step_b3_ms", "glow_step_b3_peak_gib",
                "glow_step_b6_ms", "glow_step_b6_peak_gib", "glow_turns_b3_ms", "glow_turns_b6_ms", "glow_val_ms",
                "glow_val_peak_gib", *(f"synth_b{B}_{k}_ms" for B in (1, 8) for k in ("mel", "total"))):
        if key not in results[0] and key not in results[0]["attention_bwd"]:
            continue  # --glow: the codec's and the LM's were not measured
        vals = [r["attention_bwd"][key] if key in r["attention_bwd"] else r[key] for r in results]
        print(f"[ab] {key}: " + ", ".join(f"{r['tree']} {v:.4f}" for r, v in zip(results, vals))
              + f" [{results[0]['card']}]")


if __name__ == "__main__":
    main()
