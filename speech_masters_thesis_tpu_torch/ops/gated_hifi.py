"""GatedHiFi block forward: plain PyTorch version, weight packing, kernel wrapper.

Counterpart of speech_masters_thesis_tpu/ops/pallas/gated_hifi.py
(``fused_gated_hifi``), forward only and without dropout: the inference path
runs the block with dropout off. The CUDA kernel is
``csrc/gated_hifi_fwd.cu``; ``gated_hifi`` launches it for a CUDA tensor and
runs ``gated_hifi_reference`` for a CPU tensor.

Semantics both versions keep:
  * the input arrives pre-masked (``x * mask``);
  * the dilated convs zero-pad only outside [0, T), the array length, so
    inside [len_b, T) the expand bias still reaches valid frames through
    the conv (the reference model does the same);
  * the output is ``(x + scale * v)`` masked per sequence past
    ``min(T, lens[b])``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.ops import _build


@dataclass(frozen=True)
class GatedHiFiWeights:
    """One block's weights in the kernel's layout (all float32).

    wall [W, depth*H] and ball [depth*H]: the branch 1x1 expands side by side.
    ks[d] [k_d, H, H]: branch d's dilated conv as (tap, in, out); cb [depth, H]
    its bias. w1 [depth, H, H] (in, out) and b1 [depth, H]: the branch 1x1s.
    wg [W, W] (in, out) and bg [W]: the gate 1x1. H = 2 * W.
    """

    wall: torch.Tensor
    ball: torch.Tensor
    ks: tuple[torch.Tensor, ...]
    cb: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    wg: torch.Tensor
    bg: torch.Tensor
    dilations: tuple[int, ...]

    @property
    def kernels(self) -> tuple[int, ...]:
        return tuple(k.shape[0] for k in self.ks)


def pack_weights(params: Mapping[str, torch.Tensor], dilations: Sequence[int]) -> GatedHiFiWeights:
    """Per-branch reference ``state_dict`` tensors -> ``GatedHiFiWeights``.

    Keys are the block's own: ``blocks.{d}.0`` (branch expand, Conv1d W->H),
    ``blocks.{d}.1.model.2`` (dilated conv H->H), ``blocks.{d}.1.model.5``
    (branch 1x1 H->H) and ``gate`` (W->W); torch Conv1d weights are
    [out, in, k].
    """
    depth = len(dilations)
    branch = [f"blocks.{d}" for d in range(depth)]
    return GatedHiFiWeights(
        wall=torch.cat([params[f"{p}.0.weight"][:, :, 0].t() for p in branch], dim=1).contiguous(),
        ball=torch.cat([params[f"{p}.0.bias"] for p in branch]).contiguous(),
        ks=tuple(params[f"{p}.1.model.2.weight"].permute(2, 1, 0).contiguous() for p in branch),
        cb=torch.stack([params[f"{p}.1.model.2.bias"] for p in branch]).contiguous(),
        w1=torch.stack([params[f"{p}.1.model.5.weight"][:, :, 0].t() for p in branch]).contiguous(),
        b1=torch.stack([params[f"{p}.1.model.5.bias"] for p in branch]).contiguous(),
        wg=params["gate.weight"][:, :, 0].t().contiguous(),
        bg=params["gate.bias"].contiguous(),
        dilations=tuple(int(d) for d in dilations),
    )


def gated_hifi_reference(x: torch.Tensor, lens: torch.Tensor, w: GatedHiFiWeights,
                         res_scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch GatedHiFi block forward (dropout off).

    x: [B, T, W] pre-masked input; lens: [B] int valid lengths.
    Returns [B, T, W], zero past ``min(T, lens[b])``.
    """
    B, T, W = x.shape
    H = 2 * W
    z_all = x @ w.wall + w.ball                               # [B, T, depth*H]
    ts, ss = [], []
    for d, (kernel, dil) in enumerate(zip(w.ks, w.dilations)):
        z = z_all[..., d * H:(d + 1) * H]
        a = torch.relu(z).transpose(1, 2)                     # [B, H, T]
        k = kernel.shape[0]
        c = F.conv1d(a, kernel.permute(2, 1, 0), w.cb[d],
                     padding=(k - 1) // 2 * dil, dilation=dil).transpose(1, 2)
        h = torch.relu(c) @ w.w1[d] + w.b1[d]
        zp = z + res_scale * h
        ts.append(zp[..., :W])
        ss.append(zp[..., W:])
    # tanh(t) weighted by the softmax over branches of s
    s_max = ss[0]
    for s in ss[1:]:
        s_max = torch.maximum(s_max, s)
    exps = [torch.exp(s - s_max) for s in ss]
    den = exps[0]
    for e in exps[1:]:
        den = den + e
    u = torch.zeros_like(ts[0])
    for t, e in zip(ts, exps):
        u = u + torch.tanh(t) * (e / den)
    v = u @ w.wg + w.bg
    out = x + res_scale * v
    valid = torch.arange(T, device=x.device)[None, :] < lens.to(x.device)[:, None]
    return out * valid[..., None].to(out.dtype)


def gated_hifi(x: torch.Tensor, lens: torch.Tensor, w: GatedHiFiWeights,
               res_scale: float = 1.0, p_drop: float = 0.0) -> torch.Tensor:
    """GatedHiFi block forward; same contract as ``gated_hifi_reference``.

    A CUDA tensor launches ``csrc/gated_hifi_fwd.cu``, and anything the
    kernel does not take raises. A CPU tensor runs the plain version.
    ``gated_hifi.launches`` counts kernel launches.
    """
    if p_drop != 0.0:
        raise NotImplementedError("dropout inside the GatedHiFi block is not ported; p_drop must be 0")
    if x.device.type == "cpu":
        return gated_hifi_reference(x, lens, w, res_scale)
    if x.device.type != "cuda":
        raise ValueError(f"gated_hifi: unsupported device {x.device}")

    B, T, W = x.shape
    H = 2 * W
    depth = len(w.ks)
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError("gated_hifi: the kernel is built for sm_90a (Hopper)")
    if W != _build.GATED_HIFI_WIDTH:
        raise ValueError(f"gated_hifi: kernel is built for W={_build.GATED_HIFI_WIDTH}, got W={W}")
    if T < 1 or B < 1:
        raise ValueError(f"gated_hifi: empty input {tuple(x.shape)}")
    if any(k % 2 == 0 for k in w.kernels) or not 1 <= depth <= _build.GATED_HIFI_MAX_DEPTH:
        raise ValueError(f"gated_hifi: kernels {w.kernels} must be odd, 1..8 branches")
    ks_flat = torch.cat([k.reshape(-1) for k in w.ks])
    tensors = {"x": x, "wall": w.wall, "ball": w.ball, "ks": ks_flat, "cb": w.cb,
               "w1": w.w1, "b1": w.b1, "wg": w.wg, "bg": w.bg}
    shapes = {"x": (B, T, W), "wall": (W, depth * H), "ball": (depth * H,),
              "ks": (sum(w.kernels) * H * H,), "cb": (depth, H), "w1": (depth, H, H),
              "b1": (depth, H), "wg": (W, W), "bg": (W,)}
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"gated_hifi: {name} must be a contiguous float32 tensor on {x.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"gated_hifi: {name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    if lens.dtype != torch.int32 or lens.shape != (B,) or lens.device != x.device:
        raise ValueError("gated_hifi: lens must be an int32 [B] tensor on the input's device")
    lens = lens.contiguous()

    lib = _build.build()
    max_halo = max((k - 1) // 2 * d for k, d in zip(w.kernels, w.dilations))
    if lib.gated_hifi_fwd_smem_bytes(max_halo) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"gated_hifi: halo {max_halo} needs more shared memory than a block has")
    out = torch.empty_like(x)
    ints = ctypes.c_int * depth
    rc = lib.gated_hifi_fwd(
        x.data_ptr(), lens.data_ptr(), w.wall.data_ptr(), w.ball.data_ptr(),
        ks_flat.data_ptr(), w.cb.data_ptr(), w.w1.data_ptr(), w.b1.data_ptr(),
        w.wg.data_ptr(), w.bg.data_ptr(), out.data_ptr(),
        B, T, W, depth, ints(*w.kernels), ints(*w.dilations), float(res_scale),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gated_hifi_fwd launch failed with cudaError {rc}")
    gated_hifi.launches += 1
    return out


gated_hifi.launches = 0
