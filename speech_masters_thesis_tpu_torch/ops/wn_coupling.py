"""The Glow-TTS coupling conditioner: plain PyTorch version and the kernel
wrapper (counterpart of speech_masters_thesis_tpu/ops/pallas/wn_coupling.py,
``fused_wn_coupling``'s forward).

The CUDA kernel is ``csrc/wn_coupling_fwd.cu``. For a CUDA tensor
``wn_coupling`` launches it (one call: 2 + 2 * n_layers launches of the
row-tiled convolution) or raises; for a CPU tensor it runs
``wn_coupling_reference``, the unfused conditioner: start 1x1, n_layers x
(dilated conv -> tanh * sigmoid gate -> res/skip 1x1), end 1x1, with the
start output, each residual and the skip sum masked by the lengths. Eval
only: the recompute backward and dropout wait for the training slice.

Weights are post-weight-norm, in PyTorch's Conv1d layout [out, in, k].
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops.basic import pointwise, sequence_mask


@dataclass(frozen=True)
class WNWeights:
    """A conditioner's weights: start [H, half, 1], per layer in [2H, H, k]
    and res/skip [2H or H, H, 1] (the last layer's is H), end [C, H, 1],
    each with its bias; ``dilations`` per layer."""

    ws: torch.Tensor
    bs: torch.Tensor
    win: Tuple[torch.Tensor, ...]
    bin: Tuple[torch.Tensor, ...]
    wrs: Tuple[torch.Tensor, ...]
    brs: Tuple[torch.Tensor, ...]
    wend: torch.Tensor
    bend: torch.Tensor
    dilations: Tuple[int, ...]

    @property
    def hidden(self) -> int:
        return self.ws.shape[0]

    @property
    def kernel_size(self) -> int:
        return self.win[0].shape[2]


def wn_coupling_reference(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights) -> torch.Tensor:
    """Plain conditioner: x0 [B, T, half], lens [B] -> [B, T, C]."""
    H = w.hidden
    valid = sequence_mask(lens, x0.shape[1])[..., None]
    h = pointwise(x0, w.ws, w.bs) * valid
    skip = torch.zeros_like(h)
    n_layers = len(w.win)
    for i in range(n_layers):
        k, dil = w.win[i].shape[2], w.dilations[i]
        z = F.conv1d(h.transpose(1, 2), w.win[i], w.bin[i], padding=(k - 1) // 2 * dil,
                     dilation=dil).transpose(1, 2)
        acts = torch.tanh(z[..., :H]) * torch.sigmoid(z[..., H:])
        rs = pointwise(acts, w.wrs[i], w.brs[i])
        if i < n_layers - 1:
            h = (h + rs[..., :H]) * valid
            skip = skip + rs[..., H:]
        else:
            skip = skip + rs
    return pointwise(skip * valid, w.wend, w.bend)


def _check_call(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights) -> None:
    B, T, half = x0.shape
    H, L, k = w.hidden, len(w.win), w.kernel_size
    if torch.cuda.get_device_capability(x0.device) != (9, 0):
        raise RuntimeError("wn_coupling: the kernel is built for sm_90a (Hopper)")
    if B < 1 or T < 1 or k not in (1, 3, 5) or L < 1:
        raise ValueError(f"wn_coupling: input {tuple(x0.shape)}, kernel {k} (1, 3 or 5), {L} layers")
    if x0.dtype != torch.float32 or x0.stride(2) != 1 or x0.stride(0) != T * x0.stride(1):
        raise ValueError("wn_coupling: x0 must be float32 [B, T, half] with unit channel stride and "
                         f"rows of one stride; got strides {x0.stride()}")
    C = w.wend.shape[0]
    shapes = {"ws": (H, half, 1), "bs": (H,), "wend": (C, H, 1), "bend": (C,)}
    for i in range(L):
        rs = 2 * H if i < L - 1 else H
        shapes.update({f"win{i}": (2 * H, H, k), f"bin{i}": (2 * H,), f"wrs{i}": (rs, H, 1), f"brs{i}": (rs,)})
    tensors = {"ws": w.ws, "bs": w.bs, "wend": w.wend, "bend": w.bend,
               **{f"win{i}": t for i, t in enumerate(w.win)}, **{f"bin{i}": t for i, t in enumerate(w.bin)},
               **{f"wrs{i}": t for i, t in enumerate(w.wrs)}, **{f"brs{i}": t for i, t in enumerate(w.brs)}}
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x0.device:
            raise ValueError(f"wn_coupling: {name} must be a contiguous float32 tensor on {x0.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"wn_coupling: {name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    if lens.dtype != torch.int32 or lens.shape != (B,) or lens.device != x0.device or not lens.is_contiguous():
        raise ValueError("wn_coupling: lens must be a contiguous int32 [B] tensor on the input's device")
    if tuple(w.dilations) != tuple(_rate(w) ** i for i in range(L)):
        raise ValueError(f"wn_coupling: dilations {w.dilations} must be rate ** layer")


def _rate(w: WNWeights) -> int:
    return w.dilations[1] if len(w.dilations) > 1 else 1


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def wn_coupling(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights) -> torch.Tensor:
    """The conditioner; same contract as ``wn_coupling_reference``.

    A CUDA tensor launches ``csrc/wn_coupling_fwd.cu`` (x0 may be the
    first-half view of the coupling input; lens int32 [B] on the same
    device) and counts ``wn_coupling.launches``; anything the kernel does not
    take raises. A CPU tensor runs the plain version.
    """
    if x0.device.type == "cpu":
        return wn_coupling_reference(x0, lens, w)
    if x0.device.type != "cuda":
        raise ValueError(f"wn_coupling: unsupported device {x0.device}")
    _check_call(x0, lens, w)
    B, T, half = x0.shape
    H, L, C = w.hidden, len(w.win), w.wend.shape[0]
    out = torch.empty(B, T, C, device=x0.device, dtype=torch.float32)
    h, acts, skip = (torch.empty(B, T, H, device=x0.device, dtype=torch.float32) for _ in range(3))
    rc = _build.build().wn_coupling_fwd(
        x0.data_ptr(), x0.stride(1), lens.data_ptr(), w.ws.data_ptr(), w.bs.data_ptr(),
        _pointers(w.win), _pointers(w.bin), _pointers(w.wrs), _pointers(w.brs),
        w.wend.data_ptr(), w.bend.data_ptr(), out.data_ptr(), h.data_ptr(), acts.data_ptr(), skip.data_ptr(),
        B, T, half, H, C, L, w.kernel_size, _rate(w), torch.cuda.current_stream(x0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wn_coupling_fwd launch failed with cudaError {rc}")
    wn_coupling.launches += 1
    return out


wn_coupling.launches = 0
