"""Monotonic alignment search: the plain version, the Gaussian log-prior
table, and the kernel wrapper (counterpart of
speech_masters_thesis_tpu/ops/mas.py and ops/pallas/mas.py).

The CUDA kernel is ``csrc/mas.cu``. ``maximum_path_auto`` launches it for a
CUDA tensor and runs ``maximum_path`` for a CPU tensor; nothing falls back.

Semantics every version keeps (the JAX package's ``mas.py:29-64`` and the
Pallas kernel ``pallas/mas.py:40``):
  * value, mask: [b, t_x, t_y]; the path has the same shape;
  * forward DP over frames j: v0 is v shifted down one token (token 0 gets
    -1e9), ``stay = v >= v0`` (ties stay), and
    v_next = (max(v, v0) + value * mask) where i <= j, else -1e9; v starts
    at 0; the product value * mask is rounded before the add;
  * backtrack from token sum(mask[:, 0]) - 1 at the last frame: the path
    gets mask[i, j] at the current token, and the token moves down by one
    unless it stays (outside the mask it always stays). A token index that
    falls below 0 (more valid tokens than frames) marks nothing and moves
    no further up, as the Pallas kernel's one-hot does.
So kernel and plain version agree bit for bit on the same inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops.basic import at_least_f32

MAX_NEG = -1e9
MAX_TOKENS = 1024  # csrc/mas.cu holds a sequence's tokens in the registers of one warp


def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain MAS: value, mask [b, t_x, t_y] -> 0/1 path [b, t_x, t_y]."""
    value = (value * mask).to(torch.float32)
    b, t_x, t_y = value.shape
    device = value.device
    tokens = torch.arange(t_x, device=device)
    v = torch.zeros(b, t_x, device=device)
    neg = torch.full((b, 1), MAX_NEG, device=device)
    stays = []
    for j in range(t_y):
        v0 = torch.cat([neg, v[:, :-1]], dim=1)
        stay = v >= v0
        stays.append(stay)
        v = torch.where(tokens[None, :] <= j, torch.where(stay, v, v0) + value[:, :, j], MAX_NEG)
    direction = torch.where(mask > 0, torch.stack(stays, dim=2), True)
    index = mask[:, :, 0].sum(dim=1).to(torch.int64) - 1
    rows = torch.arange(b, device=device)
    path = torch.zeros_like(value)
    for j in reversed(range(t_y)):
        inside = index >= 0
        at = index.clamp(min=0)
        path[rows, at, j] = torch.where(inside, mask[rows, at, j].to(torch.float32), 0.0)
        step = torch.where(inside, direction[rows, at, j].to(torch.int64), 0)
        index = index + step - 1
    return path


def mas_log_prior(x_m: torch.Tensor, x_logs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gaussian log-likelihood table [b, t_x, t_y] of frames z [b, t_y, d]
    under the token priors (x_m, x_logs) [b, t_x, d]: two products and two
    rank-1 terms (the JAX package's ``mas.py:79-91``)."""
    x_s_sq_r = torch.exp(-2.0 * x_logs)
    # the constant is a numpy float there, which promotes bf16 statistics to fp32 (and with them the table)
    logp1 = torch.sum(-0.5 * np.log(2.0 * np.pi) - at_least_f32(x_logs), dim=-1, keepdim=True)
    logp2 = torch.matmul(x_s_sq_r, (-0.5 * (z * z)).transpose(1, 2))
    logp3 = torch.matmul(x_m * x_s_sq_r, z.transpose(1, 2))
    logp4 = torch.sum(-0.5 * (x_m * x_m) * x_s_sq_r, dim=-1, keepdim=True)
    return logp1 + logp2 + logp3 + logp4


def _check_call(value: torch.Tensor, mask: torch.Tensor) -> None:
    if torch.cuda.get_device_capability(value.device) != (9, 0):
        raise RuntimeError("maximum_path_auto: the kernel is built for sm_90a (Hopper)")
    if value.ndim != 3 or mask.shape != value.shape or min(value.shape) < 1:
        raise ValueError(f"maximum_path_auto: value {tuple(value.shape)} and mask {tuple(mask.shape)} "
                         "must be the same non-empty [b, t_x, t_y]")
    for name, t in (("value", value), ("mask", mask)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != value.device:
            raise ValueError(f"maximum_path_auto: {name} must be a contiguous float32 tensor on {value.device}")
    _, t_x, t_y = value.shape
    if t_x > MAX_TOKENS:
        raise ValueError(f"maximum_path_auto: the kernel holds at most {MAX_TOKENS} tokens (32 a lane of one "
                         f"warp), got t_x={t_x}")
    smem = _smem_bytes(t_x, t_y)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"maximum_path_auto: t_x={t_x}, t_y={t_y} needs {smem} bytes of shared memory, "
                         f"more than a block has ({_build.MAX_SMEM_BYTES})")


@functools.lru_cache(maxsize=None)
def _smem_bytes(t_x: int, t_y: int) -> int:
    """The kernel's shared memory at (t_x, t_y), asked of the library once a shape."""
    return _build.build().mas_smem_bytes(t_x, t_y)


def maximum_path_auto(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MAS on the inputs' device: a CUDA tensor launches ``csrc/mas.cu`` (one
    block per sequence, t_x <= 1024) and counts ``maximum_path_auto.launches``;
    a CPU tensor runs ``maximum_path``."""
    if value.device.type == "cpu":
        return maximum_path(value, mask)
    if value.device.type != "cuda":
        raise ValueError(f"maximum_path_auto: unsupported device {value.device}")
    value = value.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    _check_call(value, mask)
    b, t_x, t_y = value.shape
    path = torch.empty_like(value)
    rc = _build.build().mas_forward(value.data_ptr(), mask.data_ptr(), path.data_ptr(), b, t_x, t_y,
                                    torch.cuda.current_stream(value.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mas launch failed with cudaError {rc}")
    maximum_path_auto.launches += 1
    return path


maximum_path_auto.launches = 0
