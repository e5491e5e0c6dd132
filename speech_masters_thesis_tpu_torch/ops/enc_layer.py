"""One Glow-TTS text-encoder layer: the plain PyTorch version, its pieces, and
the kernel wrapper (counterpart of
speech_masters_thesis_tpu/ops/pallas/enc_layer.py, ``fused_enc_layer``'s
forward, and of the unfused layer in models/glow_tts/{attention,encoder}.py).

The CUDA kernel is ``csrc/enc_layer_fwd.cu``. For a CUDA tensor
``enc_layer`` launches it (one call: 7 launches) or raises; for a CPU tensor
it runs ``enc_layer_reference``, the unfused layer:

    xm = x * valid
    y  = conv_o(relative_attention(conv_q(xm), conv_k(xm), conv_v(xm)))
    x1 = LN1(xm + y)
    out = LN2(x1 + FFN(x1))

with windowed relative attention (shared-head tables, scores -1e4 where the
query or the key is padding), the k=3 conv FFN masked by the lengths, and
flax's LayerNorm (var = E[x^2] - E[x]^2, eps 1e-4). Eval only: the
recompute backward and in-kernel dropout wait for the training slice.
Weights are in PyTorch's Conv1d layout [out, in, k].
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops.basic import pointwise, sequence_mask

NEG_MASK = -1e4


@dataclass(frozen=True)
class EncLayerWeights:
    """One layer's weights: conv_q/k/v/o [C, C, 1] with biases, the relative
    tables rk/rv [2w+1, D], LayerNorms (g1, be1), (g2, be2) [C], FFN convs
    w1 [F, C, k], w2 [C, F, k] with biases."""

    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    rk: torch.Tensor
    rv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    g1: torch.Tensor
    be1: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    g2: torch.Tensor
    be2: torch.Tensor
    n_heads: int
    window: int
    eps: float = 1e-4

    def tensors(self) -> dict:
        return {name: getattr(self, name) for name in (
            "wq", "bq", "wk", "bk", "wv", "bv", "rk", "rv", "wo", "bo", "g1", "be1",
            "w1", "b1", "w2", "b2", "g2", "be2")}


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with flax's statistics."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * gamma) + beta


def conv1d_ntc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """SAME Conv1d on [B, T, C] activations (weight [out, in, k])."""
    k = w.shape[2]
    return F.conv1d(x.transpose(1, 2), w, b, padding=(k - 1) // 2 * dilation,
                    dilation=dilation).transpose(1, 2)


def relative_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, x_mask: torch.Tensor,
                       rk: torch.Tensor, rv: torch.Tensor, n_heads: int, window: int) -> torch.Tensor:
    """Bidirectional self-attention with windowed relative position tables.

    q, k, v [B, T, C]; x_mask [B, T, 1]; rk, rv [2w+1, D] shared by the
    heads. The relative terms sit on the band |j - i| <= w: the JAX
    package's pad-and-skew construction, written as a gather."""
    B, T, C = q.shape
    D = C // n_heads
    qh, kh, vh = (t.reshape(B, T, n_heads, D).transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(T, device=q.device)
    off = pos[None, :] - pos[:, None]                            # j - i
    in_band = off.abs() <= window
    rel_index = (off + window).clamp(0, 2 * window).expand(B, n_heads, T, T)
    scores = qh @ kh.transpose(-2, -1) / math.sqrt(D)
    rel_logits = qh @ rk.t()                                     # [B, H, T, 2w+1]
    scores = scores + torch.gather(rel_logits, 3, rel_index) * in_band / math.sqrt(D)
    attn_mask = x_mask[:, None, :, 0, None] * x_mask[:, None, None, :, 0]
    scores = torch.where(attn_mask == 0, NEG_MASK, scores)
    p = torch.softmax(scores.to(torch.float32), dim=-1)
    out = p @ vh
    band_cols = pos[:, None] + torch.arange(-window, window + 1, device=q.device)[None, :]
    band_ok = (band_cols >= 0) & (band_cols < T)
    band_p = torch.gather(p, 3, band_cols.clamp(0, T - 1).expand(B, n_heads, T, 2 * window + 1)) * band_ok
    out = out + band_p @ rv
    return out.transpose(1, 2).reshape(B, T, C)


def ffn(x: torch.Tensor, x_mask: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """conv2(relu(conv1(x * mask)) * mask) * mask."""
    h = torch.relu(conv1d_ntc(x * x_mask, w1, b1))
    return conv1d_ntc(h * x_mask, w2, b2) * x_mask


def enc_layer_reference(x: torch.Tensor, lens: torch.Tensor, w: EncLayerWeights) -> torch.Tensor:
    """Plain layer: x [B, T, C], lens [B] -> [B, T, C]."""
    x_mask = sequence_mask(lens, x.shape[1]).to(x.dtype)[..., None]
    xm = x * x_mask
    att = relative_attention(pointwise(xm, w.wq, w.bq), pointwise(xm, w.wk, w.bk),
                             pointwise(xm, w.wv, w.bv), x_mask, w.rk, w.rv, w.n_heads, w.window)
    x1 = layer_norm(xm + pointwise(att, w.wo, w.bo), w.g1, w.be1, w.eps)
    return layer_norm(x1 + ffn(x1, x_mask, w.w1, w.b1, w.w2, w.b2), w.g2, w.be2, w.eps)


def _check_call(x: torch.Tensor, lens: torch.Tensor, w: EncLayerWeights) -> None:
    B, T, C = x.shape
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError("enc_layer: the kernel is built for sm_90a (Hopper)")
    D = C // w.n_heads
    if C != _build.ENC_CHANNELS or D != _build.ENC_HEAD_DIM or w.n_heads * D != C:
        raise ValueError(f"enc_layer: the kernel is built for C={_build.ENC_CHANNELS} in heads of "
                         f"{_build.ENC_HEAD_DIM}; got C={C}, {w.n_heads} heads")
    if not 0 <= w.window <= _build.ENC_MAX_WINDOW or B < 1 or T < 1:
        raise ValueError(f"enc_layer: window {w.window} (at most {_build.ENC_MAX_WINDOW}), input {tuple(x.shape)}")
    Fc, k = w.w1.shape[0], w.w1.shape[2]
    R = 2 * w.window + 1
    shapes = {"wq": (C, C, 1), "bq": (C,), "wk": (C, C, 1), "bk": (C,), "wv": (C, C, 1), "bv": (C,),
              "rk": (R, D), "rv": (R, D), "wo": (C, C, 1), "bo": (C,), "g1": (C,), "be1": (C,),
              "w1": (Fc, C, k), "b1": (Fc,), "w2": (C, Fc, k), "b2": (C,), "g2": (C,), "be2": (C,)}
    if k not in (1, 3, 5):
        raise ValueError(f"enc_layer: FFN kernel {k} must be 1, 3 or 5")
    for name, t in {"x": x, **w.tensors()}.items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"enc_layer: {name} must be a contiguous, 16-byte aligned float32 tensor "
                             f"on {x.device}")
        if name != "x" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"enc_layer: {name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    if lens.dtype != torch.int32 or lens.shape != (B,) or lens.device != x.device or not lens.is_contiguous():
        raise ValueError("enc_layer: lens must be a contiguous int32 [B] tensor on the input's device")


def enc_layer(x: torch.Tensor, lens: torch.Tensor, w: EncLayerWeights) -> torch.Tensor:
    """One encoder layer; same contract as ``enc_layer_reference`` at valid
    rows (rows at or past lens[b] are finite and unspecified).

    A CUDA tensor launches ``csrc/enc_layer_fwd.cu`` (C = 192 in heads of 96,
    lens int32 [B] on the same device) and counts ``enc_layer.launches``;
    anything the kernel does not take raises. A CPU tensor runs the plain
    version.
    """
    if x.device.type == "cpu":
        return enc_layer_reference(x, lens, w)
    if x.device.type != "cuda":
        raise ValueError(f"enc_layer: unsupported device {x.device}")
    _check_call(x, lens, w)
    B, T, C = x.shape
    Fc, k = w.w1.shape[0], w.w1.shape[2]
    empty = lambda *shape: torch.empty(*shape, device=x.device, dtype=torch.float32)  # noqa: E731
    out, qkv, att, x1, hid = empty(B, T, C), empty(B, T, 3 * C), empty(B, T, C), empty(B, T, C), empty(B, T, Fc)
    rc = _build.build().enc_layer_fwd(
        x.data_ptr(), lens.data_ptr(), *[t.data_ptr() for t in w.tensors().values()],
        out.data_ptr(), qkv.data_ptr(), att.data_ptr(), x1.data_ptr(), hid.data_ptr(),
        B, T, C, w.n_heads, w.window, Fc, k, float(w.eps), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"enc_layer_fwd launch failed with cudaError {rc}")
    enc_layer.launches += 1
    return out


enc_layer.launches = 0
