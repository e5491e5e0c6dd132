"""One Glow-TTS text-encoder layer: plain PyTorch versions of its forward and
recompute backward, its pieces, and the kernel wrappers (counterpart of
speech_masters_thesis_tpu/ops/pallas/enc_layer.py, ``fused_enc_layer`` and
its custom VJP, and of the unfused layer in models/glow_tts/{attention,
encoder}.py).

The fp32 kernels are ``csrc/enc_layer_fwd.cu`` and ``csrc/enc_layer_bwd.cu``:
the products in 3xTF32 on the tensor cores (``csrc/conv_mma.cuh``, the
weight gradients on ``csrc/wgrad_mma.cuh``), attention fp32 on the CUDA
cores. The bf16 forward and backward are ``csrc/enc_layer_bf16.cu`` (every
dense product on wgmma, its operands staged by TMA, on the engine it shares
with B3's and B6's bf16 kernels, ``csrc/bf16_engine.cuh``; attention on bf16
tensor-core MMA): the forward is the backward's recompute, launch for
launch. ``enc_layer`` runs ``EncLayerFunction``: for a CUDA tensor its
forward launches the forward kernels (one call: 6 launches, the first packs
the weights the products read; bf16 8) and its backward the backward
kernels (17 launches; bf16 17, or 18 where the weight sums split the
frames), or raises; for a CPU tensor the same Function runs
``enc_layer_reference`` and ``enc_layer_backward_reference``. The forward
saves the input, the lengths, the weights and the seed, no activations. The
layer:

    xm = x * valid
    y  = conv_o(attention(conv_q(xm), conv_k(xm), conv_v(xm))) -> dropout
    x1 = LN1(xm + y)
    out = LN2(x1 + FFN(x1) -> dropout)

with windowed relative attention (shared-head tables, scores -1e4 where the
query or the key is padding, dropout on the probabilities, which the
relative-value term uses too), the k=3 conv FFN masked by the lengths with
dropout after its relu, and flax's LayerNorm (var = E[x^2] - E[x]^2, eps
1e-4). Dropout keeps an element when its 32-bit draw (``ops/hash.py``) is >=
int(p * 2^32) and scales it by 1/(1-p); the draws of the attention
probabilities are keyed by (sequence, head, query, key), those of the three
row sites by (sequence, site, row, channel), so kernels and plain version
agree bit for bit and the backward regenerates them from the seed (an int64
[1] tensor on the input's device). Weights are in PyTorch's Conv1d layout
[out, in, k]. Rows at or past the length are unspecified in the output;
their cotangent is taken as zero and their input gradient is zero, as in the
TPU kernel.

Two modes, as the TPU kernel's ``dot_dtype`` (x's dtype) has them. fp32: x,
the weights and g float32. bf16 (the JAX package's mixed-precision
training): x, every weight and g bfloat16, and the operands of every
product (q/k/v, the scores and relative-key logits, P V after dropout, the
relative-value band, the out-projection, the FFN convs, and each of their
transposes and weight gradients in the backward) rounded to bf16 and summed
in fp32; LayerNorm, the softmax, the masks and dropout fp32; out and dx in
bf16, the weight gradients summed in fp32 and cast to bf16 once. Mixed
dtypes raise. ``.launches`` counts fp32 kernel launches, ``.bf16_launches``
bf16 ones. A bf16 CPU tensor runs ``EncLayerFunction`` over the plain
versions (the TPU kernel's backward rounding).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops.basic import at_least_f32, pointwise, round_bf16, same, sequence_mask
from speech_masters_thesis_tpu_torch.ops.hash import keep_factor, keep_scale, keep_threshold
from speech_masters_thesis_tpu_torch.ops.wn_coupling import dilated_transpose, dilated_weight_grad

NEG_MASK = -1e4
ENC_STREAMS = 64  # hash streams per sequence: 16 per dropout site (csrc/enc_layer_common.cuh)
# the dropout sites of one layer (the JAX kernel's seed-mixing ids)
SITE_ATTN_P, SITE_ATTN_Y, SITE_FFN_MID, SITE_FFN_Y = 0, 1, 2, 3
PARAM_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "rk", "rv", "wo", "bo", "g1", "be1",
               "w1", "b1", "w2", "b2", "g2", "be2")


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

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def with_tensors(self, tensors) -> "EncLayerWeights":
        """The same layer with other tensors, in ``PARAM_NAMES`` order."""
        return EncLayerWeights(*tensors, n_heads=self.n_heads, window=self.window, eps=self.eps)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with flax's statistics; for a bf16 x in
    fp32 inside with one rounding at the output, as flax's LayerNorm
    computes under the JAX package's mixed precision."""
    xf = at_least_f32(x)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return ((xf - mean) * (torch.rsqrt(var + eps) * gamma) + beta).to(x.dtype)


def conv1d_ntc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """SAME Conv1d on [B, T, C] activations (weight [out, in, k])."""
    k = w.shape[2]
    return F.conv1d(x.transpose(1, 2), w, b, padding=(k - 1) // 2 * dilation,
                    dilation=dilation).transpose(1, 2)


def band_scatter(vals: torch.Tensor, window: int) -> torch.Tensor:
    """[..., T, 2w+1] -> [..., T, T]: out[i, j] = vals[i, j - i + w] on the
    band |j - i| <= w, else 0."""
    T = vals.shape[-2]
    pos = torch.arange(T, device=vals.device)
    off = pos[None, :] - pos[:, None]
    index = (off + window).clamp(0, 2 * window).expand(*vals.shape[:-2], T, T)
    return torch.gather(vals, -1, index) * (off.abs() <= window)


def band_extract(mat: torch.Tensor, window: int) -> torch.Tensor:
    """[..., T, T] -> [..., T, 2w+1]: out[i, o] = mat[i, i + o - w], 0 where
    that column leaves [0, T)."""
    T = mat.shape[-1]
    cols = torch.arange(T, device=mat.device)[:, None] + torch.arange(-window, window + 1, device=mat.device)[None]
    ok = (cols >= 0) & (cols < T)
    return torch.gather(mat, -1, cols.clamp(0, T - 1).expand(*mat.shape[:-2], T, 2 * window + 1)) * ok


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, C = t.shape
    return t.reshape(B, T, n_heads, C // n_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    B, H, T, D = t.shape
    return t.transpose(1, 2).reshape(B, T, H * D)


def attention_probs(q: torch.Tensor, k: torch.Tensor, x_mask: torch.Tensor, rk: torch.Tensor,
                    n_heads: int, window: int) -> torch.Tensor:
    """Softmax probabilities [B, heads, T, T] of windowed relative
    self-attention: scores (q.k + [|j - i| <= w] q.R_k[j - i + w]) / sqrt(D),
    -1e4 where the query or the key is padding; rk [2w+1, D] is shared by the
    heads. The relative terms sit on the band |j - i| <= w: the JAX package's
    pad-and-skew construction, written as a gather."""
    D = q.shape[2] // n_heads
    qh, kh = _heads(q, n_heads), _heads(k, n_heads)
    scores = (qh @ kh.transpose(-2, -1) + band_scatter(qh @ rk.t(), window)) * (1.0 / math.sqrt(D))
    attn_mask = x_mask[:, None, :, 0, None] * x_mask[:, None, None, :, 0]
    scores = torch.where(attn_mask == 0, NEG_MASK, scores)
    return torch.softmax(scores, dim=-1)


def dropout_keep(seed, lens: torch.Tensor, T: int, width: int, site: int, p_drop: float,
                 dtype=torch.float32) -> torch.Tensor:
    """A row site's dropout factors [B, T, width] (0 or 1/(1-p)): stream
    b * ENC_STREAMS + site * 16, counter t * width + c."""
    device = lens.device
    streams = torch.arange(lens.shape[0], dtype=torch.int64, device=device) * ENC_STREAMS + site * 16
    counter = (torch.arange(T, dtype=torch.int64, device=device)[:, None] * width
               + torch.arange(width, dtype=torch.int64, device=device)[None, :])
    return keep_factor(seed, streams[:, None, None], counter[None], p_drop, dtype)


def attention_keep(seed, lens: torch.Tensor, n_heads: int, T: int, p_drop: float,
                   dtype=torch.float32) -> torch.Tensor:
    """The attention probabilities' dropout factors [B, heads, T, T]: stream
    b * ENC_STREAMS + head, counter query * T + key."""
    device = lens.device
    streams = (torch.arange(lens.shape[0], dtype=torch.int64, device=device)[:, None] * ENC_STREAMS
               + SITE_ATTN_P * 16 + torch.arange(n_heads, dtype=torch.int64, device=device)[None, :])
    pos = torch.arange(T, dtype=torch.int64, device=device)
    return keep_factor(seed, streams[:, :, None, None], (pos[:, None] * T + pos[None, :])[None, None],
                       p_drop, dtype)


def _ln_stats(z: torch.Tensor, eps: float):
    """(zhat, 1/std) of flax's LayerNorm over the last axis."""
    mean = z.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp((z * z).mean(dim=-1, keepdim=True) - mean * mean, min=0.0) + eps)
    return (z - mean) * inv, inv


def _ln_backward(dout: torch.Tensor, zhat: torch.Tensor, inv: torch.Tensor, gamma: torch.Tensor):
    """(dz, dgamma, dbeta) of a LayerNorm whose output has cotangent dout."""
    dy = dout * gamma
    dz = inv * (dy - dy.mean(dim=-1, keepdim=True) - zhat * (dy * zhat).mean(dim=-1, keepdim=True))
    return dz, (dout * zhat).sum(dim=(0, 1)), dout.sum(dim=(0, 1))


def check_dtypes(x: torch.Tensor, w: EncLayerWeights, g: Optional[torch.Tensor] = None) -> None:
    """x, every weight (and g) share one dtype: one mode per call."""
    for name, t in {**w.tensors(), **({} if g is None else {"g": g})}.items():
        if t.dtype != x.dtype:
            raise ValueError(f"enc_layer: {name} is {t.dtype} but x is {x.dtype}: x, every weight and g share "
                             "one dtype (float32 or bfloat16)")


def _operands(x: torch.Tensor, w: EncLayerWeights):
    """(round, x, w) for the plain versions: in bf16 mode x and w in fp32 and
    ``round`` rounding a product operand to bf16; otherwise as they are and
    no rounding."""
    check_dtypes(x, w)
    if x.dtype != torch.bfloat16:
        return same, x, w
    return round_bf16, x.float(), w.with_tensors([t.float() for t in w.tensors().values()])


def _forward(x: torch.Tensor, lens: torch.Tensor, w: EncLayerWeights, seed, p_drop: float, rnd=same) -> dict:
    """The layer, keeping what the backward needs; ``rnd`` rounds each
    product's operands (``_operands``)."""
    T, C = x.shape[1], x.shape[2]
    drop = p_drop > 0.0
    valid = sequence_mask(lens, T).to(x.dtype)[..., None]
    s = {"valid": valid, "xm": x * valid}
    s["q"], s["k"], s["v"] = (pointwise(rnd(s["xm"]), rnd(wt), b)
                              for wt, b in ((w.wq, w.bq), (w.wk, w.bk), (w.wv, w.bv)))
    s["p"] = attention_probs(rnd(s["q"]), rnd(s["k"]), valid, rnd(w.rk), w.n_heads, w.window)
    s["keep_p"] = attention_keep(seed, lens, w.n_heads, T, p_drop, x.dtype) if drop else None
    s["pd"] = s["p"] * s["keep_p"] if drop else s["p"]
    pd = rnd(s["pd"])
    s["att"] = _merge(pd @ _heads(rnd(s["v"]), w.n_heads) + band_extract(pd, w.window) @ rnd(w.rv))
    y = pointwise(rnd(s["att"]), rnd(w.wo), w.bo)
    if drop:
        y = y * dropout_keep(seed, lens, T, C, SITE_ATTN_Y, p_drop, x.dtype)
    s["z1"] = s["xm"] + y
    s["x1"] = layer_norm(s["z1"], w.g1, w.be1, w.eps)
    s["c1"] = conv1d_ntc(rnd(s["x1"] * valid), rnd(w.w1), w.b1)
    a1 = torch.relu(s["c1"])
    if drop:
        a1 = a1 * dropout_keep(seed, lens, T, w.w1.shape[0], SITE_FFN_MID, p_drop, x.dtype)
    s["d1m"] = a1 * valid
    y2 = conv1d_ntc(rnd(s["d1m"]), rnd(w.w2), w.b2) * valid
    if drop:
        y2 = y2 * dropout_keep(seed, lens, T, C, SITE_FFN_Y, p_drop, x.dtype)
    s["z2"] = s["x1"] + y2
    s["out"] = layer_norm(s["z2"], w.g2, w.be2, w.eps)
    return s


def enc_layer_reference(x: torch.Tensor, lens: torch.Tensor, w: EncLayerWeights, seed=0,
                        p_drop: float = 0.0) -> torch.Tensor:
    """Plain layer: x [B, T, C], lens [B] -> [B, T, C] in x's dtype, with
    dropout (``p_drop > 0``) at the JAX kernel's four sites and masks from
    ``seed`` (an int or an int64 tensor of one element); bf16: the products'
    operands rounded as the TPU kernel rounds them, the rest fp32, the
    output rounded."""
    rnd, xf, wf = _operands(x, w)
    return _forward(xf, lens, wf, seed, p_drop, rnd)["out"].to(x.dtype)


def recomputed_buffers(x: torch.Tensor, lens: torch.Tensor, w: EncLayerWeights, seed=0,
                       p_drop: float = 0.0) -> Dict[str, torch.Tensor]:
    """The plain recompute's buffers as ``enc_layer(..., return_buffers=True)``
    and ``enc_layer_backward(..., return_buffers=True)`` hand them back on the
    CPU: {"qkv": q|k|v [B, T, 3C], "att": the heads' output [B, T, C] (zero at
    rows at or past the length, as the kernels store it), "x1m": LN1's output
    masked [B, T, C], all three in x's dtype; "hid": the FFN's hidden rows
    after relu, dropout and the mask [B, T, F], fp32}."""
    rnd, xf, wf = _operands(x, w)
    with torch.no_grad():
        s = _forward(xf, lens, wf, seed, p_drop, rnd)
        return {"qkv": torch.cat([s["q"], s["k"], s["v"]], dim=-1).to(x.dtype),
                "att": (s["att"] * s["valid"]).to(x.dtype), "x1m": (s["x1"] * s["valid"]).to(x.dtype),
                "hid": s["d1m"].float()}


def enc_layer_backward_reference(x: torch.Tensor, lens: torch.Tensor, w: EncLayerWeights, g: torch.Tensor,
                                 seed=0, p_drop: float = 0.0, relu_gate: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain recompute backward, by the TPU kernel's formulas
    (``_bwd_kernel``): (dx, {name: gradient} in ``PARAM_NAMES`` order), with
    g taken as zero at rows at or past the length, in x's and the weights'
    dtype (bf16: each product's operands rounded, the rest fp32, the
    gradients summed in fp32 and rounded once). ``relu_gate`` [B, T, F]
    replaces the FFN relu's decisions (c1 > 0), e.g. by a kernel's own."""
    T, C = x.shape[1], x.shape[2]
    H, k = w.n_heads, w.w1.shape[2]
    drop = p_drop > 0.0
    check_dtypes(x, w, g)
    dtype = x.dtype
    rnd, x, w = _operands(x, w)
    g = g.to(x.dtype)
    with torch.no_grad():
        s = _forward(x, lens, w, seed, p_drop, rnd)
        valid = s["valid"]
        grads = {}
        zhat2, inv2 = _ln_stats(s["z2"], w.eps)
        dz2, grads["g2"], grads["be2"] = _ln_backward(g * valid, zhat2, inv2, w.g2)
        dc2 = dz2 * valid
        if drop:
            dc2 = dc2 * dropout_keep(seed, lens, T, C, SITE_FFN_Y, p_drop, x.dtype)
        grads["w2"], grads["b2"] = dilated_weight_grad(rnd(s["d1m"]), rnd(dc2), k, 1), dc2.sum(dim=(0, 1))
        dc1 = dilated_transpose(rnd(dc2), rnd(w.w2), 1) * valid
        if drop:
            dc1 = dc1 * dropout_keep(seed, lens, T, w.w1.shape[0], SITE_FFN_MID, p_drop, x.dtype)
        dc1 = dc1 * (s["c1"] > 0 if relu_gate is None else relu_gate)
        grads["w1"], grads["b1"] = dilated_weight_grad(rnd(s["x1"] * valid), rnd(dc1), k, 1), dc1.sum(dim=(0, 1))
        zhat1, inv1 = _ln_stats(s["z1"], w.eps)
        dz1, grads["g1"], grads["be1"] = _ln_backward(dz2 + dilated_transpose(rnd(dc1), rnd(w.w1), 1) * valid,
                                                      zhat1, inv1, w.g1)
        dy = dz1 * dropout_keep(seed, lens, T, C, SITE_ATTN_Y, p_drop, x.dtype) if drop else dz1
        grads["wo"] = torch.einsum("btn,btc->nc", rnd(dy), rnd(s["att"]))[..., None]
        grads["bo"] = dy.sum(dim=(0, 1))
        doh = rnd(_heads(rnd(dy) @ rnd(w.wo[:, :, 0]), H))  # only ever a product operand
        p, pd = s["p"], s["pd"]
        qh, kh, vh = (rnd(_heads(s[n], H)) for n in ("q", "k", "v"))
        grads["rv"] = torch.einsum("bhto,bhtd->od", rnd(band_extract(pd, w.window)), doh)
        dp = doh @ vh.transpose(-2, -1) + band_scatter(doh @ rnd(w.rv).t(), w.window)
        if drop:
            dp = dp * s["keep_p"]
        smask = valid[:, None, :, 0, None] * valid[:, None, None, :, 0]
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * smask / math.sqrt(C // H)
        dclog = rnd(band_extract(ds, w.window))
        grads["rk"] = torch.einsum("bhto,bhtd->od", dclog, qh)
        dxm = dz1
        ds = rnd(ds)
        for name, d in (("q", _merge(ds @ kh + dclog @ rnd(w.rk))), ("k", _merge(ds.transpose(-2, -1) @ qh)),
                        ("v", _merge(rnd(pd).transpose(-2, -1) @ doh))):
            grads[f"w{name}"] = torch.einsum("btn,btc->nc", rnd(d), rnd(s["xm"]))[..., None]
            grads[f"b{name}"] = d.sum(dim=(0, 1))
            dxm = dxm + rnd(d) @ rnd(getattr(w, f"w{name}")[:, :, 0])
    return (dxm * valid).to(dtype), {name: grads[name].to(dtype) for name in PARAM_NAMES}


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_call(x: torch.Tensor, lens: torch.Tensor, w: EncLayerWeights, seed: torch.Tensor) -> None:
    B, T, C = x.shape
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError("enc_layer: the kernels are built for sm_90a (Hopper)")
    D = C // w.n_heads
    if C != _build.ENC_CHANNELS or D != _build.ENC_HEAD_DIM or w.n_heads * D != C:
        raise ValueError(f"enc_layer: the kernels are built for C={_build.ENC_CHANNELS} in heads of "
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
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"enc_layer: x is {x.dtype}; the kernels take float32 or bfloat16")
    check_dtypes(x, w)
    for name, t in {"x": x, **w.tensors()}.items():
        if not t.is_contiguous() or t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"enc_layer: {name} must be a contiguous, 16-byte aligned {x.dtype} tensor "
                             f"on {x.device}")
        if name != "x" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"enc_layer: {name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    if lens.dtype != torch.int32 or lens.shape != (B,) or lens.device != x.device or not lens.is_contiguous():
        raise ValueError("enc_layer: lens must be a contiguous int32 [B] tensor on the input's device")
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != x.device:
        raise ValueError("enc_layer: seed must be an int64 tensor of one element on the input's device")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _shape_args(x: torch.Tensor, w: EncLayerWeights) -> tuple:
    B, T, C = x.shape
    return B, T, C, w.n_heads, w.window, w.w1.shape[0], w.w1.shape[2], float(w.eps)


def _workspace_floats(n: int) -> int:
    if n < 0:
        raise ValueError("enc_layer: the kernels do not take this shape")
    return n


def _pointers(ptrs) -> ctypes.Array:
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch_fwd(x, lens, w: EncLayerWeights, seed, p_drop: float) -> torch.Tensor:
    _check_call(x, lens, w, seed)
    if x.dtype == torch.bfloat16:
        return _launch_fwd16(x, lens, w, seed, p_drop, return_buffers=False)
    B, T, C = x.shape
    Fc = w.w1.shape[0]
    empty = lambda *shape: torch.empty(*shape, device=x.device, dtype=torch.float32)  # noqa: E731
    out = torch.empty_like(x)
    qkv, att, x1, hid = empty(B, T, 3 * C), empty(B, T, C), empty(B, T, C), empty(B, T, Fc)
    lib = _build.build()
    shape = _shape_args(x, w)
    workspace = empty(_workspace_floats(lib.enc_layer_fwd_workspace_floats(*shape[:-1])))
    rc = lib.enc_layer_fwd(
        x.data_ptr(), lens.data_ptr(), seed.data_ptr(), *[t.data_ptr() for t in w.tensors().values()],
        out.data_ptr(), qkv.data_ptr(), att.data_ptr(), x1.data_ptr(), hid.data_ptr(), workspace.data_ptr(),
        *shape, keep_threshold(p_drop), keep_scale(p_drop), _stream(x))
    if rc != 0:
        raise RuntimeError(f"enc_layer_fwd launch failed with cudaError {rc}")
    enc_layer.launches += 1
    return out


def _launch_fwd16(x, lens, w: EncLayerWeights, seed, p_drop: float, return_buffers: bool):
    """out, or with ``return_buffers`` (out, {"qkv", "att", "x1m", "hid"}:
    views of the forward's scratch as ``backward_buffer_shapes`` has them);
    x checked by the caller (``_check_call``)."""
    B, T, C = x.shape
    Fc, k = w.w1.shape[0], w.w1.shape[2]
    splits = bwd16_splits(B, T, Fc, k, _sm_count(x.device.index))
    parts, total = fwd16_layout(B, T, C, Fc, w.n_heads, w.window, k, splits, return_buffers)
    scratch = torch.empty(total, dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    base = scratch.data_ptr()
    rc = _build.build().enc_layer_fwd_bf16(
        x.data_ptr(), lens.data_ptr(), seed.data_ptr(), _pointers([t.data_ptr() for t in w.tensors().values()]),
        out.data_ptr(), _pointers([base + part.offset if part.nbytes else None for part in parts.values()]),
        *_shape_args(x, w), keep_threshold(p_drop), keep_scale(p_drop), splits, _stream(x))
    if rc != 0:
        raise RuntimeError(f"enc_layer_fwd_bf16 launch failed with cudaError {rc}")
    enc_layer.bf16_launches += 1
    if not return_buffers:
        return out
    shapes = backward_buffer_shapes(x, w)
    return out, {name: _part_view(scratch, parts[name], shapes[name]) for name in FWD16_BUFFERS}


def backward_buffer_shapes(x: torch.Tensor, w: EncLayerWeights) -> Dict[str, tuple]:
    """The buffers ``enc_layer_backward(..., return_buffers=True)`` hands
    back, name -> shape, in x's mode.

    fp32 (all fp32): the backward kernels' device buffers, in the order
    ``csrc/enc_layer_bwd.cu`` takes them: the recomputed forward's (q|k|v,
    the heads' output, each row's softmax (max, sum), LN1's output, both
    LayerNorms' normalised input and 1/std, the FFN's hidden rows after
    relu and dropout, the output), then the backward's (LN2's input
    cotangent, g masked, the FFN's output and hidden cotangents, LN1's input
    and output cotangents, conv_o's output cotangent after dropout, the heads'
    output cotangent, each row's rowsum(doh * oh), the band's ds and dropped
    probabilities, dq|dk|dv).

    bf16: views of parts of ``bwd16_layout``'s scratch: the recomputed
    q|k|v, the heads' output (att) and LN1's output masked (x1m), bf16; the
    FFN's hidden rows after relu, dropout and the mask (hid), fp32; the
    cotangents that carry the dropout masks, conv_o's output after dropout
    (dy) and the FFN's output (dc2), bf16; the band's ds (dclog) and dropped
    probabilities (bandp), bf16, head h at columns h (2w + 1); each row's
    softmax max, sum and delta (stats, fp32, a fourth column unused)."""
    B, T, C = x.shape
    H, R, Fc = w.n_heads, 2 * w.window + 1, w.w1.shape[0]
    row = lambda n: (B, T, n)  # noqa: E731
    if x.dtype == torch.bfloat16:
        return {"qkv": row(3 * C), "att": row(C), "x1m": row(C), "hid": row(Fc), "dy": row(C), "dc2": row(C),
                "dclog": row(H * R), "bandp": row(H * R), "stats": (B, H, T, 4)}
    return {"qkv": row(3 * C), "att": row(C), "stats": (B, H, T, 2), "x1": row(C), "zhat1": row(C),
            "rinv1": (B, T), "hid": row(Fc), "out": row(C), "zhat2": row(C), "rinv2": (B, T),
            "dz2": row(C), "gm": row(C), "dc2": row(C), "dc1": row(Fc), "dz1": row(C), "dx1": row(C),
            "dy": row(C), "datt": row(C), "delta": (B, H, T), "dclog": row(H * R), "bandp": row(H * R),
            "dqkv": row(3 * C)}


BWD16_BAND = 24        # band dots a row (2w + 1 <= 17): csrc/enc_layer_bf16.cu RB
BWD16_TILE = 64        # frames a product tile (csrc/bf16_engine.cuh TM)
BWD16_ATT_ROWS = 32    # rows an attention block (AR)
BWD16_ROW_BLOCK = 8    # rows a LayerNorm row block (ROW_BLOCK)
BWD16_ALIGN = 1024     # bytes: every part's base

# The bf16 backward's scratch (csrc/enc_layer_bf16.cu's Part order):
# name, dtype, rows and width as functions of the shape ``s``
# (_Bwd16Shape). Every bf16 part's rows are pitch8 of its width elements
# apart, every fp32 part's pitch4: 16-byte multiples, as TMA reads them.
_BF, _F32 = torch.bfloat16, torch.float32
BWD16_PARTS = (
    ("w_qkv", _BF, lambda s: (3 * s.C, s.C)), ("b_qkv", _BF, lambda s: (1, 3 * s.C)),
    ("w_qkv_t", _BF, lambda s: (s.C, 3 * s.C)), ("w_o", _BF, lambda s: (s.C, s.C)),
    ("w_o_t", _BF, lambda s: (s.C, s.C)), ("w_1", _BF, lambda s: (s.k * s.F, s.C)),
    ("w_1_t", _BF, lambda s: (s.k * s.C, s.F)), ("w_2", _BF, lambda s: (s.k * s.C, s.F)),
    ("w_2_t", _BF, lambda s: (s.k * s.F, s.C)), ("xm", _BF, lambda s: (s.BT, s.C)),
    ("qkv", _BF, lambda s: (s.BT, 3 * s.C)), ("att", _BF, lambda s: (s.BT, s.C)),
    ("x1m", _BF, lambda s: (s.BT, s.C)), ("hid16", _BF, lambda s: (s.BT, s.F)),
    ("dc2", _BF, lambda s: (s.BT, s.C)), ("dc1", _BF, lambda s: (s.BT, s.F)),
    ("dy", _BF, lambda s: (s.BT, s.C)), ("doh", _BF, lambda s: (s.BT, s.C)),
    ("dqkv", _BF, lambda s: (s.BT, 3 * s.C)), ("dclog", _BF, lambda s: (s.BT, s.H * s.R)),
    ("bandp", _BF, lambda s: (s.BT, s.H * s.R)), ("stats", _F32, lambda s: (s.B * s.H * s.T, 4)),
    ("qr", _F32, lambda s: (s.B * s.H * s.T, BWD16_BAND)), ("dr", _F32, lambda s: (s.B * s.H * s.T, BWD16_BAND)),
    ("x1", _F32, lambda s: (s.BT, s.C)), ("zhat1", _F32, lambda s: (s.BT, s.C)),
    ("rinv1", _F32, lambda s: (1, s.BT)), ("hid", _F32, lambda s: (s.BT, s.F)),
    ("dz2", _F32, lambda s: (s.BT, s.C)), ("dz1", _F32, lambda s: (s.BT, s.C)),
    ("split_part", _F32, lambda s: (s.splits * s.BT, s.C)),
    ("row_part", _F32, lambda s: (6 * -(-s.BT // BWD16_ROW_BLOCK), s.C)),
    ("b1_part", _F32, lambda s: (s.B * -(-s.T // BWD16_TILE), s.F)),
    ("att_part", _F32, lambda s: (3 * s.B * -(-s.T // BWD16_ATT_ROWS), s.C)),
    ("band_part", _F32, lambda s: (2 * s.B * s.H * -(-s.T // BWD16_ATT_ROWS), s.R * (s.C // s.H))),
    ("wsum_part", _F32, lambda s: (1, max(s.wsum_floats, 1))),
)


@dataclass(frozen=True)
class _Bwd16Shape:
    B: int
    T: int
    C: int
    F: int
    H: int
    R: int
    k: int
    splits: int
    wsum_floats: int
    buffers: bool = False  # the forward's parts only for return_buffers

    @property
    def BT(self) -> int:
        return self.B * self.T


@dataclass(frozen=True)
class Bwd16Part:
    """One part of the bf16 backward's scratch: ``rows`` rows of ``width``
    elements of ``dtype``, ``pitch`` bytes apart, from byte ``offset``."""

    name: str
    dtype: torch.dtype
    rows: int
    width: int
    pitch: int
    offset: int

    @property
    def nbytes(self) -> int:
        return self.rows * self.pitch


@functools.lru_cache(maxsize=64)
def bwd16_splits(B: int, T: int, F: int, kernel_size: int, sms: int = 132) -> int:
    """The split of the 2,304-deep products (the FFN's second conv and W_1's
    transposed conv: kernel_size * F / 64 k-slices) over their k-slices:
    about two blocks an SM over the B * ceil(T / 64) * 3 output tiles, no
    split left empty."""
    slices = kernel_size * -(-F // 64)
    tiles = B * -(-T // BWD16_TILE) * -(-_build.ENC_CHANNELS // 64)
    want = max(1, min(slices, round(2 * sms / tiles)))
    per = -(-slices // want)
    return -(-slices // per)


# The bf16 forward's scratch (csrc/enc_layer_bf16.cu's FwdPart order): the
# packed weights and x masked, the recompute's activations, x1 and the split
# partials; the fp32 hid only for the caller's return_buffers (FWD16_BUFFERS
# are the parts it hands back).
FWD16_PARTS = (
    ("w_qkv", _BF, lambda s: (3 * s.C, s.C)), ("b_qkv", _BF, lambda s: (1, 3 * s.C)),
    ("w_o", _BF, lambda s: (s.C, s.C)), ("w_1", _BF, lambda s: (s.k * s.F, s.C)),
    ("w_2", _BF, lambda s: (s.k * s.C, s.F)), ("xm", _BF, lambda s: (s.BT, s.C)),
    ("qkv", _BF, lambda s: (s.BT, 3 * s.C)), ("att", _BF, lambda s: (s.BT, s.C)),
    ("x1m", _BF, lambda s: (s.BT, s.C)), ("hid16", _BF, lambda s: (s.BT, s.F)),
    ("x1", _F32, lambda s: (s.BT, s.C)), ("split_part", _F32, lambda s: (s.splits * s.BT, s.C)),
    ("hid", _F32, lambda s: (s.BT if s.buffers else 0, s.F)),
)
FWD16_BUFFERS = ("qkv", "att", "x1m", "hid")


def _laid_out(spec, s: "_Bwd16Shape") -> Tuple[Dict[str, Bwd16Part], int]:
    """The parts of ``spec`` (name, dtype, shape) at shape ``s`` in one
    allocation: ({name: part}, total bytes), each base BWD16_ALIGN-aligned,
    bf16 rows pitch8 of their width elements apart, fp32 rows pitch4."""
    parts, offset = {}, 0
    for name, dtype, shape in spec:
        rows, width = shape(s)
        size = torch.finfo(dtype).bits // 8
        per16 = 16 // size
        pitch = -(-width // per16) * per16 * size
        parts[name] = Bwd16Part(name, dtype, rows, width, pitch, offset)
        offset += -(-rows * pitch // BWD16_ALIGN) * BWD16_ALIGN
    return parts, offset


@functools.lru_cache(maxsize=64)
def bwd16_layout(B: int, T: int, C: int, F: int, n_heads: int, window: int, kernel_size: int, splits: int,
                 wsum_floats: int) -> Tuple[Dict[str, Bwd16Part], int]:
    """The bf16 backward's scratch and packed operands as one allocation:
    ({name: part} in BWD16_PARTS order, total bytes; cached by shape, not to
    be changed). Every base is BWD16_ALIGN-aligned and every row pitch a
    multiple of 16 bytes (TMA's rules for what it reads); the parts do not
    overlap."""
    return _laid_out(BWD16_PARTS, _Bwd16Shape(B, T, C, F, n_heads, 2 * window + 1, kernel_size, splits,
                                              wsum_floats))


@functools.lru_cache(maxsize=64)
def fwd16_layout(B: int, T: int, C: int, F: int, n_heads: int, window: int, kernel_size: int, splits: int,
                 buffers: bool) -> Tuple[Dict[str, Bwd16Part], int]:
    """The bf16 forward's scratch and packed operands as one allocation, by
    bwd16_layout's rules: ({name: part} in FWD16_PARTS order, total bytes;
    cached by shape, not to be changed); the fp32 hid empty unless
    ``buffers`` (the wrapper's return_buffers)."""
    return _laid_out(FWD16_PARTS, _Bwd16Shape(B, T, C, F, n_heads, 2 * window + 1, kernel_size, splits, 0,
                                              buffers))


def _part_view(scratch: torch.Tensor, part: Bwd16Part, shape: tuple) -> torch.Tensor:
    """A part of the scratch as a [rows, width] tensor of its dtype, reshaped (a copy where padded)."""
    flat = scratch[part.offset:part.offset + part.nbytes].view(part.dtype)
    return flat.view(part.rows, part.pitch // flat.element_size())[:, :part.width].reshape(shape)


def _launch_bwd16(x, lens, w: EncLayerWeights, g, seed, p_drop: float, return_buffers: bool):
    B, T, C = x.shape
    H, Fc, k = w.n_heads, w.w1.shape[0], w.w1.shape[2]
    lib = _build.build()
    shape = _shape_args(x, w)
    splits = bwd16_splits(B, T, Fc, k, _sm_count(x.device.index))
    wsum = _workspace_floats(lib.enc16_wsum_part_floats(*shape[:-1]))
    parts, total = bwd16_layout(B, T, C, Fc, H, w.window, k, splits, wsum)
    scratch = torch.empty(total, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    grads = {name: torch.empty_like(t) for name, t in w.tensors().items()}
    rc = lib.enc_layer_bwd_bf16(
        x.data_ptr(), lens.data_ptr(), seed.data_ptr(), g.data_ptr(),
        _pointers([t.data_ptr() for t in w.tensors().values()]), dx.data_ptr(),
        _pointers([t.data_ptr() for t in grads.values()]),
        _pointers([scratch.data_ptr() + part.offset for part in parts.values()]),
        *shape, keep_threshold(p_drop), keep_scale(p_drop), splits, _stream(x))
    if rc != 0:
        raise RuntimeError(f"enc_layer_bwd_bf16 launch failed with cudaError {rc}")
    enc_layer_backward.bf16_launches += 1
    if not return_buffers:
        return dx, grads
    bufs = {name: _part_view(scratch, parts[name], shape_)
            for name, shape_ in backward_buffer_shapes(x, w).items()}
    return dx, grads, bufs


def enc_layer_backward(x: torch.Tensor, lens: torch.Tensor, w: EncLayerWeights, g: torch.Tensor, seed,
                       p_drop: float = 0.0, return_buffers: bool = False):
    """(dx, {name: gradient}) for the output cotangent g.

    A CUDA fp32 tensor launches ``csrc/enc_layer_bwd.cu`` (the weights
    packed, the recomputed forward with its LayerNorm statistics and softmax
    (max, sum), the LayerNorm and FFN backwards, the attention backward as a
    dq and a dk/dv kernel that recompute P, dx, then two fixed-order
    reductions of the weight gradients, on the tensor cores and on the CUDA
    cores) and counts ``enc_layer_backward.launches``; a CUDA bf16 tensor
    launches ``csrc/enc_layer_bf16.cu`` on the scratch of
    ``bwd16_layout`` (one allocation) and counts ``.bf16_launches``. Two
    calls are bitwise equal. ``return_buffers`` adds the buffers of
    ``backward_buffer_shapes``. A CPU tensor runs
    ``enc_layer_backward_reference``; there ``return_buffers`` adds the plain
    recompute's q|k|v, att, x1m and hid (``recomputed_buffers``).
    """
    if x.device.type == "cpu":
        dx, grads = enc_layer_backward_reference(x, lens, w, g, seed, p_drop)
        return (dx, grads, recomputed_buffers(x, lens, w, seed, p_drop)) if return_buffers else (dx, grads)
    if x.device.type != "cuda":
        raise ValueError(f"enc_layer_backward: unsupported device {x.device}")
    _check_call(x, lens, w, seed)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous() or g.device != x.device:
        raise ValueError(f"enc_layer_backward: g must be a contiguous {x.dtype} {tuple(x.shape)} tensor, "
                         f"got {g.dtype}")
    if x.dtype == torch.bfloat16:
        return _launch_bwd16(x, lens, w, g, seed, p_drop, return_buffers)
    empty = lambda *shape: torch.empty(*shape, device=x.device, dtype=torch.float32)  # noqa: E731
    dx = torch.empty_like(x)
    grads = {name: torch.empty_like(t) for name, t in w.tensors().items()}
    bufs = {name: empty(*shape) for name, shape in backward_buffer_shapes(x, w).items()}
    pointers = lambda ts: _pointers([t.data_ptr() for t in ts])  # noqa: E731
    lib = _build.build()
    shape = _shape_args(x, w)
    workspace = empty(_workspace_floats(lib.enc_layer_bwd_workspace_floats(*shape[:-1])))
    rc = lib.enc_layer_bwd(
        x.data_ptr(), lens.data_ptr(), seed.data_ptr(), g.data_ptr(), pointers(list(w.tensors().values())),
        dx.data_ptr(), pointers(list(grads.values())), pointers(list(bufs.values())), workspace.data_ptr(),
        *shape, keep_threshold(p_drop), keep_scale(p_drop), _stream(x))
    if rc != 0:
        raise RuntimeError(f"enc_layer_bwd launch failed with cudaError {rc}")
    enc_layer_backward.launches += 1
    return (dx, grads, bufs) if return_buffers else (dx, grads)


class EncLayerFunction(torch.autograd.Function):
    """One encoder layer with a recompute backward: saves the input, the
    lengths, the seed and the weights, no activations."""

    @staticmethod
    def forward(ctx, x, lens, seed, p_drop, meta, *tensors):  # pylint: disable=arguments-differ
        w = EncLayerWeights(*tensors, *meta)
        out = enc_layer_reference(x, lens, w, seed, p_drop) if x.device.type == "cpu" else \
            _launch_fwd(x, lens, w, seed, p_drop)
        ctx.save_for_backward(x, lens, seed, *tensors)
        ctx.meta = (p_drop, meta)
        return out

    @staticmethod
    def backward(ctx, g):  # pylint: disable=arguments-differ
        x, lens, seed, *tensors = ctx.saved_tensors
        p_drop, meta = ctx.meta
        dx, grads = enc_layer_backward(x, lens, EncLayerWeights(*tensors, *meta), g.contiguous(), seed, p_drop)
        return (dx, None, None, None, None, *grads.values())


def enc_layer(x: torch.Tensor, lens: torch.Tensor, w: EncLayerWeights, seed=None,
              p_drop: float = 0.0, return_buffers: bool = False):
    """One encoder layer; same contract as ``enc_layer_reference`` at valid
    rows (rows at or past lens[b] are finite and unspecified), differentiable
    in x and every weight through ``EncLayerFunction``.

    A CUDA tensor launches ``csrc/enc_layer_fwd.cu`` (float32) or
    ``csrc/enc_layer_bf16.cu`` (bfloat16: the bf16 backward's recompute
    launches and LN2's forward, on the scratch of ``fwd16_layout``, one
    allocation) (C = 192 in heads of 96, lens int32 [B] and seed int64 [1]
    on the same device) and counts ``enc_layer.launches`` (fp32) or
    ``enc_layer.bf16_launches``; anything the kernels do not take raises. A
    CPU tensor runs the plain versions. ``return_buffers`` (for tests; bf16
    on the card, outside autograd) returns (out, {"qkv", "att", "x1m",
    "hid"}): the forward's buffers as ``enc_layer_backward`` returns the
    recompute's, dtypes and shapes as ``backward_buffer_shapes`` (the plain
    recompute's on the CPU, ``recomputed_buffers``).
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"enc_layer: unsupported device {x.device}")
    keep_threshold(p_drop)
    check_dtypes(x, w)
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int64, device=x.device)
    if return_buffers:
        with torch.no_grad():
            if x.device.type == "cpu":
                return enc_layer_reference(x, lens, w, seed, p_drop), recomputed_buffers(x, lens, w, seed, p_drop)
            _check_call(x, lens, w, seed)
            if x.dtype != torch.bfloat16:
                raise ValueError("enc_layer: return_buffers reads back the bf16 forward's buffers only")
            return _launch_fwd16(x, lens, w, seed, p_drop, return_buffers=True)
    return EncLayerFunction.apply(x, lens, seed, float(p_drop), (w.n_heads, w.window, w.eps),
                                  *w.tensors().values())


# launches of the fp32 kernels and of the bf16 ones
enc_layer.launches = enc_layer.bf16_launches = 0
enc_layer_backward.launches = enc_layer_backward.bf16_launches = 0
