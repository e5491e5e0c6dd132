"""Invertible flow layers for Glow-TTS (counterpart of
speech_masters_thesis_tpu/models/glow_tts/flows.py).

Activations are [B, T, C], masks [B, T, 1], lengths [B] int32. Every layer
maps (x, mask, lens, reverse, ddi, train, generator) -> (z, logdet), logdet
None in reverse; each uses the keywords it needs (ActNorm ``ddi``, the
coupling block ``train`` and ``generator``).
Parameters keep the reference checkpoint's names and layouts (ActNorm
``logs``/``bias`` [1, C, 1]; weight norm as ``weight_v`` [out, in, k] and
``weight_g`` [out, 1, 1]).

The flow cache (``build_flow_cache``): for inference, each ``WNConv1d``
folds its weight norm once and each ``InvConvNear`` stores its inverse
once, as non-persistent buffers that later calls read. ``clear_flow_cache``
drops them (the cached values do not follow parameter updates); a
train-mode coupling call with the cache built raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch.ops.basic import at_least_f32, draw_seed
from speech_masters_thesis_tpu_torch.ops.enc_layer import conv1d_ntc
from speech_masters_thesis_tpu_torch.ops.flow_step import flow_step, flow_step_reference
from speech_masters_thesis_tpu_torch.ops.wn_coupling import WNWeights, wn_coupling, wn_coupling_reference


class WNConv1d(nn.Module):
    """Weight-normalized Conv1d: w = g * v / ||v||, the norm over (in, k) per
    output channel (floored at 1e-12, as the JAX package does)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.weight_v = nn.Parameter(torch.zeros(out_channels, in_channels, kernel_size))
        self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("folded_weight", None, persistent=False)

    def weight(self) -> torch.Tensor:
        """The normalized weight [out, in, k]: the cached one when the flow
        cache is built."""
        if self.folded_weight is not None:
            return self.folded_weight
        norm = self.weight_v.flatten(1).norm(dim=1).clamp(min=1e-12)
        return self.weight_v * (self.weight_g.view(-1) / norm)[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # pylint: disable=arguments-differ
        return conv1d_ntc(x, self.weight(), self.bias, self.dilation)


class ActNorm(nn.Module):
    """Per-channel affine (``logs``, ``bias``); logdet sum(logs) * length.
    With ``ddi`` (data-dependent init) it first sets its parameters from its
    input's masked per-channel mean and variance, so that its output has
    mean 0 and variance 1 at valid frames, and applies them in the same pass:
    the layers after it see initialised ones (flows.py:90-107 of the JAX
    package)."""

    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(1, channels, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, x, mask, lens, reverse: bool = False, ddi: bool = False,
                **_) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:  # pylint: disable=arguments-differ
        if ddi:
            with torch.no_grad():
                denom = torch.clamp(mask.sum(dim=(0, 1)), min=1.0)
                mean = (x * mask).sum(dim=(0, 1)) / denom
                var = (x * x * mask).sum(dim=(0, 1)) / denom - mean * mean
                logs = -0.5 * torch.log(torch.clamp(var, min=1e-6))
                self.logs.copy_(logs.view_as(self.logs))
                self.bias.copy_((-mean * torch.exp(logs)).view_as(self.bias))
        logs, bias = self.logs.view(-1), self.bias.view(-1)
        if reverse:
            return (x - bias) * torch.exp(-logs) * mask, None
        return (bias + torch.exp(logs) * x) * mask, torch.sum(logs) * lens.to(x.dtype)


def _regroup(x: torch.Tensor, s: int) -> torch.Tensor:
    """[B, T, C] -> [B, T, s, C/s]: C factors as (2, C/s, s/2) and the group
    axis is (half, position in half), as the reference regroups."""
    b, t, c = x.shape
    return x.reshape(b, t, 2, c // s, s // 2).permute(0, 1, 2, 4, 3).reshape(b, t, s, c // s)


def _ungroup(z: torch.Tensor, s: int) -> torch.Tensor:
    b, t, _, cs = z.shape
    return z.reshape(b, t, 2, s // 2, cs).permute(0, 1, 2, 4, 3).reshape(b, t, s * cs)


class InvConvNear(nn.Module):
    """Invertible 1x1 conv over groups of ``n_split`` channels, one
    [n_split, n_split] ``weight``; logdet log|det w| * (C / n_split) * length."""

    def __init__(self, channels: int, n_split: int = 4):
        super().__init__()
        if channels % n_split:
            raise ValueError(f"InvConvNear: {channels} channels do not split into groups of {n_split}")
        self.n_split = n_split
        self.weight = nn.Parameter(torch.eye(n_split))
        self.register_buffer("weight_inv", None, persistent=False)
        self.register_buffer("position_eye", torch.eye(channels // n_split), persistent=False)

    def inverse(self) -> torch.Tensor:
        """weight's inverse, in fp32 (or fp64) from the weight as it is."""
        return self.weight_inv if self.weight_inv is not None else torch.linalg.inv(at_least_f32(self.weight))

    def dense_matrix_t(self) -> torch.Tensor:
        """The layer as one dense [C, C] matrix, transposed: forward(x) ==
        x @ dense_matrix_t() at valid frames. M[i, j] is weight[slot(i),
        slot(j)] where channels i and j share a group position, else 0
        (flows.py:169-179 of the JAX package, a gather there). Channel i
        factors as (half u, position v, place w), row-major, as ``_regroup``
        reads it, with slot = (u, w); so M^T is the transposed weight
        broadcast over (u, ., w, u', ., w') times the identity over (v, v'):
        the same values as the gather, and a gradient of M reaches the weight
        through a reduction rather than an indexed scatter."""
        c, h = self.position_eye.shape[0] * self.n_split, self.n_split // 2
        w_t = self.weight.t().reshape(2, 1, h, 2, 1, h)
        return (w_t * self.position_eye[None, :, None, None, :, None]).reshape(c, c)

    def forward(self, x, mask, lens, reverse: bool = False, **_):  # pylint: disable=arguments-differ
        """The n_split x n_split matrix work (slogdet, inverse) runs in fp32
        from the weight as it is, the weight applied in x's dtype, and the
        logdet in fp32 from lengths in x's dtype (flows.py:196-222 of the
        JAX package: under bf16 the lengths round above 256 there too)."""
        s = self.n_split
        w32 = at_least_f32(self.weight)
        if reverse:
            w, logdet = self.inverse().to(x.dtype), None
        else:
            w = w32.to(x.dtype)
            logdet = torch.linalg.slogdet(w32)[1] * (x.shape[2] / s) * lens.to(x.dtype).to(w32.dtype)
        z = torch.einsum("btsc,ks->btkc", _regroup(x, s), w)
        return _ungroup(z, s) * mask, logdet


class WN(nn.Module):
    """The WaveNet conditioner's layers: ``in_layers`` (dilated, 2H out) and
    ``res_skip_layers`` (2H out, H for the last), all weight-normalized."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int, n_layers: int):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("WN needs an odd kernel size")
        self.dilations = tuple(dilation_rate ** i for i in range(n_layers))
        self.in_layers = nn.ModuleList(
            WNConv1d(hidden_channels, 2 * hidden_channels, kernel_size, d) for d in self.dilations)
        self.res_skip_layers = nn.ModuleList(
            WNConv1d(hidden_channels, 2 * hidden_channels if i < n_layers - 1 else hidden_channels, 1)
            for i in range(n_layers))


class CouplingBlock(nn.Module):
    """Affine coupling: the second channel half is shifted and scaled by the
    conditioner (``start`` -> ``wn`` -> zero-initialised ``end``) of the
    first. The conditioner goes through the kernel wrapper
    ``ops.wn_coupling.wn_coupling`` when ``fused`` and T <= ``fused_max_t``
    (the JAX package's routing, flows.py:349), else through the plain
    version; in train mode both drop the conditioner's conv outputs with
    ``p_dropout``, under one seed per call drawn from ``generator`` on the
    activations' device (the JAX package draws one per call too,
    flows.py:451).

    With ``prefix`` = (aln, alb, mt), the ActNorm's logs and bias [C] and the
    InvConvNear's ``dense_matrix_t``, the block runs the whole flow step
    (ActNorm -> InvConvNear -> coupling) on x: through
    ``ops.flow_step.flow_step`` under the same rule, else
    ``flow_step_reference``, with its seed drawn at the same point, and the
    affine applied to the step's xc (flows.py:343-346 of the JAX package)."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, sigmoid_scale: bool = False, fused: bool = False, fused_max_t: int = 768,
                 p_dropout: float = 0.0):
        super().__init__()
        self.in_channels = in_channels
        self.p_dropout = p_dropout
        self.sigmoid_scale = sigmoid_scale
        self.fused = fused
        self.fused_max_t = fused_max_t
        self.start = WNConv1d(in_channels // 2, hidden_channels, 1)
        self.wn = WN(hidden_channels, kernel_size, dilation_rate, n_layers)
        self.end = nn.Conv1d(hidden_channels, in_channels, 1)
        self.end.zero_init = True
        # the seed of a call without dropout (the kernels do not read it): no draw, no launch
        self.register_buffer("zero_seed", torch.zeros(1, dtype=torch.int64), persistent=False)

    def conditioner_weights(self) -> WNWeights:
        return WNWeights(
            ws=self.start.weight(), bs=self.start.bias,
            win=tuple(m.weight() for m in self.wn.in_layers), bin=tuple(m.bias for m in self.wn.in_layers),
            wrs=tuple(m.weight() for m in self.wn.res_skip_layers),
            brs=tuple(m.bias for m in self.wn.res_skip_layers),
            wend=self.end.weight, bend=self.end.bias, dilations=self.wn.dilations,
            cached=self.start.folded_weight is not None)

    def forward(self, x, mask, lens, reverse: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None, prefix=None, **_):  # pylint: disable=arguments-differ
        half = self.in_channels // 2
        w = self.conditioner_weights()
        if w.ws.dtype != x.dtype:  # the JAX package's promotion at the products (fp32 flows, bf16 weights)
            dtype = torch.promote_types(w.ws.dtype, x.dtype)
            w = WNWeights.from_flat([t.to(dtype) for t in w.flat()], w.dilations)
            x = x.to(dtype)
        if train and w.cached:
            raise RuntimeError("CouplingBlock: the flow cache is for inference; clear_flow_cache before training")
        p = self.p_dropout if train else 0.0
        seed = draw_seed(generator, x.device) if p > 0 else self.zero_seed
        fused = self.fused and x.shape[1] <= self.fused_max_t
        if prefix is not None:
            if reverse:
                raise ValueError("CouplingBlock: the flow-step prefix runs the forward direction only")
            step = flow_step if fused else flow_step_reference
            xc, out = step(x, lens, *prefix, w, seed, p)
            x_0, x_1 = xc[..., :half], xc[..., half:]
        else:
            x_0, x_1 = x[..., :half], x[..., half:]
            out = (wn_coupling if fused else wn_coupling_reference)(x_0, lens, w, seed, p)
        m, logs = out[..., :half], out[..., half:]
        if self.sigmoid_scale:
            logs = torch.log(1e-6 + torch.sigmoid(logs + 2))
        if reverse:
            z_1, logdet = (x_1 - m) * torch.exp(-logs) * mask, None
        else:
            z_1 = (m + torch.exp(logs) * x_1) * mask
            logdet = torch.sum(logs * mask, dim=(1, 2))
        return torch.cat([x_0, z_1], dim=-1), logdet


@torch.no_grad()
def build_flow_cache(model: nn.Module) -> None:
    """Folds every WNConv1d's weight norm and stores every InvConvNear's
    inverse, once (the reference's ``remove_weight_norm`` and
    ``store_inverse``)."""
    for module in model.modules():
        if isinstance(module, WNConv1d):
            module.folded_weight = None
            module.folded_weight = module.weight().detach().clone()
        elif isinstance(module, InvConvNear):
            module.weight_inv = torch.linalg.inv(module.weight).detach().clone()


def clear_flow_cache(model: nn.Module) -> None:
    for module in model.modules():
        if isinstance(module, WNConv1d):
            module.folded_weight = None
        elif isinstance(module, InvConvNear):
            module.weight_inv = None


def invconv_qr_init(n_split: int, gen: torch.Generator) -> torch.Tensor:
    """A random orthogonal [n, n] matrix with det > 0 (QR of a normal draw,
    the first column negated when the determinant is negative)."""
    w = torch.linalg.qr(torch.randn(n_split, n_split, generator=gen))[0]
    if torch.det(w) < 0:
        w[:, 0] = -w[:, 0]
    return w


def squeeze(x: torch.Tensor, x_mask: torch.Tensor, n_sqz: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Folds n_sqz frames into channels: [B, T, C] -> [B, T/n, n*C] (frame-major channels)."""
    b, t, c = x.shape
    t = (t // n_sqz) * n_sqz
    x_sqz = x[:, :t].reshape(b, t // n_sqz, n_sqz * c)
    x_mask = x_mask[:, n_sqz - 1::n_sqz]
    return x_sqz * x_mask, x_mask


def unsqueeze(x: torch.Tensor, x_mask: torch.Tensor, n_sqz: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, n*C] -> [B, T*n, C] (inverse of squeeze)."""
    b, t, c = x.shape
    x_unsqz = x.reshape(b, t * n_sqz, c // n_sqz)
    x_mask = torch.repeat_interleave(x_mask, n_sqz, dim=1)
    return x_unsqz * x_mask, x_mask


def mask_lengths(mask: torch.Tensor) -> torch.Tensor:
    """[B, T, 1] 0/1 mask -> int32 lengths [B] (on the mask's device, no
    sync), summed in the mask's dtype as the JAX package sums them
    (flows.py:459): a bf16 sum holds integers exactly only up to 256 and
    rounds a longer length to the nearest even one (301 -> 300, 263 ->
    264), and the kernels then take that length."""
    return mask[..., 0].sum(dim=1).to(torch.int32)

