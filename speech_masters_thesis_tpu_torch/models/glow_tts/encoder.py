"""Glow-TTS TextEncoder and FlowSpecDecoder (counterpart of
speech_masters_thesis_tpu/models/glow_tts/encoder.py).

Activations are [B, T, C]; module names follow the reference checkpoint.

Routes, as the JAX package chooses them:
  * TextEncoder: with ``fused`` and T <= ``fused_max_t`` (512) each layer is
    one call of ``ops.enc_layer.enc_layer`` (kernel B5 on the card), else
    of ``enc_layer_reference``, the unfused layer (encoder.py:149-177);
  * FlowSpecDecoder: with ``fused`` and ``fused_flow_step``, in the forward
    direction without DDI and at squeezed T <= 768, each flow step (ActNorm,
    InvConvNear, coupling) is one call of ``ops.flow_step.flow_step``
    (kernel B6 on the card) and the ActNorm and InvConvNear logdets are
    summed here (encoder.py:281-313); otherwise each coupling block's
    conditioner goes through ``ops.wn_coupling.wn_coupling`` (kernel B3)
    when ``fused`` and the squeezed T <= 768: DDI, the reverse pass and
    ``infer`` take B3. Train mode with dropout stays on B6: the JAX package
    turns B6 off away from a TPU (encoder.py:292-294) because its kernel's
    dropout needs the TPU's hardware generator, and the port's hashed
    dropout runs on every device.

Under bf16 mixed precision (``make_train_step(..., bf16=True)``) the
activations follow the JAX package's dtypes: the masks take the
activations' dtype, so a bf16 mask's lengths (``flows.mask_lengths``) are
bf16 sums, which round above 256 as the JAX package's do; both routes
round the layer's product operands to bf16 as B5's bf16 mode does (the
flax layers round where XLA materializes a tensor, which no op-by-op
rounding reproduces; the products' rounding is the nearer of the two,
tests/test_torch_bf16_vqtts_train.py).

In train mode every route drops with the model's rates: each encoder layer
and each coupling call draws one dropout seed on the card from the
``generator`` it is given (encoder.py:217-223), and the prenet's and the
duration predictor's masks come from the same generator. Both routes of a
layer draw the same masks for the same seed.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch.models.glow_tts.attention import (
    ChannelLayerNorm,
    ConvReluNorm,
    DurationPredictor,
    FeedForwardNetwork,
    RelativeSelfAttention,
)
from speech_masters_thesis_tpu_torch.models.glow_tts.flows import (
    ActNorm,
    CouplingBlock,
    InvConvNear,
    mask_lengths,
    squeeze,
    unsqueeze,
)
from speech_masters_thesis_tpu_torch.ops.basic import at_least_f32, draw_seed, pointwise, sequence_mask
from speech_masters_thesis_tpu_torch.ops.enc_layer import EncLayerWeights, enc_layer, enc_layer_reference


class TextEncoder(nn.Module):
    """Token ids -> prior statistics (mean, log-std), log-durations and the mask."""

    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int, filter_channels: int,
                 filter_channels_dp: int, n_heads: int, n_layers: int, kernel_size: int,
                 window_size: Optional[int], mean_only: bool = False, prenet: bool = False,
                 gin_channels: int = 0, fused: bool = False, fused_max_t: int = 512, p_dropout: float = 0.0):
        super().__init__()
        if gin_channels:
            raise NotImplementedError("TextEncoder: speaker conditioning is not ported")
        self.hidden_channels = hidden_channels
        self.p_dropout = p_dropout
        self.n_heads = n_heads
        self.window_size = window_size
        self.mean_only = mean_only
        self.fused = fused
        self.fused_max_t = fused_max_t
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        self.pre = ConvReluNorm(hidden_channels, hidden_channels, 5, 3) if prenet else None
        self.attn_layers = nn.ModuleList(
            RelativeSelfAttention(hidden_channels, hidden_channels, n_heads, window_size)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(ChannelLayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FeedForwardNetwork(hidden_channels, hidden_channels, filter_channels, kernel_size)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(ChannelLayerNorm(hidden_channels) for _ in range(n_layers))
        self.proj_m = nn.Conv1d(hidden_channels, out_channels, 1)
        self.proj_s = None if mean_only else nn.Conv1d(hidden_channels, out_channels, 1)
        self.proj_w = DurationPredictor(hidden_channels, filter_channels_dp, kernel_size)
        # the seed of a layer call without dropout (the kernels do not read it): no draw, no launch
        self.register_buffer("zero_seed", torch.zeros(1, dtype=torch.int64), persistent=False)

    def layer_weights(self, i: int) -> EncLayerWeights:
        """Layer i's weights as the fused layer takes them."""
        attn, ffn = self.attn_layers[i], self.ffn_layers[i]
        n1, n2 = self.norm_layers_1[i], self.norm_layers_2[i]
        return EncLayerWeights(
            wq=attn.conv_q.weight, bq=attn.conv_q.bias, wk=attn.conv_k.weight, bk=attn.conv_k.bias,
            wv=attn.conv_v.weight, bv=attn.conv_v.bias, rk=attn.emb_rel_k[0], rv=attn.emb_rel_v[0],
            wo=attn.conv_o.weight, bo=attn.conv_o.bias, g1=n1.gamma, be1=n1.beta,
            w1=ffn.conv_1.weight, b1=ffn.conv_1.bias, w2=ffn.conv_2.weight, b2=ffn.conv_2.bias,
            g2=n2.gamma, be2=n2.beta, n_heads=self.n_heads, window=self.window_size, eps=n1.eps)

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):  # pylint: disable=arguments-differ
        """text [B, T] ids -> (x_m, x_logs [B, T, out], logw [B, T], x_mask [B, T, 1])."""
        x = self.emb(text) * math.sqrt(self.hidden_channels)
        x_mask = sequence_mask(text_lengths, x.shape[1])[..., None].to(x.dtype)
        if self.pre is not None:
            x = self.pre(x, x_mask, train, generator)
        layer = enc_layer if self.fused and x.shape[1] <= self.fused_max_t else enc_layer_reference
        lens = text_lengths.to(torch.int32)
        p = self.p_dropout if train else 0.0
        for i in range(len(self.attn_layers)):
            x = layer(x, lens, self.layer_weights(i), draw_seed(generator, x.device) if p > 0 else self.zero_seed, p)
        x = x * x_mask
        x_m = pointwise(x, self.proj_m.weight, self.proj_m.bias) * x_mask
        if self.mean_only:
            x_logs = torch.zeros_like(x_m)
        else:
            x_logs = pointwise(x, self.proj_s.weight, self.proj_s.bias) * x_mask
        logw = self.proj_w(x.detach(), x_mask, p, generator)
        return x_m, x_logs, logw, x_mask


class FlowSpecDecoder(nn.Module):
    """Invertible mel <-> latent map: n_blocks x (ActNorm, InvConvNear,
    CouplingBlock) over n_sqz-squeezed frames (``flows.{3b, 3b+1, 3b+2}``)."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_blocks: int, n_layers: int, n_split: int = 4, n_sqz: int = 2,
                 sigmoid_scale: bool = False, gin_channels: int = 0, fused: bool = False,
                 fused_flow_step: bool = True, p_dropout: float = 0.0):
        super().__init__()
        if gin_channels:
            raise NotImplementedError("FlowSpecDecoder: speaker conditioning is not ported")
        self.n_sqz = n_sqz
        self.fused_flow_step = fused and fused_flow_step
        channels = in_channels * n_sqz
        flows = []
        for _ in range(n_blocks):
            flows.append(ActNorm(channels))
            flows.append(InvConvNear(channels, n_split))
            flows.append(CouplingBlock(channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                                       sigmoid_scale=sigmoid_scale, fused=fused, p_dropout=p_dropout))
        self.flows = nn.ModuleList(flows)

    def forward(self, spect: torch.Tensor, spect_mask: torch.Tensor, reverse: bool = False, ddi: bool = False,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:  # pylint: disable=arguments-differ
        """spect [B, T, C], spect_mask [B, T, 1] -> (x [B, T, C], logdet [B] or None);
        ``ddi`` initialises each ActNorm from the batch on the way."""
        x, x_mask = spect, spect_mask
        if self.n_sqz > 1:
            x, x_mask = squeeze(x, x_mask, self.n_sqz)
        lens = mask_lengths(x_mask)
        logdet_tot = None if reverse else 0.0
        if self.fused_flow_step and not reverse and not ddi and x.shape[1] <= self.flows[2].fused_max_t:
            # the JAX decoder's fused branch (encoder.py:296-318): the prefix's parameters upcast to at
            # least fp32 (mt built from the weight as it is, then upcast); the ActNorm's logdet in the
            # parameters' dtype on lengths in x's, the InvConvNear's slogdet in fp32 on those lengths
            x_len = lens.to(x.dtype)
            for actnorm, invconv, coupling in zip(self.flows[0::3], self.flows[1::3], self.flows[2::3]):
                prefix = (at_least_f32(actnorm.logs.view(-1)), at_least_f32(actnorm.bias.view(-1)),
                          at_least_f32(invconv.dense_matrix_t()))
                x, logdet_c = coupling(x, x_mask, lens, train=train, generator=generator, prefix=prefix)
                slogdet = torch.linalg.slogdet(at_least_f32(invconv.weight))[1]
                logdet_tot = logdet_tot + (torch.sum(actnorm.logs) * x_len
                                           + slogdet * (x.shape[2] / invconv.n_split) * x_len.to(slogdet.dtype)
                                           + logdet_c)
        else:
            for flow in (reversed(self.flows) if reverse else self.flows):
                x, logdet = flow(x, x_mask, lens, reverse=reverse, ddi=ddi, train=train, generator=generator)
                if not reverse:
                    logdet_tot = logdet_tot + logdet
        if self.n_sqz > 1:
            x, x_mask = unsqueeze(x, x_mask, self.n_sqz)
        return x, logdet_tot
