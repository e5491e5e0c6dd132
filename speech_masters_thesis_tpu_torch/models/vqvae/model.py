"""VQ-VAE raw-waveform codec (counterpart of
speech_masters_thesis_tpu/models/vqvae/model.py).

One encoder/decoder over the full down stack with ``width *
multipliers[-1]`` channels, as the JAX package builds it; module names
(``encoders.0``, ``decoders.0``, ``bottleneck``) follow the reference
checkpoint. Waveforms are [B, T] in [-1, 1]; encodings are
[B, T / compression_factor, C]. ``encode``, ``decode``, and the forward in
eval mode (the val step) and in train mode, which updates the codebook and
returns the quantizer metrics.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch.models.base import WaveformReconstructionModel
from speech_masters_thesis_tpu_torch.models.vqvae.bottleneck import Bottleneck
from speech_masters_thesis_tpu_torch.models.vqvae.encdec import Decoder, Encoder
from speech_masters_thesis_tpu_torch.ops.basic import sequence_mask
from speech_masters_thesis_tpu_torch.ops.losses import (
    MultiNormReconstructionLoss,
    MultiResolutionSpectralLoss,
)


def compression_factor(model_cfg: dict) -> int:
    """prod(stride**down) over all levels."""
    total = 1
    for down, stride in zip(model_cfg["downs_t"], model_cfg["strides_t"]):
        total *= stride ** down
    return total


def codec_kwargs(model_cfg: dict) -> dict:
    """Encoder/decoder arguments of a VQ-VAE ``model:`` section: one stack of
    ``width * multipliers[-1]`` channels and ``depth * multipliers[-1]``
    branches per block (the JAX package's single-level build, which the
    LM's frozen decoder uses too)."""
    cfg = model_cfg
    multiplier = (cfg.get("multipliers") or [1] * cfg["levels"])[-1]
    return dict(
        input_emb_width=1,
        output_emb_width=cfg["emb_width"],
        downs_t=tuple(cfg["downs_t"]),
        strides_t=tuple(cfg["strides_t"]),
        block_type=cfg["block_type"],
        width=cfg["width"] * multiplier,
        depth=cfg["depth"] * multiplier,
        dilation_growth_rate=cfg["dilation_growth_rate"],
        dilation_cycle=cfg["dilation_cycle"],
        kernel_size_growth_rate=cfg["kernel_size_growth_rate"],
        kernel_size_cycle=cfg["kernel_size_cycle"],
        zero_out=cfg["zero_out"],
        # the reference hardwires ResLayer dropout 0.1; one knob, as in the JAX package
        p_dropout=cfg.get("p_dropout", 0.1),
    )


class VQVAE(WaveformReconstructionModel):
    """Codec built from a ``model:`` config dict (see ``configs.VQVAE_TPU``).

    Runs in float32 or, with bfloat16 parameters and audio (the train step's
    bf16 mode), in bfloat16 as the JAX modules do: the convs and B1's kernels
    in bf16, the bottleneck's distances, codebook updates and commitment
    loss and the losses in fp32, the codebook buffers fp32.
    """

    BF16_TRAINING = True  # B1's kernels have a bf16 mode (train.loop.make_train_step)

    def __init__(self, model_cfg: dict):
        super().__init__()
        cfg = model_cfg
        if cfg.get("folded_convs", False):
            raise ValueError("model.folded_convs is a rejected TPU experiment and is not ported")
        if not cfg.get("use_bottleneck", True):
            raise NotImplementedError("use_bottleneck: false is not ported yet")
        common = codec_kwargs(cfg)
        self.encoders = nn.ModuleList([Encoder(**common)])
        self.decoders = nn.ModuleList([Decoder(**common)])
        self.bottleneck = Bottleneck(cfg["l_bins"], cfg["emb_width"], cfg["mu"], 1,
                                     cfg["revival_threshold"])

        loss_cfg = cfg["loss"]
        self.multi_stft_loss = MultiResolutionSpectralLoss(
            n_ffts=loss_cfg["n_ffts"], hop_lengths=loss_cfg["hop_lengths"],
            win_lengths=loss_cfg.get("win_lengths"), window=loss_cfg.get("window", "hann"),
            log=loss_cfg["log"])
        self.multi_recon_loss = MultiNormReconstructionLoss(
            l1=loss_cfg["l1"], l2=loss_cfg["l2"], linf=loss_cfg["linf"],
            linf_topk=loss_cfg["linf_topk"], linf_approx=loss_cfg.get("linf_approx", False))
        self.commit = loss_cfg["commit"]
        self.multispectral = loss_cfg["multispectral"]

    def encode(self, x: torch.Tensor, mask: torch.Tensor):
        """[B, T] waveform + [B, T] mask -> (codes [B, T'], code_mask [B, T'])."""
        h, h_mask = self.encoders[0](x[..., None], mask[..., None])
        codes = self.bottleneck.encode([h], [h_mask[..., 0]])[0]
        return codes, h_mask[..., 0]

    def decode(self, codes: torch.Tensor, code_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, T'] codes -> [B, T' * compression] waveform."""
        if code_mask is None:
            code_mask = torch.ones(codes.shape, dtype=torch.float32, device=codes.device)
        x_d = self.bottleneck.decode([codes])[0]
        y, _ = self.decoders[0](x_d, code_mask[..., None])
        return y[..., 0]

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, speaker=None, train: bool = False,
                generators: Optional[Mapping[str, torch.Generator]] = None):
        """x: [B, T]; x_lengths: [B]. Returns (loss_dict, metrics).

        Train mode needs ``generators["dropout"]`` (a CPU generator: the
        blocks draw host-side seeds from it) and ``generators["codebook"]``
        (on the model's device); it updates the codebook in place and
        returns the quantizer metrics. Eval mode returns no metrics, as in
        the JAX package. ``speaker`` is accepted and unused.
        """
        del speaker
        gens = generators or {}
        dropout = gens.get("dropout")
        x_mask = sequence_mask(x_lengths, x.shape[-1]).to(x.dtype)
        h, h_mask = self.encoders[0](x[..., None], x_mask[..., None], train, dropout)
        _, xqs, commit_losses, quantizer_metrics = self.bottleneck(
            [h], [h_mask[..., 0]], update_k=train, generator=gens.get("codebook"))
        x_out, _ = self.decoders[0](xqs[0], h_mask, train, dropout)
        x_out = x_out[..., 0]
        assert x_out.shape == x.shape, f"Expected {x.shape}, got {x_out.shape}"

        loss_recon = self.multi_recon_loss(x, x_out, x_mask)
        loss_stft = self.multi_stft_loss(x, x_out, x_mask)
        loss_commit = sum(commit_losses)
        loss = loss_recon + self.multispectral * loss_stft + self.commit * loss_commit
        loss_dict = {
            "loss": loss,
            "loss_recon": loss_recon,
            "loss_stft": loss_stft,
            "loss_commit": loss_commit,
            "yh": x_out,
        }
        metrics = quantizer_metrics[-1] if (train and quantizer_metrics) else {}
        return loss_dict, metrics
