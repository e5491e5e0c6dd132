"""VQ-TTS: text -> waveform through a grouped-VQ codec (counterpart of
speech_masters_thesis_tpu/models/vqtts/model.py).

Glow-TTS's TextEncoder and the VQ-VAE codec at ``width * multipliers[-1]``
channels and ``depth * multipliers[-1]`` branches, aligned by MAS over the
negative pairwise L2 distances between text and audio encodings, with the
per-phoneme ``GroupedBottleneck``, a ``ResNetBlock`` + 1x1 head that
predicts each frame's relative code from the aligned (detached) text
encodings, and the 6-term loss (reconstruction, STFT, commit, duration,
alignment, CE). On the card the codec's blocks run B1, MAS runs B4, and the
text encoder's layers B5 when ``fused_encoder`` is set (the plain layer
otherwise, as the config chooses). In eval mode the waveform ``yh`` is
decoded again from the predicted relative codes looked up in the full
codebook, the reference's quirk that the JAX package keeps. Train mode
draws the text encoder's and the quant decoder's dropout on the model's
device from ``generators["device_dropout"]``, the codec blocks' kernel
seeds from ``generators["dropout"]`` (CPU), and runs the codebook's lazy
init (first train step) and EMA update from ``generators["codebook"]``.
Speaker conditioning is not ported.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch.models.base import TokenToWaveformModel
from speech_masters_thesis_tpu_torch.models.glow_tts.encoder import TextEncoder
from speech_masters_thesis_tpu_torch.models.vqtts.bottleneck import GroupedBottleneck
from speech_masters_thesis_tpu_torch.models.vqvae.blocks import ResNetBlock
from speech_masters_thesis_tpu_torch.models.vqvae.encdec import Decoder, Encoder
from speech_masters_thesis_tpu_torch.models.vqvae.model import codec_kwargs
from speech_masters_thesis_tpu_torch.ops.basic import at_least_f32, pointwise, safe_log, sequence_mask
from speech_masters_thesis_tpu_torch.ops.losses import (
    MultiNormReconstructionLoss,
    MultiResolutionSpectralLoss,
    cross_entropy,
)
from speech_masters_thesis_tpu_torch.ops.mas import maximum_path_auto
from speech_masters_thesis_tpu_torch.parallel import mesh


def pairwise_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(|a_i - b_j|^2) for a [B, T_x, C], b [B, T_y, C] -> [B, T_x, T_y],
    as one batched product: |a|^2 - 2 a b^T + |b|^2, clamped at 1e-12."""
    a32, b32 = at_least_f32(a), at_least_f32(b)
    sq = (torch.sum(a32 * a32, dim=-1)[:, :, None]
          - 2.0 * (a32 @ b32.transpose(1, 2))
          + torch.sum(b32 * b32, dim=-1)[:, None, :])
    return torch.sqrt(torch.clamp(sq, min=1e-12))


class VQTTS(TokenToWaveformModel):
    """VQ-TTS at a ``model:`` config section and its dataset's settings.

    bf16 training (``make_train_step(..., bf16=True)``) follows the JAX
    model's dtypes: the codec's blocks in B1's bf16 mode, the text encoder's
    layers in B5's bf16 mode (``fused_encoder: true``) or its plain version
    (the config's route), ``pairwise_l2`` and the grouped bottleneck's
    distances in fp32 against the fp32 codebook (a buffer: it keeps its
    dtype), MAS (B4) in fp32."""

    USES_DATASET_CONFIG = True
    BF16_TRAINING = True

    def __init__(self, model_cfg: Mapping, dataset_config: Mapping):
        super().__init__()
        cfg, enc = model_cfg, model_cfg["encoder"]
        if cfg.get("n_speakers", 1) > 1 or cfg.get("gin_channels", 0):
            raise NotImplementedError("VQTTS: multi-speaker models are not ported")
        if cfg.get("folded_convs", False):
            raise ValueError("model.folded_convs is a rejected TPU experiment and is not ported")
        self.l_bins = cfg["l_bins"]
        self.l_commit = cfg["loss"]["commit"]
        self.l_stft = cfg["loss"]["multispectral"]
        self.l_align = cfg["loss"]["align"]

        codec = codec_kwargs(cfg)
        self.audio_encoder = Encoder(**codec)
        self.audio_decoder = Decoder(**codec)
        n_vocab = enc["n_vocab"] + int(dataset_config["intersperse_blanks"])
        self.text_encoder = TextEncoder(
            n_vocab=n_vocab,
            out_channels=enc["out_channels"],
            hidden_channels=enc["hidden_channels"],
            filter_channels=enc["filter_channels"],
            # the JAX model's width: encoder.filter_channels, not filter_channels_dp (model.py:104)
            filter_channels_dp=enc["filter_channels"],
            n_heads=enc["n_heads"],
            n_layers=enc["n_layers"],
            kernel_size=enc["kernel_size"],
            window_size=enc["window_size"],
            mean_only=enc["mean_only"],
            prenet=enc["prenet"],
            fused=cfg.get("fused_encoder", cfg.get("fused_blocks", False)),
            p_dropout=enc["p_dropout"],
        )
        self.quant_bottleneck = GroupedBottleneck(n_vocab * self.l_bins, cfg["emb_width"], cfg["mu"],
                                                  cfg["revival_threshold"], n_vocab, self.l_bins)
        # the JAX model's head: fixed depth, width and dropout (its p_dropout default, 0.1)
        self.quant_decoder = ResNetBlock(enc["out_channels"], 4, m_conv=2.0, dilation_growth_rate=3,
                                         dilation_cycle=None, zero_out=True, res_scale=False,
                                         reverse_dilation=True)
        self.quant_proj = nn.Conv1d(enc["out_channels"], self.l_bins, 1)

        loss_cfg = cfg["loss"]
        self.multi_stft_loss = MultiResolutionSpectralLoss(
            n_ffts=loss_cfg["n_ffts"], hop_lengths=loss_cfg["hop_lengths"],
            win_lengths=loss_cfg.get("win_lengths"), window=loss_cfg.get("window", "hann"),
            log=loss_cfg["log"])
        self.multi_recon_loss = MultiNormReconstructionLoss(
            l1=loss_cfg["l1"], l2=loss_cfg["l2"], linf=loss_cfg["linf"],
            linf_topk=loss_cfg["linf_topk"], linf_approx=loss_cfg.get("linf_approx", False))

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, y: torch.Tensor, y_lengths: torch.Tensor,
                speaker=None, train: bool = False,
                generators: Optional[Mapping[str, torch.Generator]] = None):  # pylint: disable=arguments-differ
        """x [B, T_x] token ids, y [B, T_y] waveform -> (losses: ``loss``,
        ``loss_recon``, ``loss_stft``, ``loss_commit``, ``loss_dur``,
        ``loss_align`` (reported / (1 + l_align)), ``loss_ce`` and ``yh``;
        {"q_acc"})."""
        if speaker is not None:
            raise NotImplementedError("VQTTS: speaker conditioning is not ported")
        gens = generators or {}
        device_gen, codec_gen = gens.get("device_dropout"), gens.get("dropout")
        x_enc, _, logw_enc, x_mask = self.text_encoder(x, x_lengths, train=train, generator=device_gen)

        y_mask = sequence_mask(y_lengths, y.shape[-1]).to(y.dtype)
        y_enc, q_mask = self.audio_encoder(y[..., None], y_mask[..., None], train, codec_gen)

        distances = pairwise_l2(x_enc, y_enc)                                     # [B, T_x, T_q]
        attn_mask = x_mask[:, :, 0][:, :, None] * q_mask[:, :, 0][:, None, :]
        with torch.no_grad():
            attn = maximum_path_auto(-distances.detach(), attn_mask)
            # the path is fp32 (JAX's path * mask), and what it aligns promotes to it under bf16
            attn = attn.to(torch.promote_types(attn.dtype, x_enc.dtype))

        y_q, y_d, loss_commit, _ = self.quant_bottleneck(y_enc, x, attn, update_k=train,
                                                         generator=gens.get("codebook"))

        # predict each frame's relative code from the aligned, detached text encodings
        aligned_text = (attn.transpose(1, 2) @ x_enc.to(attn.dtype)).detach()
        y_qh, _ = self.quant_decoder(aligned_text, q_mask, train, device_gen)
        y_qh = y_qh * q_mask
        y_qh = pointwise(y_qh, self.quant_proj.weight.to(y_qh.dtype), self.quant_proj.bias.to(y_qh.dtype))

        y_h, _ = self.audio_decoder(y_d, q_mask, train, codec_gen)
        y_h = y_h[..., 0]

        logw_dec = safe_log(torch.sum(attn, dim=-1)) * x_mask[:, :, 0]
        loss_recon = self.multi_recon_loss(y, y_h, y_mask)
        loss_stft = self.multi_stft_loss(y, y_h, y_mask)
        # the data-parallel rank's share of the global batch's losses (parallel/mesh.py)
        loss_dur = torch.sum((logw_enc - logw_dec) ** 2) / mesh.global_sum(torch.sum(x_lengths))
        loss_align = torch.sum(distances * attn) / torch.clamp(mesh.global_sum(torch.sum(attn_mask)), min=1.0)
        # the JAX model's unmasked mean over every frame, padding included
        loss_ce = cross_entropy(y_qh.reshape(-1, self.l_bins), y_q.reshape(-1))
        loss = (loss_recon + self.l_stft * loss_stft + self.l_commit * loss_commit
                + loss_dur + self.l_align * loss_align + loss_ce)

        if not train:
            # the reference's quirk: the predicted RELATIVE code indexes the full codebook
            y_d_pred = self.quant_bottleneck.k[torch.argmax(y_qh, dim=-1)]
            y_h, _ = self.audio_decoder(y_d_pred, q_mask)
            y_h = y_h[..., 0]

        q_acc = mesh.global_mean((torch.argmax(y_qh, dim=-1) == y_q).to(torch.float32))
        return {
            "loss": loss,
            "loss_recon": loss_recon,
            "loss_stft": loss_stft,
            "loss_commit": loss_commit,
            "loss_dur": loss_dur,
            "loss_align": loss_align / (1 + self.l_align),
            "loss_ce": loss_ce,
            "yh": y_h,
        }, {"q_acc": q_acc}
