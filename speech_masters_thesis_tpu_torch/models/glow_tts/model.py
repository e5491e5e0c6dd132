"""Glow-TTS: text -> mel normalizing flow with monotonic alignment search
(counterpart of speech_masters_thesis_tpu/models/glow_tts/model.py).

``forward`` is the JAX ``__call__`` (model.py:129-183): mel -> latent
through the forward flow, the MAS log-prior table, MAS on the model's
device, the MLE and duration losses and, in eval mode, ``yh``, the mel that
the reverse flow makes from a draw of the aligned prior. In train mode every
dropout site of the JAX model drops, with masks and kernel seeds drawn on the
card from ``generators["device_dropout"]``, and the encoder-layer and
coupling kernels differentiate through their recompute backwards.
``ddi_init`` is the data-dependent ActNorm init (model.py:88-127): one
train-mode pass over a real batch that sets every ActNorm from its input.
``infer`` is ``model.py:185-213``: tokens -> durations -> ``generate_path``
-> the reverse flow. Mels are [B, frames, n_mels]. The normal draws come from
``noise`` when given (a test hands in JAX's own draw), else from
``generator`` (on the model's device; seed 0 when None, as the JAX model
falls back to PRNGKey(0)). Speaker conditioning is not ported.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from speech_masters_thesis_tpu_torch.models.base import TokenToSpectrogramModel, spect_from_audio
from speech_masters_thesis_tpu_torch.models.glow_tts.encoder import FlowSpecDecoder, TextEncoder
from speech_masters_thesis_tpu_torch.ops.basic import generate_path, sequence_mask
from speech_masters_thesis_tpu_torch.ops.mas import mas_log_prior, maximum_path_auto
from speech_masters_thesis_tpu_torch.parallel import mesh


def _normal(shape, like: torch.Tensor, noise: Optional[torch.Tensor],
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {tuple(shape)}")
        return noise.to(device=like.device, dtype=like.dtype)
    if generator is None:
        generator = torch.Generator(device=like.device).manual_seed(0)
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


class GlowTTS(TokenToSpectrogramModel):
    """Glow-TTS at a ``model:`` config section and its dataset's settings.

    bf16 training (``make_train_step(..., bf16=True)``): the forward on bf16
    parameters and batch follows the JAX model's dtypes: B5 and B3 in their
    bf16 modes, InvConvNear's slogdet and inverse in fp32, MAS (B4, fp32)
    on a log-prior of bf16 products that JAX's numpy constant promotes to
    fp32, the path fp32 and the aligned statistics with it, the losses
    reduced in the dtypes JAX reduces them in (fp32 where a term is). A mel
    batch keeps the flows in bf16; from audio (``on_device_spect``) the mel
    is fp32 and the flows run fp32, the weights promoted, as in JAX. On the
    flow-step route (B6, ``fused_flow_step: true``) the ActNorm's and the
    InvConvNear's parameters reach the kernel upcast to fp32, as JAX's
    decoder passes them (``FlowSpecDecoder``)."""

    USES_DATASET_CONFIG = True
    BF16_TRAINING = True

    def __init__(self, model_cfg: Mapping, dataset_config: Mapping):
        super().__init__()
        enc, dec = model_cfg["encoder"], model_cfg["decoder"]
        if model_cfg.get("n_speakers", 1) > 1 or model_cfg.get("gin_channels", 0):
            raise NotImplementedError("GlowTTS: multi-speaker models are not ported")
        self.dataset_config = dict(dataset_config)
        self.n_sqz = dec["n_sqz"]
        self.n_mels = dataset_config["n_mels"]
        fused_blocks = model_cfg.get("fused_blocks", False)
        self.encoder = TextEncoder(
            n_vocab=enc["n_vocab"] + int(dataset_config["intersperse_blanks"]),
            out_channels=self.n_mels,
            hidden_channels=enc["hidden_channels"],
            filter_channels=enc["filter_channels"],
            # the JAX model's width: encoder.filter_channels, not filter_channels_dp (model.py:50)
            filter_channels_dp=enc["filter_channels"],
            n_heads=enc["n_heads"],
            n_layers=enc["n_layers"],
            kernel_size=enc["kernel_size"],
            window_size=enc["window_size"],
            mean_only=enc["mean_only"],
            prenet=enc["prenet"],
            fused=model_cfg.get("fused_encoder", fused_blocks),
            p_dropout=enc["p_dropout"],
        )
        self.decoder = FlowSpecDecoder(
            in_channels=self.n_mels,
            hidden_channels=dec["hidden_channels"],
            kernel_size=dec["kernel_size"],
            dilation_rate=dec["dilation_rate"],
            n_blocks=dec["n_blocks"],
            n_layers=dec["n_layers"],
            n_split=dec["n_split"],
            n_sqz=dec["n_sqz"],
            sigmoid_scale=dec["sigmoid_scale"],
            fused=fused_blocks,
            fused_flow_step=model_cfg.get("fused_flow_step", True),
            p_dropout=dec["p_dropout"],
        )

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, y: torch.Tensor, y_lengths: torch.Tensor,
                speaker=None, train: bool = False, ddi: bool = False, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, generators=None):  # pylint: disable=arguments-differ
        """x [B, T_x] token ids, y [B, T_y, n_mels] log-mels -> (losses with
        ``loss_mle``, ``loss_length``, ``loss`` and, in eval mode, ``yh``; {}).
        Train mode needs ``generators["device_dropout"]`` on the model's
        device; ``ddi`` initialises every ActNorm from this batch."""
        if speaker is not None:
            raise NotImplementedError("GlowTTS: speaker conditioning is not ported")
        drop_gen = (generators or {}).get("device_dropout")
        if train and drop_gen is None:
            raise ValueError("GlowTTS in train mode needs generators['device_dropout']")
        x_m, x_logs, logw_enc, x_mask = self.encoder(x, x_lengths, train=train, generator=drop_gen)

        y_max_length = (y.shape[1] // self.n_sqz) * self.n_sqz
        y = y[:, :y_max_length]
        y_lengths = (y_lengths // self.n_sqz) * self.n_sqz
        y_mask = sequence_mask(y_lengths, y_max_length)[..., None].to(y.dtype)
        z_dec, logdet = self.decoder(y, y_mask, reverse=False, ddi=ddi, train=train, generator=drop_gen)

        attn_mask = x_mask[:, :, 0][:, :, None] * y_mask[:, :, 0][:, None, :]
        with torch.no_grad():
            logp = mas_log_prior(x_m.detach(), x_logs.detach(), z_dec.detach())
            attn = maximum_path_auto(logp, attn_mask)
            # the path is fp32 (JAX's path * mask): the aligned statistics promote to it under bf16
            attn = attn.to(torch.promote_types(attn.dtype, x_m.dtype))

        logw_dec = torch.log(1e-8 + attn.sum(dim=-1)) * x_mask[:, :, 0]
        attn_t = attn.transpose(1, 2)
        z_m_enc = attn_t @ x_m.to(attn.dtype)
        z_logs_enc = attn_t @ x_logs.to(attn.dtype)

        yh = None
        if not train:
            eps = _normal(z_m_enc.shape, z_m_enc, noise, generator)
            z_enc = (z_m_enc + torch.exp(z_logs_enc) * eps) * y_mask
            yh, _ = self.decoder(z_enc, y_mask, reverse=True)

        # the data-parallel rank's share of the global batch's losses (parallel/mesh.py)
        l_mle = mesh.local_share(0.5 * math.log(2 * math.pi)) + (
            torch.sum(z_logs_enc)
            + 0.5 * torch.sum(torch.exp(-2 * z_logs_enc) * (z_dec - z_m_enc) ** 2)
            - torch.sum(logdet)
        ) / (mesh.global_sum(torch.sum(y_lengths)) * z_dec.shape[-1])
        l_length = torch.sum((logw_enc - logw_dec) ** 2) / mesh.global_sum(torch.sum(x_lengths))
        return {"loss_mle": l_mle, "loss_length": l_length, "loss": l_mle + l_length, "yh": yh}, {}

    @torch.no_grad()
    def ddi_init(self, batch: Mapping[str, torch.Tensor], generators=None) -> None:
        """Data-dependent init: one train-mode pass over ``batch`` (the mel
        computed on the model's device when the batch carries audio) that sets
        every ActNorm's ``logs`` and ``bias`` from its own input, in place.
        The dropout generator defaults to seed 0 on the model's device, as the
        JAX package's pass uses PRNGKey(0)."""
        spect, spect_len = batch.get("spect"), batch.get("spect_len")
        if spect is None and batch.get("audio") is not None:
            spect, spect_len = spect_from_audio(self, batch)
        if generators is None:
            device = next(self.parameters()).device
            generators = {"device_dropout": torch.Generator(device=device).manual_seed(0)}
        self(batch["token"], batch["token_len"], spect, spect_len, speaker=batch.get("speaker"), train=True,
             ddi=True, generators=generators)

    @torch.no_grad()
    def infer(self, x: torch.Tensor, x_lengths: torch.Tensor, generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None, max_frames: int = 1024, noise_scale: float = 1.0):
        """Token ids [B, T_x] -> (mel [B, max_frames', n_mels], z_lengths [B]
        int32), max_frames' = max_frames rounded down to n_sqz; frames past
        a sequence's z_length are masked to zero. z_lengths is the predicted
        total duration and may exceed max_frames'."""
        x_m, x_logs, logw_enc, x_mask = self.encoder(x, x_lengths)
        w = torch.ceil(torch.exp(logw_enc)) * x_mask[:, :, 0]
        z_lengths = torch.clamp(torch.sum(w, dim=1), min=1.0).to(torch.int32)
        z_lengths = (z_lengths // self.n_sqz) * self.n_sqz
        t_y = (max_frames // self.n_sqz) * self.n_sqz
        z_mask = sequence_mask(z_lengths, t_y)[..., None]

        attn_mask = x_mask[:, :, 0][:, :, None] * z_mask[:, :, 0][:, None, :]
        attn_t = generate_path(w, attn_mask).transpose(1, 2)
        z_m_enc = attn_t @ x_m
        z_logs_enc = attn_t @ x_logs
        eps = _normal(z_m_enc.shape, z_m_enc, noise, generator)
        z_enc = (z_m_enc + torch.exp(z_logs_enc) * noise_scale * eps) * z_mask
        yh, _ = self.decoder(z_enc, z_mask, reverse=True)
        return yh, z_lengths
