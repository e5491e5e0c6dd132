"""Library-level inference (counterpart of
speech_masters_thesis_tpu/inference.py).

``load_model_from_logdir`` builds the model a training log dir's
``config.json`` names and loads its checkpoint's model state (the raw
parameters and the codebook buffers, not the EMA copy, as the JAX function
loads ``state.params``), on the card unless the caller passes a device.

``GlowTTSSynthesizer`` takes a log dir and a checkpoint tag, or a built
Glow-TTS and its config. It builds the flow cache once, after the weights
are loaded, on a copy of the model that it owns (a caller's module keeps its
uncached weight-norm route, as the JAX synthesizer keeps the cache in its own
variables). ``encode_text`` is the text frontend (CMUdict, blanks
interspersed when the dataset says so), ``synthesize`` runs text ->
``GlowTTS.infer`` -> log-mel and inverts it on the host
(``train/artifacts.py:mel_to_audio``), as the JAX method does;
``synthesize_ids`` runs token ids -> mel -> device Griffin-Lim, with the
padded tail of each mel silenced first, as scripts/synthesize.py:116-119
does.

``LMSampler`` samples codes from a trained Transformer LM (KV-cached,
``TransformerLM.sample``) and decodes them through its frozen codec.
"""

from __future__ import annotations

import copy
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch.models.glow_tts.flows import build_flow_cache
from speech_masters_thesis_tpu_torch.models.glow_tts.model import GlowTTS
from speech_masters_thesis_tpu_torch.models.transformer_lm.model import TransformerLM
from speech_masters_thesis_tpu_torch.ops.basic import safe_log
from speech_masters_thesis_tpu_torch.ops.griffin_lim import make_mel_vocoder
from speech_masters_thesis_tpu_torch.text.parser import CMUDictParser, intersperse_blanks
from speech_masters_thesis_tpu_torch.train.artifacts import mel_to_audio
from speech_masters_thesis_tpu_torch.train.checkpoint import ckpt_dir, load_model_state, restore_model_state
from speech_masters_thesis_tpu_torch.train.harness import get_model
from speech_masters_thesis_tpu_torch.utils.config import Config, load_config


def load_model_from_logdir(log_dir: str, ckpt_num, device: Optional[torch.device | str] = None
                           ) -> Tuple[nn.Module, Config]:
    """(model in eval mode with ``ckpt.<ckpt_num>``'s model state, config)
    from a training log dir; the model holds its variables, which the JAX
    function returns beside it."""
    config = load_config(os.path.join(log_dir, "config.json"))
    model = get_model(config, device=device)
    load_model_state(model, restore_model_state(ckpt_dir(log_dir, ckpt_num)))
    return model.eval(), config


class GlowTTSSynthesizer:
    """Text -> (mel, waveform) through a Glow-TTS: ``GlowTTSSynthesizer(log_dir,
    ckpt_num)``, or ``GlowTTSSynthesizer(model, config)`` for a built model,
    which it copies."""

    def __init__(self, log_dir, ckpt_num, max_frames: int = 1024, flow_cache: bool = True, gl_iters: int = 32,
                 device: Optional[torch.device | str] = None):
        if isinstance(log_dir, nn.Module):
            model, config = copy.deepcopy(log_dir), ckpt_num
        else:
            model, config = load_model_from_logdir(log_dir, ckpt_num, device)
        if not isinstance(model, GlowTTS):
            raise TypeError(f"GlowTTSSynthesizer needs a GlowTTS, got {type(model).__name__}")
        self.model = model.eval()
        self.config = config
        self.max_frames = max_frames
        if flow_cache:
            build_flow_cache(self.model)
        self.vocode = make_mel_vocoder(config["dataset"], n_iter=gl_iters)
        self._parser = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def parser(self) -> CMUDictParser:
        """The dataset's CMUdict frontend, read on first use."""
        if self._parser is None:
            self._parser = CMUDictParser(self.config["dataset"]["cmudict_path"])
        return self._parser

    def encode_text(self, text: str) -> np.ndarray:
        """Text -> int32 token ids: a final "." unless it ends in ".!?", the
        CMUdict parse, and blanks interspersed when the dataset says so."""
        text = text.strip()
        if text[-1] not in [".", "!", "?"]:
            text = text + "."
        ids = self.parser(text)
        if self.config["dataset"]["intersperse_blanks"]:
            ids = intersperse_blanks(ids, len(self.parser.symbols))
        return np.asarray(ids, np.int32)

    @torch.no_grad()
    def synthesize(self, text: str, seed: int = 0, noise_scale: float = 0.667,
                   invert_audio: bool = True) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Returns (log-mel [frames, n_mels], waveform or None), the latent
        noise drawn from ``seed`` on the model's device and the waveform
        inverted on the host."""
        ids = torch.from_numpy(self.encode_text(text).astype(np.int64))[None]
        mel, z_lengths = self.synthesize_mel(ids, torch.Generator(device=self.device).manual_seed(seed),
                                             noise_scale)
        mel_np = mel[0, :int(z_lengths[0])].float().cpu().numpy()
        return mel_np, (mel_to_audio(mel_np, self.config) if invert_audio else None)

    @torch.no_grad()
    def synthesize_mel(self, ids: torch.Tensor, generator: Optional[torch.Generator] = None,
                       noise_scale: float = 0.667, lengths: Optional[torch.Tensor] = None):
        """ids [B, T] (lengths [B], default T) -> (mel [B, frames, n_mels], z_lengths [B])."""
        ids = ids.to(self.device)
        if lengths is None:
            lengths = torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int64, device=self.device)
        return self.model.infer(ids, lengths.to(self.device), generator=generator, max_frames=self.max_frames,
                                noise_scale=noise_scale)

    @torch.no_grad()
    def synthesize_ids(self, ids: torch.Tensor, generator: Optional[torch.Generator] = None,
                       noise_scale: float = 0.667, lengths: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """ids [B, T] -> (mel [B, frames, n_mels], waveform [B, frames * hop],
        z_lengths [B]). The latent noise and Griffin-Lim's initial phase come
        from ``generator`` (on the model's device)."""
        mel, z_lengths = self.synthesize_mel(ids, generator, noise_scale, lengths)
        frame = torch.arange(mel.shape[1], device=mel.device)[None, :, None]
        silent = safe_log(torch.zeros((), device=mel.device))
        mel_m = torch.where(frame < z_lengths[:, None, None], mel, silent)
        return mel, self.vocode(mel_m, generator=generator), z_lengths


class LMSampler:
    """Unconditional audio sampling from a trained Transformer LM's log dir."""

    def __init__(self, log_dir: str, ckpt_num, device: Optional[torch.device | str] = None):
        self.model, self.config = load_model_from_logdir(log_dir, ckpt_num, device)
        if not isinstance(self.model, TransformerLM):
            raise TypeError(f"LMSampler needs a TransformerLM, got {type(self.model).__name__}")

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def sample(self, n_samples: int, n_steps: int, sigma: float = 1.0,
               seed: int = 0) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """Returns (audio [B, T] or None without a codec, codes [B, n_steps]),
        drawn from ``seed`` on the model's device."""
        audio, codes = self.model.sample(n_samples, n_steps, torch.Generator(device=self.device).manual_seed(seed),
                                         sigma=sigma)
        return (None if audio is None else audio.float().cpu().numpy()), codes.cpu().numpy()
