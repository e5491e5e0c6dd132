"""Library-level inference (counterpart of
speech_masters_thesis_tpu/inference.py).

``GlowTTSSynthesizer`` takes a built Glow-TTS and its config (the JAX
version loads both from a log dir's orbax checkpoint, which waits for the
port's checkpoints; the text frontend waits too). It builds the flow cache
once, on a copy of the model that it owns (the caller's module keeps its
uncached weight-norm route, as the JAX synthesizer keeps the cache in its
own variables), and ``synthesize_ids`` runs token ids -> ``GlowTTS.infer`` -> device
Griffin-Lim, with the padded tail of each mel silenced first, as
scripts/synthesize.py:116-119 does.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional, Tuple

import torch

from speech_masters_thesis_tpu_torch.models.glow_tts.flows import build_flow_cache
from speech_masters_thesis_tpu_torch.models.glow_tts.model import GlowTTS
from speech_masters_thesis_tpu_torch.ops.basic import safe_log
from speech_masters_thesis_tpu_torch.ops.griffin_lim import make_mel_vocoder


class GlowTTSSynthesizer:
    """Token ids -> (log-mel, waveform) through a Glow-TTS on its device."""

    def __init__(self, model: GlowTTS, config: Mapping, max_frames: int = 1024, gl_iters: int = 32):
        if not isinstance(model, GlowTTS):
            raise TypeError(f"GlowTTSSynthesizer needs a GlowTTS, got {type(model).__name__}")
        self.model = copy.deepcopy(model).eval()
        self.config = config
        self.max_frames = max_frames
        build_flow_cache(self.model)
        self.vocode = make_mel_vocoder(config["dataset"], n_iter=gl_iters)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

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
