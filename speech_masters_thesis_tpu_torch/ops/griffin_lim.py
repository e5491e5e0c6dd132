"""Griffin-Lim mel inversion on the device (counterpart of
speech_masters_thesis_tpu/ops/griffin_lim.py).

mel -> pinv-mel magnitude -> n_iter x (inverse STFT -> STFT -> phase) ->
waveform, all on the mel's device. The initial phase is uniform in
[-pi, pi) from an explicit generator, or handed in as a tensor (``phase0``)
so a test can give both frameworks the same one.
"""

from __future__ import annotations

import functools
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from speech_masters_thesis_tpu_torch.ops.stft import STFT, mel_band_edges, mel_filterbank


def griffin_lim(mag: torch.Tensor, stft: STFT, phase0: torch.Tensor, n_iter: int = 32) -> torch.Tensor:
    """[B, frames, cutoff] magnitude and initial phase -> [B, frames * hop] waveform."""
    n_frames = mag.shape[1]
    phase = phase0
    for _ in range(n_iter):
        real, imag = stft.real_imag(stft.inverse(mag, phase))
        phase = torch.atan2(imag, real)[:, :n_frames]
    return stft.inverse(mag, phase)


@functools.lru_cache(maxsize=4)
def _mel_pinv(sample_rate: int, n_fft: int, n_mels: int, f_min: float, f_max: float) -> np.ndarray:
    fb = mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max)  # [n_mels, bins]
    return np.linalg.pinv(fb).T.astype(np.float32)                 # [n_mels, bins]


def make_mel_vocoder(dataset_cfg: Mapping, n_iter: int = 32) -> Callable:
    """(log_mel [B, frames, n_mels], generator=None, phase0=None) -> waveform
    [B, frames * hop]; log-mel as ``MelSpectrogram`` makes it."""
    n_fft = dataset_cfg["n_fft"]
    stft = STFT(n_fft, dataset_cfg["hop_length"], dataset_cfg.get("win_length") or n_fft)
    pinv_t = torch.from_numpy(_mel_pinv(dataset_cfg["sample_rate"], n_fft, dataset_cfg["n_mels"],
                                        *mel_band_edges(dataset_cfg)))
    on_device = {}

    def vocode(log_mel: torch.Tensor, generator: Optional[torch.Generator] = None,
               phase0: Optional[torch.Tensor] = None) -> torch.Tensor:
        device = log_mel.device
        if device not in on_device:
            on_device[device] = pinv_t.to(device)
        mag = torch.clamp(torch.exp(log_mel.to(torch.float32)) @ on_device[device], min=0.0)
        if phase0 is None:
            phase0 = torch.rand(mag.shape, generator=generator, device=device) * (2 * np.pi) - np.pi
        return griffin_lim(mag, stft, phase0.to(device), n_iter=n_iter)

    return vocode
