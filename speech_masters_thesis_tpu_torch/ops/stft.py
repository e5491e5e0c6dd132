"""STFT magnitude (counterpart of speech_masters_thesis_tpu/ops/stft.py).

Forward transform only: the inverse and ``MelSpectrogram`` are not ported
yet. The numpy window builders are copied from the JAX module, which imports
jax at module top. Layout: audio [B, T]; spectra [B, frames, bins].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.ops.basic import safe_sqrt


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Periodic Hann window (scipy.signal.get_window('hann', N, fftbins=True))."""
    n = win_length + 1 if not periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    return w[:win_length].astype(np.float64)


def make_window(window_type: str, win_length: int) -> np.ndarray:
    """Named analysis window (scipy.signal.get_window(window, N, fftbins=True))."""
    if window_type in ("hann", "hanning"):
        return hann_window(win_length)
    from scipy.signal import get_window

    return np.asarray(get_window(window_type, win_length, fftbins=True), np.float64)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    lpad = (size - len(window)) // 2
    return np.pad(window, (lpad, size - len(window) - lpad))


def dft_basis(n_fft: int) -> np.ndarray:
    """Stacked real/imag DFT basis, shape (2*cutoff, n_fft): the real/imag
    parts of ``np.fft.fft(np.eye(n_fft))[:cutoff]``."""
    cutoff = n_fft // 2 + 1
    n = np.arange(n_fft)
    k = np.arange(cutoff)[:, None]
    angle = -2.0 * np.pi * k * n / n_fft
    return np.vstack([np.cos(angle), np.sin(angle)])


class STFT:
    """Magnitude STFT as a framed rFFT with reflect padding of (n_fft-hop)//2.

    ``frames == T // hop_length`` for T a multiple of hop, as in the JAX
    module. The window lives on the host and moves to the audio's device.
    """

    def __init__(self, n_fft: int = 1024, hop_length: int = 256,
                 win_length: int | None = None, window_type: str = "hann"):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length or n_fft
        assert n_fft >= self.win_length
        win = pad_center(make_window(window_type, self.win_length), n_fft)
        self.window = torch.from_numpy(win.astype(np.float32))

    @property
    def pad_amount(self) -> int:
        return (self.n_fft - self.hop_length) // 2

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, T] -> magnitude [B, frames, cutoff]."""
        real, imag = self.real_imag(audio)
        return safe_sqrt(real * real + imag * imag)

    def _frames(self, audio: torch.Tensor) -> torch.Tensor:
        """Reflect-pad and cut overlapping frames [B, frames, n_fft]."""
        if audio.ndim == 1:
            audio = audio[None, :]
        x = F.pad(audio.to(torch.float32)[:, None, :],
                  (self.pad_amount, self.pad_amount), mode="reflect")[:, 0]
        return x.unfold(-1, self.n_fft, self.hop_length)

    def real_imag(self, audio: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        frames = self._frames(audio) * self.window.to(audio.device)
        spec = torch.fft.rfft(frames, dim=-1)  # [B, frames, cutoff]
        return spec.real.to(torch.float32), spec.imag.to(torch.float32)
