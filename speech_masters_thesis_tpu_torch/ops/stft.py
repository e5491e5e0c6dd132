"""STFT, inverse STFT and log-mel (counterpart of
speech_masters_thesis_tpu/ops/stft.py).

The numpy builders (windows, DFT basis, the Slaney mel filterbank, the
window sum-square) are copied from the JAX module, which imports jax at
module top. ``cached_mel`` and ``host_mel`` are the data path's host mel:
the same operator on CPU tensors. Layout: audio [B, T]; spectra [B, frames, bins]. Phase jitter of
``MelSpectrogram`` is a training feature and is not ported yet.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.ops.basic import safe_log, safe_sqrt


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


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = freq / f_sp
    log_t = freq >= min_log_hz
    return np.where(log_t, min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep, mel)


def _mel_to_hz_slaney(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freq = f_sp * mel
    log_t = mel >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mel - min_log_mel)), freq)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: float | None = None) -> np.ndarray:
    """Slaney-scale, Slaney-normalized triangular mel filters, (n_mels, cutoff)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def window_sumsquare(window: np.ndarray, n_frames: int, hop_length: int, n_fft: int) -> np.ndarray:
    """Sum of squared, hop-shifted windows (librosa.filters.window_sumsquare)."""
    n = n_fft + hop_length * (n_frames - 1)
    out = np.zeros(n, dtype=np.float32)
    win_sq = window.astype(np.float64) ** 2
    for i in range(n_frames):
        sample = i * hop_length
        out[sample:min(n, sample + n_fft)] += win_sq[:max(0, min(n_fft, n - sample))]
    return out


def mel_band_edges(dataset_cfg: Mapping) -> Tuple[float, float]:
    """(f_min, f_max) of a dataset config: 0 and 8000 Hz unless it sets them."""
    return float(dataset_cfg.get("f_min", 0.0)), float(dataset_cfg.get("f_max", 8000.0))


class STFT:
    """Framed-rFFT STFT with reflect padding of (n_fft-hop)//2, and its
    window-sumsquare-corrected inverse.

    ``frames == T // hop_length`` for T a multiple of hop, as in the JAX
    module. The window and the inverse basis live on the host and move to
    the input's device (kept per device, as is the inverse's correction per
    frame count).
    """

    def __init__(self, n_fft: int = 1024, hop_length: int = 256,
                 win_length: int | None = None, window_type: str = "hann"):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length or n_fft
        if n_fft < self.win_length:
            raise ValueError(f"n_fft {n_fft} < win_length {self.win_length}")
        win = pad_center(make_window(window_type, self.win_length), n_fft)
        self.window_np = win
        self.window = torch.from_numpy(win.astype(np.float32))
        self._on_device: Dict[tuple, torch.Tensor] = {}

    def inverse_basis(self) -> torch.Tensor:
        """[2*cutoff, n_fft] windowed pinv of the scaled DFT basis (built on
        first use: a pinv of the forward transform's size)."""
        scale = self.n_fft / self.hop_length
        inverse = np.linalg.pinv(scale * dft_basis(self.n_fft)).T * self.window_np[None, :]
        return torch.from_numpy(inverse.astype(np.float32))

    @property
    def pad_amount(self) -> int:
        return (self.n_fft - self.hop_length) // 2

    def _const(self, name: str, device: torch.device, make) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._on_device:
            self._on_device[key] = make().to(device)
        return self._on_device[key]

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
        window = self._const("window", audio.device, lambda: self.window)
        spec = torch.fft.rfft(self._frames(audio) * window, dim=-1)  # [B, frames, cutoff]
        return spec.real.to(torch.float32), spec.imag.to(torch.float32)

    def inverse(self, magnitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        """[B, frames, cutoff] x2 -> [B, frames * hop]: one product with the
        pinv DFT basis per frame, overlap-add as ceil(n_fft/hop) shifted
        adds, the window-sumsquare correction, then the padding cut off."""
        if self.pad_amount == 0:
            raise ValueError("STFT.inverse needs hop_length < n_fft: with no padding to cut the "
                             "JAX version returns an empty signal")
        B, n_frames, _ = magnitude.shape
        device = magnitude.device
        rec = torch.cat([magnitude * torch.cos(phase), magnitude * torch.sin(phase)], dim=-1)
        frames = rec @ self._const("inverse_basis", device, self.inverse_basis)
        hop, n_fft = self.hop_length, self.n_fft
        n = (n_frames - 1) * hop + n_fft
        n_chunks = -(-n_fft // hop)
        total = (n_chunks - 1) * hop + n_frames * hop
        out = torch.zeros(B, total, device=device, dtype=frames.dtype)
        for q in range(n_chunks):
            width = min(hop, n_fft - q * hop)
            piece = F.pad(frames[..., q * hop:q * hop + width], (0, hop - width))
            out[:, q * hop:q * hop + n_frames * hop] += piece.reshape(B, n_frames * hop)

        def correction():
            wss = window_sumsquare(self.window_np, n_frames, hop, n_fft)
            tiny = np.finfo(np.float32).tiny
            return torch.from_numpy(np.where(wss > tiny, 1.0 / np.maximum(wss, tiny), 1.0).astype(np.float32))

        out = out[:, :n] * self._const(f"correction{n_frames}", device, correction)[None, :]
        out = out * (n_fft / hop)
        return out[:, self.pad_amount:-self.pad_amount]


class MelSpectrogram:
    """Log-mel operator: STFT magnitude -> Slaney mel product -> safe_log."""

    def __init__(self, sample_rate: int = 22050, n_fft: int = 1024, hop_length: int = 256,
                 win_length: int | None = None, n_mels: int = 80, f_min: float = 0.0,
                 f_max: float | None = None):
        self.stft = STFT(n_fft, hop_length, win_length)
        basis = mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max)
        self.mel_basis = torch.from_numpy(np.ascontiguousarray(basis.T))  # (cutoff, n_mels)

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, T] (or [T]) -> log-mel [B, frames, n_mels]."""
        if audio.ndim == 1:
            audio = audio[None, :]
        mag = self.stft(audio)
        basis = self.stft._const("mel_basis", audio.device, lambda: self.mel_basis)
        return safe_log(mag @ basis)


def mel_from_config(dataset_cfg: Mapping) -> MelSpectrogram:
    """The dataset config's log-mel operator."""
    return MelSpectrogram(dataset_cfg["sample_rate"], dataset_cfg["n_fft"], dataset_cfg["hop_length"],
                          dataset_cfg.get("win_length"), dataset_cfg["n_mels"], *mel_band_edges(dataset_cfg))


@functools.lru_cache(maxsize=16)
def cached_mel(sample_rate: int, n_fft: int, hop_length: int, win_length: Optional[int],
               n_mels: int, f_min: float, f_max: Optional[float]) -> MelSpectrogram:
    return MelSpectrogram(sample_rate, n_fft, hop_length, win_length, n_mels, f_min, f_max)


def host_mel(mel_op: MelSpectrogram, audio: np.ndarray) -> np.ndarray:
    """Log-mel of host audio on the CPU ([T] -> [1, frames, n_mels] float32):
    dataset workers call this per utterance and never touch the card."""
    with torch.inference_mode():
        return mel_op(torch.from_numpy(np.asarray(audio, np.float32))).numpy()
