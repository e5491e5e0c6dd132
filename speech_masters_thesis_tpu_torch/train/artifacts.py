"""Validation artifacts: audio as WAV and mel grids as ``.npy`` (counterpart
of speech_masters_thesis_tpu/train/artifacts.py, which draws PNG grids with
matplotlib; the machine with the card has neither matplotlib nor PIL).

Waveform models save the first clip's audio and prediction under
``audio/val_audio_<step>_{gt,pred}.wav`` and the log-mel of the first four
clips under ``spect/val_spect_<step>.npy`` ([2 (truth, prediction), n,
n_mels, frames], the host mel). Spectrogram models save the mel grid the
same way and the first clip's audio inverted from its mel by the port's
Griffin-Lim (``ops/griffin_lim.py``, on the CPU, initial phase from seed 0).
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from speech_masters_thesis_tpu_torch.ops.griffin_lim import make_mel_vocoder
from speech_masters_thesis_tpu_torch.ops.stft import cached_mel, host_mel, mel_band_edges
from speech_masters_thesis_tpu_torch.utils.audio_io import save_wav


def save_audio_and_computed_spect(config: Mapping, global_step: int, writer, audio: np.ndarray,
                                  audio_pred: np.ndarray, n: int = 4) -> None:
    """Waveform models: WAVs of the first clip and mel grids computed from the audio."""
    del writer
    ds = config["dataset"]
    mel_op = cached_mel(ds["sample_rate"], ds["n_fft"], ds["hop_length"], ds.get("win_length"), ds["n_mels"],
                        *mel_band_edges(ds))
    gt, pred = np.clip(audio[:n], -1, 1), np.clip(audio_pred[:n], -1, 1)
    _dump_audio_pair(config, global_step, gt[0], pred[0])
    _dump_grid(config, global_step, [host_mel(mel_op, a)[0].T for a in gt], [host_mel(mel_op, a)[0].T for a in pred])


def mel_to_audio(log_mel: np.ndarray, config: Mapping) -> np.ndarray:
    """[frames, n_mels] log-mel -> waveform: pinv-mel, then 32 Griffin-Lim iterations."""
    vocode = make_mel_vocoder(config["dataset"])
    return vocode(torch.from_numpy(np.ascontiguousarray(log_mel[None], np.float32)),
                  torch.Generator().manual_seed(0))[0].numpy()


def save_spect_and_inverted_audio(config: Mapping, global_step: int, writer, spect: np.ndarray,
                                  spect_pred: np.ndarray, n: int = 4) -> None:
    """Spectrogram models (spect [B, frames, n_mels] log-mel): mel grids and
    Griffin-Lim audio of the first clip."""
    del writer
    _dump_grid(config, global_step, list(np.transpose(spect[:n], (0, 2, 1))),
               list(np.transpose(spect_pred[:n], (0, 2, 1))))
    _dump_audio_pair(config, global_step, mel_to_audio(spect[0], config), mel_to_audio(spect_pred[0], config))


def _dump_audio_pair(config: Mapping, global_step: int, gt: np.ndarray, pred: np.ndarray) -> None:
    sr = config["dataset"]["sample_rate"]
    audio_dir = os.path.join(config["train"]["log_dir"], "audio")
    os.makedirs(audio_dir, exist_ok=True)
    save_wav(os.path.join(audio_dir, f"val_audio_{global_step}_gt.wav"), gt, sr)
    save_wav(os.path.join(audio_dir, f"val_audio_{global_step}_pred.wav"), pred, sr)


def _dump_grid(config: Mapping, global_step: int, spect: list, spect_pred: list) -> None:
    spect_dir = os.path.join(config["train"]["log_dir"], "spect")
    os.makedirs(spect_dir, exist_ok=True)
    save_mel_grid(os.path.join(spect_dir, f"val_spect_{global_step}.npy"), spect, spect_pred)


def save_mel_grid(path: str, spect: list, spect_pred: list) -> None:
    """Two lists of [n_mels, frames] mels as one float32 ``.npy`` [2, n,
    n_mels, frames], each zero-padded to the longest."""
    frames = max(s.shape[-1] for s in spect + spect_pred)
    grid = np.stack([np.stack([np.pad(s, ((0, 0), (0, frames - s.shape[-1]))) for s in side])
                     for side in (spect, spect_pred)]).astype(np.float32)
    np.save(path, grid)
