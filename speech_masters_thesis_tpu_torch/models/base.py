"""Task base classes: how models consume the canonical batch (counterpart of
speech_masters_thesis_tpu/models/base.py).

A batch is a dict with the keys ``token, token_len, spect, spect_len,
audio, audio_len, speaker`` (entries may be absent when the task elides
them). ``supervised_step`` routes the task's fields into ``forward`` and
attaches the ground truth ``y``; ``TASK_FEATURES`` says which features a
task's dataset loads and ``TASK_OUTPUT`` which val artifacts it writes. The waveform-reconstruction task (the
VQ-VAE), the token-to-waveform task (the Transformer LM) and the
token-to-spectrogram task (Glow-TTS) are ported.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

TOKEN_TO_WAVEFORM = "token_to_waveform"
WAVEFORM_RECONSTRUCTION = "waveform_reconstruction"
TOKEN_TO_SPECTROGRAM = "token_to_spectrogram"

# the batch features each task consumes (the dataset's elision, train/harness.py)
TASK_FEATURES = {
    TOKEN_TO_WAVEFORM: {"use_token": True, "use_spect": False, "use_audio": True},
    WAVEFORM_RECONSTRUCTION: {"use_token": False, "use_spect": False, "use_audio": True},
    TOKEN_TO_SPECTROGRAM: {"use_token": True, "use_spect": True, "use_audio": False},
}

# whether val artifacts are audio (mel computed from it) or mel (audio inverted from it)
TASK_OUTPUT = {
    TOKEN_TO_WAVEFORM: "waveform",
    WAVEFORM_RECONSTRUCTION: "waveform",
    TOKEN_TO_SPECTROGRAM: "spectrogram",
}


class TokenToWaveformModel(nn.Module):
    """Maps input tokens to audio waveform."""

    TASK = TOKEN_TO_WAVEFORM

    def supervised_step(self, batch: Mapping[str, torch.Tensor], train: bool = True,
                        generators: Optional[Mapping[str, torch.Generator]] = None):
        loss_dict, metrics = self(batch["token"], batch["token_len"], batch.get("audio"),
                                  batch.get("audio_len"), speaker=batch.get("speaker"), train=train,
                                  generators=generators)
        loss_dict["y"] = batch.get("audio")
        return loss_dict, metrics


class WaveformReconstructionModel(nn.Module):
    """Reconstructs audio waveform through encoding/decoding."""

    TASK = WAVEFORM_RECONSTRUCTION

    def supervised_step(self, batch: Mapping[str, torch.Tensor], train: bool = True,
                        generators: Optional[Mapping[str, torch.Generator]] = None):
        loss_dict, metrics = self(batch["audio"], batch["audio_len"], speaker=batch.get("speaker"),
                                  train=train, generators=generators)
        loss_dict["y"] = batch["audio"]
        return loss_dict, metrics


def spect_from_audio(model: nn.Module, batch: Mapping[str, torch.Tensor]):
    """Log-mel of the batch's raw audio on the audio's device, with the
    model's dataset settings (``dataset.on_device_spect``): (spect
    [B, frames, n_mels], spect_len = audio_len // hop). As in the JAX
    package, a clip shorter than the batch sees zeros, not its own reflect
    padding, at its right edge."""
    from speech_masters_thesis_tpu_torch.ops.stft import mel_from_config

    d = model.dataset_config
    if getattr(model, "mel_operator", None) is None:  # built once; keeps its constants per device
        model.mel_operator = mel_from_config(d)
    return model.mel_operator(batch["audio"]), batch["audio_len"] // d["hop_length"]


class TokenToSpectrogramModel(nn.Module):
    """Maps input tokens to a spectrogram."""

    TASK = TOKEN_TO_SPECTROGRAM

    def supervised_step(self, batch: Mapping[str, torch.Tensor], train: bool = True,
                        generators: Optional[Mapping[str, torch.Generator]] = None):
        spect, spect_len = batch.get("spect"), batch.get("spect_len")
        if spect is None and batch.get("audio") is not None:
            spect, spect_len = spect_from_audio(self, batch)
        loss_dict, metrics = self(batch["token"], batch["token_len"], spect, spect_len,
                                  speaker=batch.get("speaker"), train=train, generators=generators)
        loss_dict["y"] = spect
        return loss_dict, metrics
