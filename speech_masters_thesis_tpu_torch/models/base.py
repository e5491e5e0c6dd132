"""Task base classes: how models consume the canonical batch (counterpart of
speech_masters_thesis_tpu/models/base.py).

A batch is a dict with the keys ``token, token_len, spect, spect_len,
audio, audio_len, speaker`` (entries may be absent when the task elides
them). ``supervised_step`` routes the task's fields into ``forward`` and
attaches the ground truth ``y``. The waveform-reconstruction task (the
VQ-VAE) and the token-to-waveform task (the Transformer LM) are ported.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

TOKEN_TO_WAVEFORM = "token_to_waveform"
WAVEFORM_RECONSTRUCTION = "waveform_reconstruction"


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
