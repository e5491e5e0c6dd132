"""Task base classes: how models consume the canonical batch (counterpart of
speech_masters_thesis_tpu/models/base.py).

A batch is a dict with the keys ``token, token_len, spect, spect_len,
audio, audio_len, speaker`` (entries may be absent when the task elides
them). ``supervised_step`` routes the task's fields into ``forward`` and
attaches the ground truth ``y``. Only the waveform-reconstruction task (the
VQ-VAE) is ported.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

WAVEFORM_RECONSTRUCTION = "waveform_reconstruction"


class WaveformReconstructionModel(nn.Module):
    """Reconstructs audio waveform through encoding/decoding."""

    TASK = WAVEFORM_RECONSTRUCTION

    def supervised_step(self, batch: Mapping[str, torch.Tensor], train: bool = True,
                        generators: Optional[Mapping[str, torch.Generator]] = None):
        loss_dict, metrics = self(batch["audio"], batch["audio_len"], speaker=batch.get("speaker"),
                                  train=train, generators=generators)
        loss_dict["y"] = batch["audio"]
        return loss_dict, metrics
