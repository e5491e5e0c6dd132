"""Model registry: ``_import_`` strings and short names -> the port's classes.

Counterpart of speech_masters_thesis_tpu/utils/registry.py (the table) and
``train/harness.py:get_model``.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Optional

import torch

from speech_masters_thesis_tpu_torch.device import cuda_device

_MODEL_PATHS: Dict[str, str] = {
    "models.vqvae.vqvae.VQVAE": "speech_masters_thesis_tpu_torch.models.vqvae.model:VQVAE",
    "vqvae": "speech_masters_thesis_tpu_torch.models.vqvae.model:VQVAE",
    "models.transformer_lm.transformer_lm.TransformerLM":
        "speech_masters_thesis_tpu_torch.models.transformer_lm.model:TransformerLM",
    "transformer_lm": "speech_masters_thesis_tpu_torch.models.transformer_lm.model:TransformerLM",
    "models.glow_tts.glow_tts.GlowTTS": "speech_masters_thesis_tpu_torch.models.glow_tts.model:GlowTTS",
    "glow_tts": "speech_masters_thesis_tpu_torch.models.glow_tts.model:GlowTTS",
    "models.vqtts.vqtts.VQTTS": "speech_masters_thesis_tpu_torch.models.vqtts.model:VQTTS",
    "vqtts": "speech_masters_thesis_tpu_torch.models.vqtts.model:VQTTS",
}


def resolve_model(import_path: str) -> Any:
    if import_path not in _MODEL_PATHS:
        raise KeyError(f"Unknown or not yet ported model '{import_path}'. Known: {sorted(_MODEL_PATHS)}")
    module_name, attr = _MODEL_PATHS[import_path].split(":")
    return getattr(importlib.import_module(module_name), attr)


def get_model(model_cfg: dict, device: Optional[torch.device | str] = None, **kwargs):
    """Builds the model a ``model:`` config section names in ``_import_``, on
    ``device`` (the card, ``device.cuda_device()``, unless the caller asks
    for another); ``kwargs`` go to its constructor (the LM's
    ``vqvae_model_config``, Glow-TTS's and VQ-TTS's ``dataset_config``)."""
    device = cuda_device() if device is None else torch.device(device)
    return resolve_model(model_cfg["_import_"])(model_cfg, **kwargs).to(device)
