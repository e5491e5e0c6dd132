"""Model factory and initialisation (counterpart of
speech_masters_thesis_tpu/train/harness.py, ``get_model`` and
``init_model_variables``).

``init_model_variables`` draws the parameters from a seed with the JAX
package's initializers (lecun-normal conv weights, zero biases, zero for the
``zero_out`` layers) and then runs the bottleneck's lazy codebook init on a
first batch, so the codebook starts from real encodings. The data loaders,
the CLI, checkpoints and the epoch loop are not ported.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch.ops.basic import sequence_mask
from speech_masters_thesis_tpu_torch.utils.registry import get_model as _get_model


def get_model(config: Mapping) -> nn.Module:
    """The model a config's ``model:`` section names in ``_import_``."""
    return _get_model(dict(config["model"]))


@torch.no_grad()
def init_model_variables(model: nn.Module, batch: Mapping[str, torch.Tensor], seed: int) -> None:
    """Seeded parameters, then the lazy codebook init on ``batch`` (on the
    model's device; the encoder runs in eval mode)."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if not isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
            continue
        weight = module.weight
        if getattr(module, "zero_init", False):
            nn.init.zeros_(weight)
        else:
            std = 1.0 / math.sqrt(weight[0].numel())
            weight.copy_(torch.randn(weight.shape, generator=gen) * std)
        nn.init.zeros_(module.bias)

    device = next(model.parameters()).device
    audio = batch["audio"].to(device)
    mask = sequence_mask(batch["audio_len"].to(device), audio.shape[-1]).to(audio.dtype)
    h, h_mask = model.encoders[0](audio[..., None], mask[..., None])
    codebook_gen = torch.Generator(device=device).manual_seed(seed + 1)
    block = model.bottleneck.level_blocks[0]
    block._maybe_init(h.reshape(-1, h.shape[-1]), h_mask.reshape(-1), codebook_gen)
