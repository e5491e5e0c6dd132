"""Weights and train state from the JAX package's VQ-VAE into the port.

``vqvae_state_dict_from_jax`` takes the flax ``{"params", "codebook"}`` tree
as nested dicts of numpy arrays and returns tensors under the reference
checkpoint's keys, which the port's ``VQVAE`` loads with
``load_state_dict``. ``params_from_jax`` maps a params tree alone (the EMA
params of a JAX ``TrainState`` go through it too), and
``codebook_from_jax`` the whole codebook state (``k``, ``k_sum``, ``k_elem``,
``initialized``) under the bottleneck's buffer names, so a JAX ``TrainState``
and the port's can start from the same point. Conventions:

  flax Conv kernel [k, in, out]            -> torch Conv1d weight [out, in, k]
  ConvTranspose1d kernel [k, out, in]      -> torch ConvTranspose1d weight [in, out, k]
  codebook k [K, C]                        -> bottleneck.level_blocks.0.k
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a copy: jax arrays are read-only


def _conv(tree: dict, name: str, out: Dict[str, torch.Tensor]) -> None:
    """Conv and ConvTranspose1d alike: reverse the kernel's axes."""
    out[f"{name}.weight"] = _tensor(np.transpose(np.asarray(tree["kernel"]), (2, 1, 0)))
    out[f"{name}.bias"] = _tensor(tree["bias"])


def _gated_hifi(tree: dict, prefix: str, depth: int, out: Dict[str, torch.Tensor]) -> None:
    for d in range(depth):
        _conv(tree[f"branch_in_{d}"], f"{prefix}.blocks.{d}.0", out)
        _conv(tree[f"branch_res_{d}"]["Conv_0"], f"{prefix}.blocks.{d}.1.model.2", out)
        _conv(tree[f"branch_res_{d}"]["Conv_1"], f"{prefix}.blocks.{d}.1.model.5", out)
    _conv(tree["gate"], f"{prefix}.gate", out)


def params_from_jax(params: dict, model_cfg: dict) -> Dict[str, torch.Tensor]:
    """JAX VQVAE params tree (numpy) -> the port's parameters by name."""
    depth = model_cfg["depth"] * (model_cfg.get("multipliers") or [1] * model_cfg["levels"])[-1]
    sd: Dict[str, torch.Tensor] = {}
    for level, down_t in enumerate(model_cfg["downs_t"]):
        enc = params["encoder"][f"level_{level}"]
        p = f"encoders.0.level_blocks.{level}"
        for i in range(down_t):
            _conv(enc[f"MaskedConv1d_{i}"]["Conv_0"], f"{p}.blocks.{2 * i}", sd)
            _gated_hifi(enc[f"GatedHiFiBlock_{i}"], f"{p}.blocks.{2 * i + 1}", depth, sd)
        _conv(enc[f"MaskedConv1d_{down_t}"]["Conv_0"], f"{p}.blocks.{2 * down_t}", sd)

        dec = params["decoder"][f"level_{level}"]
        p = f"decoders.0.level_blocks.{level}"
        _conv(dec["MaskedConv1d_0"]["Conv_0"], f"{p}.blocks.0", sd)
        for i in range(down_t):
            _gated_hifi(dec[f"GatedHiFiBlock_{i}"], f"{p}.blocks.{2 * i + 1}", depth, sd)
            _conv(dec[f"MaskedConvTranspose1d_{i}"]["ConvTranspose1d_0"],
                  f"{p}.blocks.{2 * i + 2}", sd)
    _conv(params["decoder"]["out"], "decoders.0.out", sd)
    return sd


def codebook_from_jax(codebook: dict) -> Dict[str, torch.Tensor]:
    """JAX ``codebook`` collection (numpy) -> the bottleneck's buffers by name."""
    level = codebook["bottleneck"]["level_0"]
    prefix = "bottleneck.level_blocks.0"
    out = {f"{prefix}.{name}": _tensor(level[name]) for name in ("k", "k_sum", "k_elem")}
    out[f"{prefix}.initialized"] = torch.tensor(bool(np.asarray(level["initialized"])))
    return out


def vqvae_state_dict_from_jax(variables: dict, model_cfg: dict) -> Dict[str, torch.Tensor]:
    """JAX VQVAE ``{"params", "codebook"}`` (numpy) -> the port's ``state_dict``."""
    sd = params_from_jax(variables["params"], model_cfg)
    sd["bottleneck.level_blocks.0.k"] = _tensor(variables["codebook"]["bottleneck"]["level_0"]["k"])
    return sd
