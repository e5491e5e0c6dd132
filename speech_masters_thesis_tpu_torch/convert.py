"""Weights and train state from the JAX package's VQ-VAE, Transformer LM,
Glow-TTS and VQ-TTS into the port.

``transformer_lm_params_from_jax`` maps an LM's params tree (its frozen
codec's decoder included); ``codebook_from_jax`` takes an LM's codebook
collection as well as a VQ-VAE's.

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
  flax Dense kernel [in, out]              -> torch Linear weight [out, in]
  flax LayerNorm scale                     -> torch LayerNorm weight
  WNConv1d v [k, in, out], g [out]         -> weight_v [out, in, k], weight_g [out, 1, 1]
  ChannelLayerNorm LayerNorm_0 scale/bias  -> gamma/beta
  ActNorm logs/bias [C]                    -> [1, C, 1]

``glow_tts_params_from_jax`` gives the reference checkpoint's layout, key for
key as ``tools/import_torch_checkpoint.py:export_glow_tts`` writes it (a
copy of that mapping: the port imports nothing from ``tools/``), and
``vqtts_state_dict_from_jax`` that of ``export_vqtts``.
"""

from __future__ import annotations

from typing import Dict, Optional

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


def _codec_depth(model_cfg: dict) -> int:
    return model_cfg["depth"] * (model_cfg.get("multipliers") or [1] * model_cfg["levels"])[-1]


def _decoder(tree: dict, prefix: str, model_cfg: dict, out: Dict[str, torch.Tensor]) -> None:
    """A JAX decoder tree -> the port's ``Decoder`` parameters under ``prefix``."""
    depth = _codec_depth(model_cfg)
    for level, down_t in enumerate(model_cfg["downs_t"]):
        dec = tree[f"level_{level}"]
        p = f"{prefix}.level_blocks.{level}"
        _conv(dec["MaskedConv1d_0"]["Conv_0"], f"{p}.blocks.0", out)
        for i in range(down_t):
            _gated_hifi(dec[f"GatedHiFiBlock_{i}"], f"{p}.blocks.{2 * i + 1}", depth, out)
            _conv(dec[f"MaskedConvTranspose1d_{i}"]["ConvTranspose1d_0"], f"{p}.blocks.{2 * i + 2}", out)
    _conv(tree["out"], f"{prefix}.out", out)


def _encoder(tree: dict, prefix: str, model_cfg: dict, out: Dict[str, torch.Tensor]) -> None:
    """A JAX encoder tree -> the port's ``Encoder`` parameters under ``prefix``."""
    depth = _codec_depth(model_cfg)
    for level, down_t in enumerate(model_cfg["downs_t"]):
        enc = tree[f"level_{level}"]
        p = f"{prefix}.level_blocks.{level}"
        for i in range(down_t):
            _conv(enc[f"MaskedConv1d_{i}"]["Conv_0"], f"{p}.blocks.{2 * i}", out)
            _gated_hifi(enc[f"GatedHiFiBlock_{i}"], f"{p}.blocks.{2 * i + 1}", depth, out)
        _conv(enc[f"MaskedConv1d_{down_t}"]["Conv_0"], f"{p}.blocks.{2 * down_t}", out)


def params_from_jax(params: dict, model_cfg: dict) -> Dict[str, torch.Tensor]:
    """JAX VQVAE params tree (numpy) -> the port's parameters by name."""
    sd: Dict[str, torch.Tensor] = {}
    _encoder(params["encoder"], "encoders.0", model_cfg, sd)
    _decoder(params["decoder"], "decoders.0", model_cfg, sd)
    return sd


def _codebook_level(level: dict, prefix: str) -> Dict[str, torch.Tensor]:
    out = {f"{prefix}.{name}": _tensor(level[name]) for name in ("k", "k_sum", "k_elem")}
    out[f"{prefix}.initialized"] = torch.tensor(bool(np.asarray(level["initialized"])))
    return out


def codebook_from_jax(codebook: dict) -> Dict[str, torch.Tensor]:
    """JAX ``codebook`` collection (numpy) -> the codebook buffers by name: a
    VQ-VAE's (``bottleneck.level_0`` -> ``bottleneck.level_blocks.0``), an
    LM's frozen codec's (``vqvae_bottleneck``) or VQ-TTS's grouped one
    (``quant_bottleneck``)."""
    for name in ("vqvae_bottleneck", "quant_bottleneck"):
        if name in codebook:
            return _codebook_level(codebook[name], name)
    return _codebook_level(codebook["bottleneck"]["level_0"], "bottleneck.level_blocks.0")


def vqvae_state_dict_from_jax(variables: dict, model_cfg: dict) -> Dict[str, torch.Tensor]:
    """JAX VQVAE ``{"params", "codebook"}`` (numpy) -> the port's ``state_dict``."""
    sd = params_from_jax(variables["params"], model_cfg)
    sd["bottleneck.level_blocks.0.k"] = _tensor(variables["codebook"]["bottleneck"]["level_0"]["k"])
    return sd


def _dense(tree: dict, name: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{name}.weight"] = _tensor(np.asarray(tree["kernel"]).T)
    out[f"{name}.bias"] = _tensor(tree["bias"])


def _layer_norm(tree: dict, name: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{name}.weight"] = _tensor(tree["scale"])
    out[f"{name}.bias"] = _tensor(tree["bias"])


def transformer_lm_params_from_jax(params: dict, vqvae_model_cfg: Optional[dict] = None
                                   ) -> Dict[str, torch.Tensor]:
    """JAX TransformerLM params tree (numpy) -> the port's parameters by name.

    Dense kernels [in, out] become Linear weights [out, in] (the packed
    in_proj as ``in_proj_weight`` [3C, C], torch MHA's layout), LayerNorm
    ``scale`` becomes ``weight``, the embedding table ``embedding.weight``;
    the frozen ``vqvae_decoder`` (when ``vqvae_model_cfg`` is given) goes
    through the codec's decoder mapping.
    """
    sd: Dict[str, torch.Tensor] = {"embedding.weight": _tensor(params["embedding"]["embedding"])}
    n_layers = sum(1 for name in params if name.startswith("layer_"))
    for i in range(n_layers):
        tree, p = params[f"layer_{i}"], f"transformer.layers.{i}"
        attn = tree["self_attn"]
        sd[f"{p}.self_attn.in_proj_weight"] = _tensor(np.asarray(attn["in_proj"]["kernel"]).T)
        sd[f"{p}.self_attn.in_proj_bias"] = _tensor(attn["in_proj"]["bias"])
        _dense(attn["out_proj"], f"{p}.self_attn.out_proj", sd)
        _dense(tree["linear1"], f"{p}.linear1", sd)
        _dense(tree["linear2"], f"{p}.linear2", sd)
        _layer_norm(tree["norm1"], f"{p}.norm1", sd)
        _layer_norm(tree["norm2"], f"{p}.norm2", sd)
    _layer_norm(params["final_norm"], "transformer.norm", sd)
    _dense(params["classifier"], "classifier", sd)
    if vqvae_model_cfg is not None:
        _decoder(params["vqvae_decoder"], "vqvae_decoder", vqvae_model_cfg, sd)
    return sd


def _wn_conv(tree: dict, name: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{name}.weight_v"] = _tensor(np.transpose(np.asarray(tree["v"]), (2, 1, 0)))
    out[f"{name}.weight_g"] = _tensor(np.asarray(tree["g"]).reshape(-1, 1, 1))
    out[f"{name}.bias"] = _tensor(tree["bias"])


def _channel_layer_norm(tree: dict, name: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{name}.gamma"] = _tensor(tree["LayerNorm_0"]["scale"])
    out[f"{name}.beta"] = _tensor(tree["LayerNorm_0"]["bias"])


def _text_encoder(enc: dict, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.emb.weight"] = _tensor(enc["emb"]["embedding"])
    if "pre" in enc:
        _conv(enc["pre"]["proj"], f"{prefix}.pre.proj", out)
        for i in range(3):
            _conv(enc["pre"][f"conv_{i}"], f"{prefix}.pre.conv_layers.{i}", out)
            _channel_layer_norm(enc["pre"][f"norm_{i}"], f"{prefix}.pre.norm_layers.{i}", out)
    i = 0
    while f"attn_{i}" in enc:
        attn = enc[f"attn_{i}"]
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv(attn[name], f"{prefix}.attn_layers.{i}.{name}", out)
        for rel in ("emb_rel_k", "emb_rel_v"):
            out[f"{prefix}.attn_layers.{i}.{rel}"] = _tensor(attn[rel])
        _channel_layer_norm(enc[f"norm1_{i}"], f"{prefix}.norm_layers_1.{i}", out)
        _conv(enc[f"ffn_{i}"]["conv_1"], f"{prefix}.ffn_layers.{i}.conv_1", out)
        _conv(enc[f"ffn_{i}"]["conv_2"], f"{prefix}.ffn_layers.{i}.conv_2", out)
        _channel_layer_norm(enc[f"norm2_{i}"], f"{prefix}.norm_layers_2.{i}", out)
        i += 1
    _conv(enc["proj_m"], f"{prefix}.proj_m", out)
    if "proj_s" in enc:
        _conv(enc["proj_s"], f"{prefix}.proj_s", out)
    dp = enc["proj_w"]
    _conv(dp["conv_1"], f"{prefix}.proj_w.conv_1", out)
    _channel_layer_norm(dp["norm_1"], f"{prefix}.proj_w.norm_1", out)
    _conv(dp["conv_2"], f"{prefix}.proj_w.conv_2", out)
    _channel_layer_norm(dp["norm_2"], f"{prefix}.proj_w.norm_2", out)
    _conv(dp["proj"], f"{prefix}.proj_w.proj", out)


def _flow_decoder(dec: dict, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    b = 0
    while f"actnorm_{b}" in dec:
        f = 3 * b
        out[f"{prefix}.flows.{f}.logs"] = _tensor(np.asarray(dec[f"actnorm_{b}"]["logs"]).reshape(1, -1, 1))
        out[f"{prefix}.flows.{f}.bias"] = _tensor(np.asarray(dec[f"actnorm_{b}"]["bias"]).reshape(1, -1, 1))
        out[f"{prefix}.flows.{f + 1}.weight"] = _tensor(dec[f"invconv_{b}"]["weight"])
        cpl, p = dec[f"coupling_{b}"], f"{prefix}.flows.{f + 2}"
        _wn_conv(cpl["start"], f"{p}.start", out)
        i = 0
        while f"in_{i}" in cpl["wn"]:
            _wn_conv(cpl["wn"][f"in_{i}"], f"{p}.wn.in_layers.{i}", out)
            _wn_conv(cpl["wn"][f"res_skip_{i}"], f"{p}.wn.res_skip_layers.{i}", out)
            i += 1
        _conv(cpl["end"], f"{p}.end", out)
        b += 1


def glow_tts_params_from_jax(params: dict, model_cfg: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """JAX GlowTTS params tree (numpy) -> the port's ``state_dict`` (the
    reference checkpoint's keys and layouts). ``model_cfg`` is accepted for
    symmetry with the other mappings; the tree alone decides the keys."""
    del model_cfg
    if "emb_g" in params:
        raise NotImplementedError("glow_tts_params_from_jax: multi-speaker models are not ported")
    sd: Dict[str, torch.Tensor] = {}
    _text_encoder(params["encoder"], "encoder", sd)
    _flow_decoder(params["decoder"], "decoder", sd)
    return sd


def vqtts_params_from_jax(params: dict, model_cfg: dict) -> Dict[str, torch.Tensor]:
    """JAX VQTTS params tree (numpy) -> the port's parameters by name, in the
    reference checkpoint's layout (``tools/import_torch_checkpoint.py:
    export_vqtts``, copied: the port imports nothing from ``tools/``): the
    codec at ``audio_encoder`` / ``audio_decoder``, the ``text_encoder``, the
    quant decoder's ResLayers at ``quant_decoder.model.{i}`` (flax's
    ``ResLayer_{i}``, layer 0 the largest dilation) and ``quant_proj``."""
    if "emb_g" in params:
        raise NotImplementedError("vqtts_params_from_jax: multi-speaker models are not ported")
    sd: Dict[str, torch.Tensor] = {}
    _encoder(params["audio_encoder"], "audio_encoder", model_cfg, sd)
    _decoder(params["audio_decoder"], "audio_decoder", model_cfg, sd)
    _text_encoder(params["text_encoder"], "text_encoder", sd)
    i = 0
    while f"ResLayer_{i}" in params["quant_decoder"]:
        layer = params["quant_decoder"][f"ResLayer_{i}"]
        _conv(layer["Conv_0"], f"quant_decoder.model.{i}.model.2", sd)
        _conv(layer["Conv_1"], f"quant_decoder.model.{i}.model.5", sd)
        i += 1
    _conv(params["quant_proj"], "quant_proj", sd)
    return sd


def vqtts_state_dict_from_jax(variables: dict, model_cfg: dict) -> Dict[str, torch.Tensor]:
    """JAX VQTTS ``{"params", "codebook"}`` (numpy) -> the port's ``state_dict``
    (``export_vqtts``'s keys: the parameters and ``quant_bottleneck.k``); the
    codebook's other buffers come from ``codebook_from_jax``."""
    sd = vqtts_params_from_jax(variables["params"], model_cfg)
    sd["quant_bottleneck.k"] = _tensor(variables["codebook"]["quant_bottleneck"]["k"])
    return sd
