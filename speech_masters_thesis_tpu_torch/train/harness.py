"""Model factory, initialisation and the frozen-parameter mask (counterpart of
speech_masters_thesis_tpu/train/harness.py: ``get_model``,
``init_model_variables`` and ``frozen_param_mask``).

``init_model_variables`` draws the parameters from a seed with the JAX
package's initializers: lecun-normal conv weights and zero biases, zero for
the ``zero_out`` layers (the codec, VQ-TTS's quant decoder), and flax's defaults for the LM
(truncated lecun-normal Dense kernels, zero biases, LayerNorm 1 and 0, an
N(0, 1) embedding whose PAD row is zero), and Glow-TTS's own (xavier q/k/v,
weight norm's g = ||v||, a QR rotation per InvConvNear, zeros where the JAX
package has zeros). For the VQ-VAE it then runs the bottleneck's lazy
codebook init on a first batch, so the codebook starts from real encodings.
``maybe_ddi_init`` is train.py's data-dependent init of Glow-TTS's ActNorms.
``make_train_step_for`` builds the train step from a config's ``train:``
settings (``configs.TRAIN``'s defaults), as train.py passes ``--bf16`` on.
``get_model`` builds on the card unless the caller passes a device.
``elide_features`` sets the dataset's features from the model's task,
``get_dataloaders`` builds the train and val loaders,
``load_pretrained_submodules`` grafts a trained codec into the LM and
``print_top_level_summary`` prints the parameter table, as the CLI
(``scripts/train.py``) runs them.
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.data.batching import DataLoader
from speech_masters_thesis_tpu_torch.models.base import (
    TASK_FEATURES,
    TOKEN_TO_SPECTROGRAM,
    WaveformReconstructionModel,
)
from speech_masters_thesis_tpu_torch.models.glow_tts import attention as glow_attention
from speech_masters_thesis_tpu_torch.models.glow_tts import flows as glow_flows
from speech_masters_thesis_tpu_torch.models.glow_tts.model import GlowTTS
from speech_masters_thesis_tpu_torch.models.transformer_lm.model import PAD, MultiHeadSelfAttention, load_vqvae_into_lm
from speech_masters_thesis_tpu_torch.models.vqtts.model import VQTTS
from speech_masters_thesis_tpu_torch.ops.basic import sequence_mask
from speech_masters_thesis_tpu_torch.train.checkpoint import ckpt_dir, restore_model_state
from speech_masters_thesis_tpu_torch.train.loop import make_train_step
from speech_masters_thesis_tpu_torch.utils.registry import get_model as _get_model
from speech_masters_thesis_tpu_torch.utils.registry import resolve_dataset, resolve_model

logger = logging.getLogger(__name__)

# flax's truncated_normal draws within +-2 stds and divides its std by this,
# the std of a unit normal truncated there
_TRUNCATED_STD = 0.87962566103423978


def get_model(config: Mapping, vqvae_model_config: Optional[Mapping] = None,
              device: Optional[torch.device | str] = None) -> nn.Module:
    """The model a config's ``model:`` section names in ``_import_``, built on
    ``device``: the card (``device.cuda_device()``, which raises when there is
    none) unless the caller asks for another, e.g. ``device="cpu"``.

    ``vqvae_model_config`` (or ``config["vqvae_model_config"]``) is the
    ``model:`` section of the VQ-VAE whose frozen codec an LM holds, e.g.
    ``configs.VQVAE_TPU``; given neither, it is read from the codec's log
    dir (``<model.vqvae.log_dir>/config.json``) where that file exists, as
    the JAX package reads ``config.yaml`` there. A model that reads its
    dataset's settings (Glow-TTS, VQ-TTS: ``USES_DATASET_CONFIG``) takes the
    config's ``dataset:`` section.
    """
    vq = vqvae_model_config if vqvae_model_config is not None else config.get("vqvae_model_config")
    log_dir = (config["model"].get("vqvae") or {}).get("log_dir")
    if vq is None and log_dir:
        path = os.path.join(log_dir, "config.json")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                vq = json.load(f)["model"]
        else:
            logger.warning("VQ-VAE config %s not found; reconstruction disabled", path)
    kwargs = {} if vq is None else {"vqvae_model_config": dict(vq)}
    if getattr(resolve_model(config["model"]["_import_"]), "USES_DATASET_CONFIG", False):
        kwargs["dataset_config"] = dict(config["dataset"])
    return _get_model(dict(config["model"]), device=device, **kwargs)


def make_train_step_for(config: Mapping, schedule: Callable[[int], float], ema_mu: float) -> Callable:
    """The train step of a config's ``train:`` section (``ema``,
    ``grad_clip_norm``, ``bf16``; ``configs.TRAIN`` fills what it leaves
    out), as train.py builds it from its flags."""
    train = {**configs.TRAIN, **config.get("train", {})}
    return make_train_step(schedule, ema_mu, bool(train["ema"]), train["grad_clip_norm"], bf16=bool(train["bf16"]))


def _lecun_truncated(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    std = 1.0 / math.sqrt(fan_in) / _TRUNCATED_STD
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std, generator=gen)


def _xavier_uniform(shape, gen: torch.Generator) -> torch.Tensor:
    """flax's xavier_uniform for a conv kernel: fans include the kernel width."""
    receptive = shape[2] if len(shape) == 3 else 1
    limit = math.sqrt(6.0 / (shape[1] * receptive + shape[0] * receptive))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


@torch.no_grad()
def _init_glow_tts(model: nn.Module, gen: torch.Generator) -> None:
    """The JAX package's Glow-TTS initializers: truncated lecun-normal conv
    weights and zero biases; xavier-uniform q/k/v; normal(D^-1/2) relative
    tables; normal(H^-1/2) embedding; LayerNorm 1 and 0; weight norm's
    v lecun-normal and g = ||v||; a QR rotation with det > 0 for each
    InvConvNear; zeros for ActNorm, the prenet's proj and each coupling's
    end conv."""
    xavier = {id(c) for m in model.modules() if isinstance(m, glow_attention.RelativeSelfAttention)
              for c in (m.conv_q, m.conv_k, m.conv_v)}
    for module in model.modules():
        if isinstance(module, glow_attention.RelativeSelfAttention):
            for conv in (module.conv_q, module.conv_k, module.conv_v):
                conv.weight.copy_(_xavier_uniform(conv.weight.shape, gen))
            std = module.emb_rel_k.shape[-1] ** -0.5
            module.emb_rel_k.copy_(torch.randn(module.emb_rel_k.shape, generator=gen) * std)
            module.emb_rel_v.copy_(torch.randn(module.emb_rel_v.shape, generator=gen) * std)
        elif isinstance(module, nn.Conv1d):
            if getattr(module, "zero_init", False):
                nn.init.zeros_(module.weight)
            elif id(module) not in xavier:
                w = module.weight
                module.weight.copy_(_lecun_truncated(w.shape, w.shape[1] * w.shape[2], gen))
            nn.init.zeros_(module.bias)
        elif isinstance(module, glow_flows.WNConv1d):
            v = module.weight_v
            v.copy_(_lecun_truncated(v.shape, v.shape[1] * v.shape[2], gen))
            module.weight_g.copy_(v.flatten(1).norm(dim=1).view(-1, 1, 1))
            nn.init.zeros_(module.bias)
        elif isinstance(module, glow_flows.InvConvNear):
            module.weight.copy_(glow_flows.invconv_qr_init(module.n_split, gen))
        elif isinstance(module, glow_flows.ActNorm):
            nn.init.zeros_(module.logs)
            nn.init.zeros_(module.bias)
        elif isinstance(module, glow_attention.ChannelLayerNorm):
            nn.init.ones_(module.gamma)
            nn.init.zeros_(module.beta)
        elif isinstance(module, nn.Embedding):
            module.weight.copy_(torch.randn(module.weight.shape, generator=gen) * module.weight.shape[1] ** -0.5)


@torch.no_grad()
def init_model_variables(model: nn.Module, batch: Optional[Mapping[str, torch.Tensor]], seed: int) -> None:
    """Seeded parameters for every module, then, for the VQ-VAE given a
    ``batch``, the lazy codebook init on it (on the model's device; the
    encoder runs in eval mode). Without a batch the VQ-VAE's codebook stays
    uninitialized and its first train step initializes it from that step's
    train-mode encodings and ``generators["codebook"]``, where the JAX CLI's
    first step does (``scripts/train.py``). The LM needs no batch; its frozen codec stays as drawn here
    until ``load_vqvae_into_lm`` grafts a trained one. Glow-TTS needs no
    batch here (its data-dependent ActNorm init is ``maybe_ddi_init``).
    VQ-TTS's text encoder takes Glow-TTS's initializers and the rest the
    codec's; its codebook's lazy init needs the alignment, so it runs in the
    first train step (from that step's ``generators["codebook"]``)."""
    gen = torch.Generator().manual_seed(seed)
    if isinstance(model, GlowTTS):
        _init_glow_tts(model, gen)
        return
    glow_parts = set()
    if isinstance(model, VQTTS):
        _init_glow_tts(model.text_encoder, gen)
        glow_parts = {id(m) for m in model.text_encoder.modules()}
    for module in model.modules():
        if id(module) in glow_parts:
            continue
        if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
            weight = module.weight
            if getattr(module, "zero_init", False):
                nn.init.zeros_(weight)
            else:
                std = 1.0 / math.sqrt(weight[0].numel())
                weight.copy_(torch.randn(weight.shape, generator=gen) * std)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Linear):
            module.weight.copy_(_lecun_truncated(module.weight.shape, module.in_features, gen))
            nn.init.zeros_(module.bias)
        elif isinstance(module, MultiHeadSelfAttention):  # the packed in-projection
            w = module.in_proj_weight
            w.copy_(_lecun_truncated(w.shape, w.shape[1], gen))
            nn.init.zeros_(module.in_proj_bias)
        elif isinstance(module, nn.LayerNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Embedding):
            table = torch.randn(module.weight.shape, generator=gen)
            table[PAD] = 0.0
            module.weight.copy_(table)

    if isinstance(model, WaveformReconstructionModel) and batch is not None:
        device = next(model.parameters()).device
        audio = batch["audio"].to(device)
        mask = sequence_mask(batch["audio_len"].to(device), audio.shape[-1]).to(audio.dtype)
        h, h_mask = model.encoders[0](audio[..., None], mask[..., None])
        codebook_gen = torch.Generator(device=device).manual_seed(seed + 1)
        block = model.bottleneck.level_blocks[0]
        block._maybe_init(h.reshape(-1, h.shape[-1]), h_mask.reshape(-1), codebook_gen)


def maybe_ddi_init(model: nn.Module, config: Mapping, batch: Mapping[str, torch.Tensor],
                   generators: Optional[Mapping[str, torch.Generator]] = None) -> bool:
    """train.py:195-212: when ``config["model"]["ddi"]`` is set, no checkpoint
    is loaded (``config["train"]["load_ckpt"]``) and the model has a
    ``ddi_init``, runs it on ``batch`` (on the model's device) and returns
    True; else returns False."""
    if not config["model"].get("ddi") or (config.get("train") or {}).get("load_ckpt") \
            or not hasattr(model, "ddi_init"):
        return False
    model.ddi_init(batch, generators)
    return True


def frozen_param_mask(model: nn.Module) -> Optional[Dict[str, bool]]:
    """Parameter name -> False where the model freezes it (its
    ``FROZEN_PREFIXES``); None for a model that freezes nothing."""
    prefixes = getattr(model, "FROZEN_PREFIXES", ())
    if not prefixes:
        return None
    return {name: name.split(".")[0] not in prefixes for name, _ in model.named_parameters()}


def trainable_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The parameters the optimizer gets: ``requires_grad=False`` on the
    frozen ones (which then have no gradient, so the clip by global norm
    leaves them out as ``optax.masked`` does), and the rest returned."""
    mask = frozen_param_mask(model)
    params = []
    for name, p in model.named_parameters():
        if mask is not None and not mask[name]:
            p.requires_grad_(False)
        else:
            params.append(p)
    return params


def elide_features(config: Mapping, model: nn.Module) -> None:
    """Sets the dataset's ``use_token`` / ``use_spect`` / ``use_audio`` from
    the model's task, in place (the JAX ``get_model``'s elision). With
    ``on_device_spect`` a token-to-spectrogram model gets raw audio and
    computes its mel on its own device (``models/base.py:spect_from_audio``)."""
    dataset, task = config["dataset"], type(model).TASK
    dataset.update(TASK_FEATURES[task])
    if dataset.get("on_device_spect") and dataset.get("use_spect") and task == TOKEN_TO_SPECTROGRAM:
        dataset["use_spect"] = False
        dataset["use_audio"] = True


def get_dataloaders(config: Mapping, shuffle: bool = True,
                    collate_kwargs: Optional[dict] = None) -> Tuple[DataLoader, DataLoader]:
    """Train and val loaders: train shuffled from ``train.seed`` (unless
    ``shuffle`` is False) and wrap-padded; val in order with its partial
    batch (``pad_last=False``), so the epoch's averages count each clip
    once. ``collate_kwargs`` (bucket sizes) go to both loaders' collate."""
    train = config["train"]
    num_workers = int(train.get("num_workers", 0) or 0)
    dataset_cls = resolve_dataset(config["dataset"]["_import_"])
    train_loader = DataLoader(dataset_cls(config, split="train"), batch_size=train["batch_size"], shuffle=shuffle,
                              seed=train["seed"], num_workers=num_workers, collate_kwargs=collate_kwargs)
    val_loader = DataLoader(dataset_cls(config, split="val"), batch_size=train["batch_size"], shuffle=False,
                            pad_last=False, num_workers=num_workers, collate_kwargs=collate_kwargs)
    return train_loader, val_loader


def load_pretrained_submodules(model: nn.Module, config: Mapping) -> None:
    """Grafts the trained codec an LM points at (``model.vqvae.log_dir`` and
    ``ckpt_num``: ``ckpt.<ckpt_num>`` there) into its frozen decoder and
    codebook through ``load_vqvae_into_lm``; a model without a frozen codec
    is left as it is."""
    if not getattr(model, "FROZEN_PREFIXES", ()) or getattr(model, "vqvae_decoder", None) is None:
        return
    vq = config["model"]["vqvae"]
    load_vqvae_into_lm(model, restore_model_state(ckpt_dir(vq["log_dir"], vq["ckpt_num"])))
    logger.info("Loaded frozen VQ-VAE from %s (ckpt %s)", vq["log_dir"], vq["ckpt_num"])


def print_top_level_summary(model: nn.Module) -> None:
    """Parameter count of each top-level submodule, then the totals."""
    rows = [(name, sum(p.numel() for p in child.parameters())) for name, child in model.named_children()]
    total = sum(p.numel() for p in model.parameters())
    buffers = sum(b.numel() for b in model.buffers())
    width = max([len(r[0]) for r in rows] + [10])
    lines = [f"{'Name':<{width}}  Params"]
    lines += [f"{name:<{width}}  {n:,}" for name, n in rows]
    lines += [f"{'TOTAL':<{width}}  {total:,} params, {buffers:,} buffer elements"]
    print("\n".join(lines))
