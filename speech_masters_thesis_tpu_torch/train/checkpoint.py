"""Checkpoints: save and restore the whole TrainState with its counters
(counterpart of speech_masters_thesis_tpu/train/checkpoint.py).

One ``torch.save`` file per checkpoint in the reference's layout
(reference utils/train_utils.py:148-171): ``{config, model, optim, sched,
ema, step, epoch}``, where ``sched`` is the update count the schedule reads
and ``ema`` the EMA parameters (None without ``--ema``), plus ``codebook``:
``TrainState.codebook``, since ``k_sum``, ``k_elem`` and ``initialized`` are
not in the ``state_dict`` and a resume would otherwise restart the codebook
EMA. Files sit at ``log_dir/ckpts/ckpt.{step|last}``, the JAX package's
layout, so the LM's pointer to its codec (``vqvae.log_dir`` and
``ckpt_num``) works the same way.

Restore copies every tensor into the live state on the model's device, bit
for bit, and raises on a missing or unexpected key. The JAX package stores
its PRNG implementation and refuses a resume under another; the port has one
generator scheme (``train/loop.py:step_generators``, a pure function of the
seed and the step), so it has no such guard.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Mapping, Optional, Tuple

import torch

from speech_masters_thesis_tpu_torch.models.vqvae.bottleneck import BottleneckBlock
from speech_masters_thesis_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

KEYS = ("config", "model", "optim", "sched", "ema", "codebook", "step", "epoch")


def ckpt_dir(log_dir: str, step_or_last) -> str:
    """The checkpoint file of a step (or ``"last"``) under ``log_dir``."""
    return os.path.join(os.path.abspath(log_dir), "ckpts", f"ckpt.{step_or_last}")


def _plain(config) -> dict:
    return config.to_dict() if hasattr(config, "to_dict") else dict(config)


def save_checkpoint(config: Mapping, global_step: int, epoch: int, state: TrainState) -> str:
    """``epoch == -1`` saves as ``last`` with the run's ``total_epochs``."""
    train = config["train"]
    path = ckpt_dir(train["log_dir"], "last" if epoch == -1 else global_step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "config": _plain(config),
        "model": state.model.state_dict(),
        "optim": state.optimizer.state_dict(),
        "sched": state.step,
        "ema": state.ema_params,
        "codebook": state.codebook,
        "step": global_step,
        "epoch": train["total_epochs"] if epoch == -1 else epoch,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a crash mid-write leaves the previous file whole
    logger.info("Saved checkpoint to %s", path)
    return path


def load_payload(path: str) -> dict:
    """A checkpoint's payload on the CPU; raises when a key is missing or unknown."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if set(payload) != set(KEYS):
        raise KeyError(f"checkpoint {path}: keys {sorted(payload)}, expected {sorted(KEYS)}")
    return payload


@torch.no_grad()
def _copy_into(live: Dict[str, torch.Tensor], saved: Mapping[str, torch.Tensor], what: str) -> None:
    if set(live) != set(saved):
        raise KeyError(f"{what}: missing {sorted(set(live) - set(saved))[:5]}, "
                       f"unexpected {sorted(set(saved) - set(live))[:5]}")
    for name, tensor in live.items():
        tensor.copy_(saved[name])


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int, int]:
    """Restores ``state`` (built fresh from the config) in place; returns
    (state, step, epoch)."""
    payload = load_payload(path)
    state.model.load_state_dict(payload["model"], strict=True)
    _copy_into(state.codebook, payload["codebook"], "codebook")
    if (state.ema_params is None) != (payload["ema"] is None):
        raise ValueError(f"checkpoint {path} {'has' if payload['ema'] is not None else 'has no'} EMA "
                         f"parameters and this run {'has no' if state.ema_params is None else 'has'} --ema")
    if state.ema_params is not None:
        _copy_into(state.ema_params, payload["ema"], "ema")
    state.optimizer.load_state_dict(payload["optim"])
    state.step = int(payload["sched"])
    for module in state.model.modules():
        if isinstance(module, BottleneckBlock):
            module.init_seen = False  # read the restored ``initialized`` again
    return state, int(payload["step"]), int(payload["epoch"])


def restore_model_state(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's ``state_dict`` with its codebook buffers, on the CPU,
    for a program that only runs the model (the LM's frozen codec, the
    tokenizer)."""
    payload = load_payload(path)
    return {**payload["model"], **payload["codebook"]}


@torch.no_grad()
def load_model_state(model: torch.nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """``restore_model_state``'s tensors into ``model``: its ``state_dict``
    strictly, then the codebook's non-persistent buffers; an unknown name raises."""
    persistent = set(model.state_dict())
    model.load_state_dict({k: v for k, v in state.items() if k in persistent}, strict=True)
    for name in set(state) - persistent:
        model.get_buffer(name).copy_(state[name])


def latest_checkpoint(log_dir: str) -> Optional[str]:
    """The newest checkpoint under ``log_dir``: ``last`` after every number."""
    root = os.path.join(log_dir, "ckpts")
    if not os.path.isdir(root):
        return None
    entries = [d for d in os.listdir(root) if d.startswith("ckpt.") and not d.endswith(".tmp")]
    if not entries:
        return None

    def key(name):
        tag = name.split(".", 1)[1]
        return (1, 0) if tag == "last" else (0, int(tag))

    entries.sort(key=key)
    return os.path.join(root, entries[-1])
