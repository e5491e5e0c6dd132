"""Hierarchical config: attribute access, the three-source merge and the log
dir (counterpart of speech_masters_thesis_tpu/utils/config.py).

The JAX package reads and writes YAML; the machine with the card has no YAML
parser, so the port reads and writes JSON. A config source is a name in
``configs.MODELS`` / ``configs.DATASETS`` (a YAML file's stem under
``configs/``, held key for key) or the path of a ``.json`` file with the
same sections. ``setup_logdir`` writes the merged config to
``<log_dir>/config.json``, where the JAX package writes ``config.yaml``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Mapping, Optional

from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.parallel import mesh


class Config(dict):
    """A dict with attribute access (``cfg.a.b``) and deep merge.

    Nested mappings are wrapped so ``cfg.model.emb_width`` works; a missing
    key raises ``AttributeError``; ``cfg.get(key, default)`` reads an
    optional one.
    """

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        super().__init__()
        for key, value in (data or {}).items():
            self[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, _wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def merge(self, *others: Mapping[str, Any]) -> "Config":
        """A new Config with ``others`` deep-merged on top of self; later sources win."""
        out = copy.deepcopy(self)
        for other in others:
            _deep_merge(out, other)
        return out

    def to_dict(self) -> Dict[str, Any]:
        return _unwrap(self)

    def __deepcopy__(self, memo) -> "Config":
        return Config(copy.deepcopy(self.to_dict(), memo))

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2)


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def _deep_merge(dst: Config, src: Mapping[str, Any]) -> None:
    for key, value in src.items():
        if key in dst and isinstance(dst[key], Mapping) and isinstance(value, Mapping):
            _deep_merge(dst[key], value)
        else:
            dst[key] = copy.deepcopy(value)


def load_config(path: str) -> Config:
    with open(path, encoding="utf-8") as f:
        return Config(json.load(f))


def config_source(name_or_path: str, table: Mapping[str, Mapping]) -> Config:
    """A name in ``table`` or the path of a ``.json`` file."""
    if name_or_path.endswith(".json"):
        return load_config(name_or_path)
    if name_or_path not in table:
        raise KeyError(f"Unknown config '{name_or_path}': give one of {sorted(table)} or a .json path")
    return Config(table[name_or_path])


def build_config(model: str, dataset: str, train: Mapping[str, Any]) -> Config:
    """model, then dataset, then the train flags (train.py:78-111's precedence)."""
    return config_source(model, configs.MODELS).merge(config_source(dataset, configs.DATASETS),
                                                      {"train": dict(train)})


def setup_logdir(config: Config) -> None:
    """Creates ``log_dir/{ckpts,spect,audio}`` and writes ``log_dir/config.json``
    (rank 0 of a data-parallel run, which every rank then waits for)."""
    if mesh.rank() == 0:
        log_dir = config.train.log_dir
        for sub in ("ckpts", "spect", "audio"):
            os.makedirs(os.path.join(log_dir, sub), exist_ok=True)
        config.save(os.path.join(log_dir, "config.json"))
    mesh.barrier()
