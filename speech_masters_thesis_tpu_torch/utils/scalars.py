"""Scalar log in place of TensorBoard: one JSON line a value.

``ScalarWriter(log_dir).add_scalar(tag, value, step)`` appends
``{"step", "tag", "value"}`` to ``<log_dir>/scalars.jsonl`` under the JAX
CLI's TensorBoard tags (``loss/train_*``, ``metrics/train_*``,
``loss/val_*``, ``metrics/val_*``). ``read_scalars`` reads the file back.
"""

from __future__ import annotations

import json
import os
from typing import List


class ScalarWriter:
    def __init__(self, log_dir: str):
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._file = open(self.path, "a", encoding="utf-8")  # pylint: disable=consider-using-with

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._file.write(json.dumps({"step": int(step), "tag": tag, "value": float(value)}) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def read_scalars(log_dir: str) -> List[dict]:
    with open(os.path.join(log_dir, "scalars.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]
