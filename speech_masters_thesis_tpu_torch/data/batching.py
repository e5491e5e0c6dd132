"""Collate and DataLoader (counterpart of
speech_masters_thesis_tpu/data/batching.py, copied: it is pure numpy),
without its shards: one process reads the whole corpus until data
parallelism (ROADMAP.md A.4) gives them a caller.

  * **Bucketed widths.** Each feature is padded up to a multiple of a
    bucket size (audio 4096 samples, mel 16 frames, tokens 32 ids), so a
    run sees a handful of shapes; the true lengths travel as ``*_len``.
  * **Wrap-padding** (``pad_last=True``): the final short batch is filled by
    wrapping to the epoch head, so the batch axis stays fixed. Validation
    keeps its partial batch (``pad_last=False``, train/harness.py).
  * **Thread prefetch** (``num_workers``): WAV decode and host mel for the
    next batches run while the card works on the current one.
  * **Per-epoch reshuffling** from ``seed + epoch``, where ``epoch`` counts
    this loader's passes, so a resumed run restarts at ``seed + 0``.

Batches stay numpy on the host; the epoch loop moves them to the model's
device. Pad values match the reference: zeros for audio and tokens,
log(1e-7) for mel frames.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, Iterator, List, Optional

import numpy as np

MEL_PAD = math.log(1e-7)

_FEATURES = ("token", "spect", "audio")
_PADS = {"token": 0, "spect": MEL_PAD, "audio": 0.0}


def _bucket(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def collate(
    items: List[dict],
    token_multiple: int = 32,
    audio_multiple: int = 4096,
    spect_multiple: int = 16,
) -> Dict[str, Optional[np.ndarray]]:
    """Items (feature dicts) -> one batch dict with bucketed static shapes.

    Emits the canonical 7-key batch (models/base.py): token, token_len,
    spect, spect_len, audio, audio_len, speaker; elided features are None.
    Per-item ``*_len`` overrides (VQLatent's pre-padding lengths) win over
    the raw array lengths.
    """
    multiples = {"token": token_multiple, "spect": spect_multiple, "audio": audio_multiple}
    batch: Dict[str, Optional[np.ndarray]] = {}

    for key in _FEATURES:
        first = items[0].get(key)
        if first is None:
            batch[key] = None
            batch[f"{key}_len"] = None
            continue
        arrays = [np.asarray(item[key]) for item in items]
        lens = [int(item.get(f"{key}_len") or a.shape[0]) for item, a in zip(items, arrays)]
        width = _bucket(max(a.shape[0] for a in arrays), multiples[key])
        padded = []
        for a in arrays:
            pad = [(0, width - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            padded.append(np.pad(a, pad, constant_values=_PADS[key]))
        batch[key] = np.stack(padded, axis=0)
        batch[f"{key}_len"] = np.asarray(lens, np.int32)

    speakers = [item.get("speaker") for item in items]
    batch["speaker"] = np.stack(speakers, axis=0) if speakers[0] is not None else None
    return batch


class DataLoader:
    """Iterable over collated batches with per-epoch reshuffling.

    Replaces torch.utils.data.DataLoader (reference utils/commons.py:84-93)
    on one process; ``collate_kwargs`` go to ``collate`` (the tokenizer
    widens its audio buckets for full clips).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        pad_last: bool = True,
        num_workers: int = 0,
        collate_kwargs: Optional[dict] = None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.pad_last = bool(pad_last)
        self.num_workers = int(num_workers)
        self.collate_kwargs = dict(collate_kwargs or {})
        self.epoch = 0

    # -- index plumbing -----------------------------------------------------
    def _epoch_batches(self) -> List[np.ndarray]:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            indices = indices[rng.permutation(len(indices))]
        n = len(indices)
        batches = []
        for start in range(0, n, self.batch_size):
            chunk = indices[start:start + self.batch_size]
            if len(chunk) < self.batch_size and self.pad_last and n >= 1:
                # wrap to the epoch head so the batch axis stays static
                fill = np.resize(indices, self.batch_size - len(chunk))
                chunk = np.concatenate([chunk, fill])
            batches.append(chunk)
        return batches

    def _make_batch(self, idxs: np.ndarray) -> dict:
        return collate([self.dataset[int(i)] for i in idxs], **self.collate_kwargs)

    # -- iteration ----------------------------------------------------------
    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        batches = self._epoch_batches()
        self.epoch += 1
        if self.num_workers <= 0:
            for idxs in batches:
                yield self._make_batch(idxs)
            return

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: deque = deque()
            it = iter(batches)
            # keep a bounded window in flight so memory stays flat
            for _ in range(self.num_workers + 2):
                idxs = next(it, None)
                if idxs is None:
                    break
                pending.append(pool.submit(self._make_batch, idxs))
            while pending:
                done = pending.popleft()
                idxs = next(it, None)
                if idxs is not None:
                    pending.append(pool.submit(self._make_batch, idxs))
                yield done.result()
