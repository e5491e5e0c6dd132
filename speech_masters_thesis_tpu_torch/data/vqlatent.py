"""VQ-latent dataset: the pickles scripts/generate_vq_dataset.py writes
(counterpart of speech_masters_thesis_tpu/data/vqlatent.py).

Corpus contract (shared with the tokenizer and with the JAX package):
``<root>/{train,val}/*.pkl``, each ``{"x": float32 waveform, "q": list of
code ids}`` (optionally ``"speaker"``), read in sorted file order, and
``<root>/metadata.json`` with ``compression_factor`` and ``vocab_size``.
Special tokens PAD=0 / BOS=1, code ids shifted by OFFSET=2; optional
removal of consecutive duplicates; a segment crop that keeps tokens and
audio aligned (the audio window is the token window times the compression
factor); ``token_len`` / ``audio_len`` are the lengths before padding, and
segments are padded to ``segment_length + 2`` tokens and ``segment_length *
factor`` samples.
"""

from __future__ import annotations

import json
import os
import pickle
import random
from itertools import groupby
from typing import Mapping

import numpy as np

from speech_masters_thesis_tpu_torch.ops.stft import cached_mel, host_mel, mel_band_edges

PAD = 0      # <pad> token
BOS = 1      # <bos> token
OFFSET = 2   # special-token count the code vocabulary is shifted by


class VQLatent:
    """Map-style dataset over VQ-latent pickles; ``self[i]`` -> feature dict."""

    PAD = PAD
    BOS = BOS
    OFFSET = OFFSET

    def __init__(self, config: Mapping, split: str):
        d = config["dataset"]
        self.split = split
        self.dataset_path = d["dataset_path"]
        self.pkl_files = sorted(os.listdir(os.path.join(self.dataset_path, split)))
        with open(os.path.join(self.dataset_path, "metadata.json"), encoding="utf-8") as f:
            self.metadata = json.load(f)

        self.segment_length = int(d["segment_length"])
        self.remove_consecutive = bool(d["remove_consecutive"])

        assert config["model"]["vocab_size"] == self.metadata["vocab_size"], \
            "Need to specify correct model vocab size for this dataset"

        self.use_token = bool(d["use_token"])
        self.use_spect = bool(d["use_spect"])
        self.use_audio = bool(d["use_audio"])
        self.mel = cached_mel(d["sample_rate"], d["n_fft"], d["hop_length"], d.get("win_length"),
                              d["n_mels"], *mel_band_edges(d)) if self.use_spect else None

    def __len__(self) -> int:
        return len(self.pkl_files)

    def __getitem__(self, index: int) -> dict:
        with open(os.path.join(self.dataset_path, self.split, self.pkl_files[index]), "rb") as f:
            pkl = pickle.load(f)
        audio = np.asarray(pkl["x"], np.float32).reshape(-1)
        token = list(pkl["q"])
        speaker = np.asarray([pkl["speaker"]], np.int32) if "speaker" in pkl else None

        if self.remove_consecutive:
            token = [t for t, _ in groupby(token)]

        factor = int(self.metadata["compression_factor"])
        if self.segment_length > 0 and len(token) > self.segment_length:
            start = random.randint(0, len(token) - self.segment_length)
            token = token[start:start + self.segment_length]
            audio = audio[start * factor:(start + self.segment_length) * factor]

        # BOS is stored as BOS - OFFSET so the shift lands it back on BOS (the
        # reference's quirk, vqlatent.py:85-88)
        token = np.asarray([BOS - OFFSET] + token, np.int32) + OFFSET
        token_len = token.shape[-1]
        audio_len = audio.shape[-1]

        if self.segment_length > 0:
            token = np.pad(token, (0, self.segment_length + 2 - len(token)), constant_values=PAD)
            audio = np.pad(audio, (0, self.segment_length * factor - len(audio)))

        spect = spect_len = None
        if self.use_spect:
            spect = host_mel(self.mel, audio)[0]  # [frames, n_mels]
            spect_len = spect.shape[0]

        return {
            "token": token if self.use_token else None,
            "token_len": token_len if self.use_token else None,
            "spect": spect,
            "spect_len": spect_len,
            "audio": audio if self.use_audio else None,
            "audio_len": audio_len if self.use_audio else None,
            "speaker": speaker,
        }
