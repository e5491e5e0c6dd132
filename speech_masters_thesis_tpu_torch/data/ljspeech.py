"""LJSpeech dataset: metadata.csv + wavs/ -> per-utterance feature dicts
(counterpart of speech_masters_thesis_tpu/data/ljspeech.py).

The corpus contract is the reference's: ``<root>/metadata.csv`` (``name|raw|
normalized`` rows; the third column is the transcript), ``<root>/wavs/
<name>.wav``; the val split is the first 10 clips; a random segment crop
(``random.randint``, seeded by the caller) before truncation to a multiple
of ``TRUNC_MOD``; CMU-dict phoneme parsing with optional blank
interspersal, cached per index. Items are numpy dicts in NTC layout (spect
is [frames, n_mels]); the host mel runs the port's ``MelSpectrogram`` on CPU
tensors (``ops/stft.py:host_mel``), so dataset workers never touch the card.
"""

from __future__ import annotations

import os
import random
from typing import Mapping

import numpy as np

from speech_masters_thesis_tpu_torch.ops.stft import cached_mel, host_mel, mel_band_edges
from speech_masters_thesis_tpu_torch.text.parser import CMUDictParser, intersperse_blanks
from speech_masters_thesis_tpu_torch.utils.audio_io import load_wav

# Truncate audio lengths to a multiple of this so the codec's up/down-sampling
# round-trips exactly (reference ljspeech.py:14; 512 = 2 * max compression).
TRUNC_MOD = 512


class LJSpeech:
    """Map-style dataset; ``self[i]`` returns a feature dict.

    Keys: token [L] int32 | spect [frames, n_mels] float32 | audio [T] float32
    | speaker (always None). Features the dataset config elides
    (``use_token`` / ``use_spect`` / ``use_audio``, set from the model's task
    by train/harness.py) are None.
    """

    def __init__(self, config: Mapping, split: str):
        d = config["dataset"]
        self.root = d["dataset_path"]
        self.sample_rate = d["sample_rate"]
        self.intersperse_blanks = bool(d["intersperse_blanks"])
        self.segment_length = int(d["segment_length"])
        if self.segment_length > 0:
            assert self.segment_length % TRUNC_MOD == 0, (
                f"dataset.segment_length={self.segment_length} must be a "
                f"multiple of TRUNC_MOD={TRUNC_MOD}")
        self.use_token = bool(d["use_token"])
        self.use_spect = bool(d["use_spect"])
        self.use_audio = bool(d["use_audio"])

        self.audio_paths: list[str] = []
        self.transcripts: list[str] = []
        with open(os.path.join(self.root, "metadata.csv"), encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("|")
                self.audio_paths.append(os.path.join(self.root, "wavs", f"{parts[0]}.wav"))
                self.transcripts.append(parts[2])
        if split == "train":
            self.audio_paths = self.audio_paths[10:]
            self.transcripts = self.transcripts[10:]
        elif split == "val":
            self.audio_paths = self.audio_paths[:10]
            self.transcripts = self.transcripts[:10]
        else:
            raise ValueError(f"LJSpeech not implemented for split {split}")

        self.mel = cached_mel(d["sample_rate"], d["n_fft"], d["hop_length"], d.get("win_length"),
                              d["n_mels"], *mel_band_edges(d)) if self.use_spect else None
        self.parser = CMUDictParser(d["cmudict_path"]) if self.use_token else None
        self._token_cache: dict = {}

    def __len__(self) -> int:
        return len(self.audio_paths)

    def __getitem__(self, index: int) -> dict:
        audio = load_wav(self.audio_paths[index], self.sample_rate)

        # random segment crop, then truncate to TRUNC_MOD (reference :75-82)
        if self.segment_length > 0 and audio.shape[-1] > self.segment_length:
            start = random.randint(0, audio.shape[-1] - self.segment_length)
            audio = audio[start:start + self.segment_length]
        audio = audio[:len(audio) - len(audio) % TRUNC_MOD]

        spect = host_mel(self.mel, audio)[0] if self.use_spect else None  # [frames, n_mels]

        token = None
        if self.use_token:
            token = self._token_cache.get(index)
            if token is None:
                text = self.transcripts[index].strip()
                if text[-1] not in (".", "!", "?"):
                    text = text + "."
                ids = self.parser(text)
                if self.intersperse_blanks:
                    ids = intersperse_blanks(ids, len(self.parser.symbols))
                token = np.asarray(ids, dtype=np.int32)
                self._token_cache[index] = token

        return {
            "token": token,
            "spect": spect,
            "audio": np.asarray(audio, np.float32) if self.use_audio else None,
            "speaker": None,
        }
