"""Writes a small seeded LJSpeech-format corpus for smoke runs and tests (the
port's copy of scripts/make_synth_dataset.py, on the port's ``save_wav``).

Layout as the real corpus: ``<root>/metadata.csv``, ``<root>/wavs/*.wav``,
plus a miniature cmudict. Audio is seeded harmonic noise, enough to drive
the train, val and artifact paths without a download.

    python -m speech_masters_thesis_tpu_torch.scripts.make_synth_dataset \\
        --out ./data/LJSpeech-1.1 --cmudict ./data/cmudict.dict --n 32
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from speech_masters_thesis_tpu_torch.utils.audio_io import save_wav

WORDS = {
    "THE": "DH AH0", "QUICK": "K W IH1 K", "BROWN": "B R AW1 N",
    "FOX": "F AA1 K S", "JUMPS": "JH AH1 M P S", "OVER": "OW1 V ER0",
    "LAZY": "L EY1 Z IY0", "DOG": "D AO1 G", "HELLO": "HH AH0 L OW1",
    "WORLD": "W ER1 L D", "SPEECH": "S P IY1 CH", "MODEL": "M AA1 D AH0 L",
    "TRAINING": "T R EY1 N IH0 NG", "AUDIO": "AO1 D IY0 OW2",
}
SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "Hello world, this is speech.",
    "The model is training on audio.",
    "Speech over audio, hello dog.",
]


def make_wav(rng: np.random.RandomState, n_samples: int, sr: int = 22050) -> np.ndarray:
    t = np.arange(n_samples) / sr
    f0 = rng.uniform(80, 220)
    audio = np.zeros(n_samples, dtype=np.float64)
    for harmonic in range(1, 6):
        audio += rng.uniform(0.05, 0.3) / harmonic * np.sin(2 * np.pi * f0 * harmonic * t)
    audio += rng.normal(0, 0.01, n_samples)
    envelope = np.minimum(1.0, np.minimum(np.arange(n_samples), n_samples - np.arange(n_samples)) / (0.05 * sr))
    return (audio * envelope * 0.5).astype(np.float32)


def write_corpus(out: str, cmudict: str, n: int = 32, min_sec: float = 1.0, max_sec: float = 4.0,
                 seed: int = 0) -> None:
    os.makedirs(os.path.join(out, "wavs"), exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(cmudict)), exist_ok=True)
    rng = np.random.RandomState(seed)
    with open(os.path.join(out, "metadata.csv"), "w", encoding="utf-8") as f:
        for i in range(n):
            name = f"SYN001-{i:04d}"
            n_samples = int(rng.uniform(min_sec, max_sec) * 22050)
            save_wav(os.path.join(out, "wavs", f"{name}.wav"), make_wav(rng, n_samples))
            text = SENTENCES[i % len(SENTENCES)]
            f.write(f"{name}|{text}|{text}\n")
    with open(cmudict, "w", encoding="utf-8") as f:
        for word, phones in WORDS.items():
            f.write(f"{word}  {phones}\n")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, default="./data/LJSpeech-1.1")
    parser.add_argument("--cmudict", type=str, default="./data/cmudict.dict")
    parser.add_argument("--n", type=int, default=32)
    parser.add_argument("--min_sec", type=float, default=1.0)
    parser.add_argument("--max_sec", type=float, default=4.0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    write_corpus(args.out, args.cmudict, args.n, args.min_sec, args.max_sec, args.seed)
    print(f"Wrote {args.n} clips to {args.out} and cmudict to {args.cmudict}")


if __name__ == "__main__":
    main()
