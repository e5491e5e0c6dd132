"""Samples audio from a trained Transformer LM through its frozen VQ-VAE
(counterpart of scripts/sample_from_lm.py).

    python -m speech_masters_thesis_tpu_torch.scripts.sample_from_lm --log_dir ./logs/lm \\
        --ckpt_num last --n_samples 4 --n_steps 344 --sigma 1.0

Loads ``<log_dir>/config.json`` and ``ckpts/ckpt.<ckpt_num>`` through
``inference.LMSampler`` and draws ``--n_samples`` x ``--n_steps`` codes with
the KV-cached decode (``TransformerLM.sample``) from ``--seed`` on the card
(``--platform cpu`` for the CPU), then decodes them through the frozen
codec. One warm sample, then one timed sample, synchronized with the
device; logs tokens/s. Writes ``sample_{i}.wav``, ``tokens.txt`` (one line
of codes a sample) and ``samples_mel.npy``, the host log-mel of the first
four samples as ``train/artifacts.py`` saves its grids (the JAX script
draws a PNG), under ``--save_path`` (``<log_dir>/samples``).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

from speech_masters_thesis_tpu_torch.device import cuda_device
from speech_masters_thesis_tpu_torch.inference import LMSampler
from speech_masters_thesis_tpu_torch.ops.stft import cached_mel, host_mel, mel_band_edges
from speech_masters_thesis_tpu_torch.train.artifacts import save_mel_grid
from speech_masters_thesis_tpu_torch.utils.audio_io import save_wav

logger = logging.getLogger("sample_from_lm")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--log_dir", required=True, type=str)
    parser.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda", "gpu"],
                        help="'cpu' runs on the CPU; default: the card")
    parser.add_argument("--ckpt_num", required=True, type=str)
    parser.add_argument("--save_path", type=str, default=None)
    parser.add_argument("--n_samples", type=int, default=4)
    parser.add_argument("--n_steps", type=int, default=344, help="Codes to sample; 344 codes = 2s at 172 codes/s")
    parser.add_argument("--sigma", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    return parser.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> dict:
    """Runs the script; returns the timed sample's codes [B, n_steps], audio
    (or None), seconds and tokens/s."""
    args = parse_args(argv)
    if args.sigma <= 0:
        raise ValueError("Temperature scalar must be positive")
    device = torch.device("cpu") if args.platform == "cpu" else cuda_device()
    save_path = args.save_path or os.path.join(args.log_dir, "samples")
    os.makedirs(save_path, exist_ok=True)
    sampler = LMSampler(args.log_dir, args.ckpt_num, device=device)

    sampler.sample(args.n_samples, args.n_steps, args.sigma, args.seed)  # warm
    _sync(device)
    start = time.perf_counter()
    audio, codes = sampler.sample(args.n_samples, args.n_steps, args.sigma, args.seed)  # copied to the host
    elapsed = time.perf_counter() - start
    tokens_per_s = args.n_samples * args.n_steps / elapsed
    logger.info("Sampled %dx%d codes in %.3fs (%.1f tokens/s)", args.n_samples, args.n_steps, elapsed, tokens_per_s)

    ds = sampler.config.dataset
    with open(os.path.join(save_path, "tokens.txt"), "w", encoding="utf-8") as f:
        for row in codes:
            f.write(" ".join(str(int(t)) for t in row) + "\n")
    if audio is None:
        logger.warning("The LM has no codec: wrote the codes only")
    else:
        mel_op = cached_mel(ds.sample_rate, ds.n_fft, ds.hop_length, ds.get("win_length"), ds.n_mels,
                            *mel_band_edges(ds))
        mels = []
        for i, wav in enumerate(np.clip(audio, -1, 1)):
            save_wav(os.path.join(save_path, f"sample_{i}.wav"), wav, ds.sample_rate)
            mels.append(host_mel(mel_op, wav)[0].T)
        n = min(4, args.n_samples)
        save_mel_grid(os.path.join(save_path, "samples_mel.npy"), mels[:n], mels[:n])
    logger.info("Wrote %d samples to %s", args.n_samples, save_path)
    return {"codes": codes, "audio": audio, "seconds": elapsed, "tokens_per_s": tokens_per_s, "save_path": save_path}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
