"""Tokenizes a corpus into VQ latents with a trained VQ-VAE (counterpart of
scripts/generate_vq_dataset.py).

    python -m speech_masters_thesis_tpu_torch.scripts.generate_vq_dataset \\
        --log_dir ./logs/vqvae --ckpt_num last --save_path ./data/VQ-Latent

Loads ``<log_dir>/config.json`` and ``ckpts/ckpt.<ckpt_num>``, reads whole
clips (``segment_length = -1``) through the train loader unshuffled and the
val loader, audio bucketed at ``--bucket_multiple`` samples, encodes each
batch on the card (``--platform cpu`` for the CPU) and writes one pickle an
utterance, ``{split}/{split}_{idx:06d}.pkl`` = ``{"x": float32 waveform[:n],
"q": list of codes[:n // compression_factor]}``, and ``metadata.json`` =
``{"compression_factor", "vocab_size"}``: the files the JAX script writes,
which both packages' ``VQLatent`` read. ``--sanity`` (on by default, as in
the JAX script; ``--no-sanity`` turns it off) also writes ``sanity.wav``,
the first batch's first clip decoded from its codes, and
``token_histogram.npy``, each code's count (the JAX script draws a PNG).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
from collections import Counter
from typing import List, Optional

import numpy as np
import torch

from speech_masters_thesis_tpu_torch.device import cuda_device
from speech_masters_thesis_tpu_torch.models.vqvae.model import VQVAE, compression_factor
from speech_masters_thesis_tpu_torch.ops.basic import sequence_mask
from speech_masters_thesis_tpu_torch.train.checkpoint import ckpt_dir, load_model_state, restore_model_state
from speech_masters_thesis_tpu_torch.train.harness import elide_features, get_dataloaders, get_model
from speech_masters_thesis_tpu_torch.utils.audio_io import save_wav
from speech_masters_thesis_tpu_torch.utils.config import load_config

logger = logging.getLogger("generate_vq_dataset")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--log_dir", required=True, type=str)
    parser.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda", "gpu"],
                        help="'cpu' runs on the CPU; default: the card")
    parser.add_argument("--ckpt_num", required=True, type=str)
    parser.add_argument("--save_path", required=True, type=str)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--bucket_multiple", type=int, default=65536,
                        help="Audio length bucket: larger = fewer distinct batch shapes")
    parser.add_argument("--sanity", default=True, action=argparse.BooleanOptionalAction,
                        help="Write a round-trip decoded sanity wav and the token histogram (--no-sanity: neither)")
    return parser.parse_args(argv)


@torch.no_grad()
def main(argv: Optional[List[str]] = None) -> dict:
    """Runs the tokenizer; returns metadata.json's dict."""
    args = parse_args(argv)
    device = torch.device("cpu") if args.platform == "cpu" else cuda_device()
    config = load_config(os.path.join(args.log_dir, "config.json"))
    config.dataset.segment_length = -1  # full clips
    config.train.batch_size = args.batch_size

    model = get_model(config, device=device)
    if not isinstance(model, VQVAE):
        raise ValueError("generate_vq_dataset expects a VQVAE checkpoint")
    elide_features(config, model)
    load_model_state(model, restore_model_state(ckpt_dir(args.log_dir, args.ckpt_num)))
    model.eval()
    factor = compression_factor(config.model)

    train_loader, val_loader = get_dataloaders(config, shuffle=False,
                                               collate_kwargs={"audio_multiple": args.bucket_multiple})

    os.makedirs(args.save_path, exist_ok=True)
    token_counts: Counter = Counter()
    sanity_done = False
    for split, loader in (("train", train_loader), ("val", val_loader)):
        out_dir = os.path.join(args.save_path, split)
        os.makedirs(out_dir, exist_ok=True)
        idx = 0
        for batch in loader:
            audio, audio_len = batch["audio"], batch["audio_len"]
            x = torch.from_numpy(audio).to(device)
            mask = sequence_mask(torch.from_numpy(audio_len).to(device), x.shape[-1]).to(x.dtype)
            codes_t, _ = model.encode(x, mask)
            codes = codes_t.cpu().numpy()
            for b in range(audio.shape[0]):
                n = int(audio_len[b])
                q = codes[b, :n // factor].astype(np.int64).tolist()
                token_counts.update(q)
                with open(os.path.join(out_dir, f"{split}_{idx:06d}.pkl"), "wb") as f:
                    pickle.dump({"x": np.asarray(audio[b, :n], np.float32), "q": q}, f)
                idx += 1
            if args.sanity and not sanity_done:
                recon = model.decode(codes_t)[0].float().cpu().numpy()
                save_wav(os.path.join(args.save_path, "sanity.wav"), recon, config.dataset.sample_rate)
                sanity_done = True
        logger.info("Wrote %d %s pickles", idx, split)

    metadata = {"compression_factor": factor, "vocab_size": int(config.model.l_bins)}
    with open(os.path.join(args.save_path, "metadata.json"), "w", encoding="utf-8") as f:
        json.dump(metadata, f)
    logger.info("metadata.json: %s", metadata)
    logger.info("Distinct tokens used: %d / %d", len(token_counts), config.model.l_bins)
    if args.sanity:
        counts = np.zeros(config.model.l_bins, np.int64)
        for tok, c in token_counts.items():
            counts[tok] = c
        np.save(os.path.join(args.save_path, "token_histogram.npy"), counts)
    return metadata


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
