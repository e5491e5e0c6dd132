"""Text -> speech from a trained Glow-TTS log dir (counterpart of
scripts/synthesize.py).

    python -m speech_masters_thesis_tpu_torch.scripts.synthesize --log_dir ./logs/glow_tts \\
        --ckpt_num last --text "Hello world." --out ./sample.wav

Loads ``<log_dir>/config.json`` and ``ckpts/ckpt.<ckpt_num>`` through
``inference.GlowTTSSynthesizer`` (the flow cache built once after the load,
unless ``--flow_cache 0``), parses the text with the dataset's CMUdict, and
runs text -> durations -> reverse flow -> mel on the card (``--platform cpu``
for the CPU). ``--vocoder device`` (the default) silences each mel's padded
tail and inverts it by Griffin-Lim on the same device
(``ops/griffin_lim.py``, ``--gl_iters`` iterations); ``--vocoder host``
inverts the mel on the host (``train/artifacts.py:mel_to_audio``). One warm
call, then one timed call, synchronized with the device; logs the frames,
the seconds of audio and the RTF (seconds of synthesis per second of audio)
as the JAX script does, and writes a 16-bit WAV (``<log_dir>/synthesis.wav``
unless ``--out``). The latent noise and the initial phase come from
``--seed`` on the model's device.
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
from speech_masters_thesis_tpu_torch.inference import GlowTTSSynthesizer
from speech_masters_thesis_tpu_torch.train.artifacts import mel_to_audio
from speech_masters_thesis_tpu_torch.utils.audio_io import save_wav

logger = logging.getLogger("synthesize")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--log_dir", required=True, type=str)
    parser.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda", "gpu"],
                        help="'cpu' runs on the CPU; default: the card")
    parser.add_argument("--ckpt_num", required=True, type=str)
    parser.add_argument("--text", type=str, default="The quick brown fox jumps over the lazy dog.")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--max_frames", type=int, default=1024)
    parser.add_argument("--noise_scale", type=float, default=0.667)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--vocoder", type=str, default="device", choices=["device", "host"],
                        help="'device': Griffin-Lim on the model's device (ops/griffin_lim.py); "
                             "'host': the artifact path on the host")
    parser.add_argument("--gl_iters", type=int, default=32)
    parser.add_argument("--flow_cache", type=int, default=1,
                        help="1 (default): fold weight norm and store the flows' inverses once; 0: per call")
    return parser.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def main(argv: Optional[List[str]] = None) -> dict:
    """Runs the script; returns the timed call's frames, audio seconds,
    seconds, RTF, mel [frames, n_mels], waveform and the WAV's path."""
    args = parse_args(argv)
    device = torch.device("cpu") if args.platform == "cpu" else cuda_device()
    synth = GlowTTSSynthesizer(args.log_dir, args.ckpt_num, max_frames=args.max_frames,
                               flow_cache=bool(args.flow_cache), gl_iters=args.gl_iters, device=device)
    ids = torch.from_numpy(synth.encode_text(args.text).astype(np.int64))[None]
    ds = synth.config.dataset
    device_vocoder = args.vocoder == "device"

    def infer():
        generator = torch.Generator(device=device).manual_seed(args.seed)
        if device_vocoder:
            return synth.synthesize_ids(ids, generator, args.noise_scale)
        mel, z_lengths = synth.synthesize_mel(ids, generator, args.noise_scale)
        return mel, None, z_lengths

    infer()  # warm: first-use constants and the kernels' library
    _sync(device)
    start = time.perf_counter()
    mel, audio_dev, z_lengths = infer()
    n_frames = int(z_lengths[0])  # a host read: waits for the device
    _sync(device)
    elapsed = time.perf_counter() - start
    mel_np = mel[0, :n_frames].float().cpu().numpy()
    audio_seconds = n_frames * ds.hop_length / ds.sample_rate
    rtf = elapsed / max(audio_seconds, 1e-6)
    if device_vocoder:
        audio = audio_dev[0, :n_frames * ds.hop_length].float().cpu().numpy()
        logger.info("text->waveform on %s: %d frames (%.2fs audio) in %.4fs, end-to-end RTF %.4f",
                    device.type, n_frames, audio_seconds, elapsed, rtf)
    else:
        logger.info("Synthesized %d mel frames (%.2fs of audio) in %.4fs, mel RTF %.4f",
                    n_frames, audio_seconds, elapsed, rtf)
        start = time.perf_counter()
        audio = mel_to_audio(mel_np, synth.config)
        gl_elapsed = time.perf_counter() - start
        logger.info("Griffin-Lim inversion: %.2fs (RTF %.3f, host-side artifact path)",
                    gl_elapsed, gl_elapsed / max(audio_seconds, 1e-6))

    out = args.out or os.path.join(args.log_dir, "synthesis.wav")
    save_wav(out, np.clip(audio, -1, 1), ds.sample_rate)
    logger.info("Wrote %s", out)
    return {"frames": n_frames, "audio_s": audio_seconds, "seconds": elapsed, "rtf": rtf, "mel": mel_np,
            "audio": audio, "out": out}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
