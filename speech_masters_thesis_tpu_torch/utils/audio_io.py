"""WAV read and write with scipy (counterpart of
speech_masters_thesis_tpu/utils/audio_io.py).

The JAX package decodes through its native C reader when that is built and
falls back to scipy; the port keeps only the scipy path, which gives the
same floats for PCM input: integer PCM scaled by the type's full scale,
stereo averaged to mono, polyphase resampling to the target rate, then a
clip to [-1, 1].
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str, target_sr: int = 22050) -> np.ndarray:
    """A WAV file as float32 in [-1, 1], resampled to ``target_sr``."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64 WAV
        audio = data.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sr != target_sr:
        g = np.gcd(int(sr), int(target_sr))
        audio = resample_poly(audio, target_sr // g, sr // g).astype(np.float32)
    return np.clip(audio, -1.0, 1.0)


def save_wav(path: str, audio: np.ndarray, sample_rate: int = 22050) -> None:
    """Writes float audio in [-1, 1] as 16-bit PCM WAV."""
    audio = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sample_rate, (audio * 32767.0).astype(np.int16))
