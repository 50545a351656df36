"""WAV files with the standard library (counterpart of
e2_tts_tpu/utils/audio_io.py): 16-bit PCM, mono, through `wave`."""

from __future__ import annotations

import wave

import numpy as np


def save_wav(path: str, audio: np.ndarray, sample_rate: int):
    """Write a mono float waveform in [-1, 1] as 16-bit PCM."""
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype('<i2')
    with wave.open(path, 'wb') as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a 16-bit PCM WAV into a float32 waveform in [-1, 1] (channels
    averaged) and its sample rate."""
    with wave.open(path, 'rb') as f:
        sr = f.getframerate()
        n = f.getnframes()
        data = np.frombuffer(f.readframes(n), dtype='<i2')
        if f.getnchannels() > 1:
            data = data.reshape(-1, f.getnchannels()).mean(axis=-1)
    return data.astype(np.float32) / 32767.0, sr
