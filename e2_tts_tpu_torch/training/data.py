"""Datasets, collation and prefetch (counterpart of
e2_tts_tpu/training/data.py): for the same dataset and seed the batches are
the JAX package's. Batches are padded to a multiple of ``frame_bucket``
frames; raggedness rides the length arrays; text stays a list of strings
until the trainer tokenizes it.

`HFDataset` turns rows of audio and transcript into ``(mel, text)`` items:
it skips utterances outside 0.3-20 s, resamples to the target rate on the
host (`resample_audio`) and computes the log-mel with the port's `MelSpec`
on its device. `prefetch` runs an iterator in a background thread. One
deliberate deviation from the JAX package: an exception raised by the
producer (the dataset, the collation) is raised again in the consumer,
where the JAX producer's ``finally`` swallows it and silently ends the
epoch.
"""

from __future__ import annotations

import queue
import threading
from math import gcd

import numpy as np
import torch

from e2_tts_tpu_torch import native
from e2_tts_tpu_torch.ops.mel import MelSpec
from e2_tts_tpu_torch.utils.helpers import resolve_device, round_up_to_multiple


def resample_audio(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Host-side resampling of a mono waveform: the repository's native
    polyphase resampler (`e2_tts_tpu_torch.native`) when it builds, else
    ``scipy.signal.resample_poly``; the two share one filter design."""
    if orig_sr == target_sr:
        return audio
    out = native.resample(audio, orig_sr, target_sr)
    if out is not None:
        return out
    from scipy.signal import resample_poly
    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)


def collate_fn(batch: list[dict], frame_bucket: int = 64) -> dict:
    """Pad per-item mels (``'mel_spec'``, (d, n)) to the bucketed batch
    maximum; text stays a list[str]."""
    mel_specs = [np.asarray(item['mel_spec']) for item in batch]
    mel_lengths = np.asarray([m.shape[-1] for m in mel_specs], dtype=np.int32)
    max_len = round_up_to_multiple(int(mel_lengths.max()), frame_bucket)

    d = mel_specs[0].shape[0]
    mel = np.zeros((len(batch), d, max_len), dtype=np.float32)
    for i, m in enumerate(mel_specs):
        mel[i, :, : m.shape[-1]] = m

    text = [item['text'] for item in batch]
    text_lengths = np.asarray([len(t) for t in text], dtype=np.int32)
    return dict(mel=mel, mel_lengths=mel_lengths, text=text, text_lengths=text_lengths)


MIN_SECONDS, MAX_SECONDS = 0.3, 20.0


class HFDataset:
    """Items ``dict(mel_spec=(n_mels, frames) f32 numpy, text=str)`` from
    any indexable of rows ``{'audio': {'array', 'sampling_rate'},
    'transcript'}`` (a HuggingFace ``datasets.Dataset`` or a list). A row
    outside 0.3-20 s is skipped for the next one, cyclically, as the JAX
    package does (iteratively, not recursively). The log-mel is the port's
    `MelSpec` with the JAX defaults, computed on ``device`` (CUDA unless the
    caller names another)."""

    def __init__(self, hf_dataset, target_sample_rate: int = 24_000, hop_length: int = 256,
                 device=None):
        self.data = hf_dataset
        self.target_sample_rate = target_sample_rate
        self.hop_length = hop_length
        self.device = resolve_device(device)
        self.mel_spectrogram = MelSpec(sampling_rate=target_sample_rate,
                                       hop_length=hop_length).to(self.device)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        for _ in range(len(self.data)):
            row = self.data[index]
            audio = np.asarray(row['audio']['array'], dtype=np.float32)
            sample_rate = row['audio']['sampling_rate']
            if MIN_SECONDS <= audio.shape[-1] / sample_rate <= MAX_SECONDS:
                break
            index = (index + 1) % len(self.data)
        else:
            raise RuntimeError(f'no sample with a duration in [{MIN_SECONDS}s, '
                               f'{MAX_SECONDS}s] found')
        audio = resample_audio(audio, sample_rate, self.target_sample_rate)
        with torch.no_grad():
            mel = self.mel_spectrogram(torch.from_numpy(np.ascontiguousarray(audio))
                                       .to(self.device))
        return dict(mel_spec=mel.cpu().numpy(), text=row['transcript'])


class ArrayDataset:
    """Minimal in-memory dataset of (mel (d, n), text) pairs."""

    def __init__(self, mels: list[np.ndarray], texts: list[str]):
        if len(mels) != len(texts):
            raise ValueError(f'{len(mels)} mels for {len(texts)} texts')
        self.mels = mels
        self.texts = texts

    def __len__(self):
        return len(self.mels)

    def __getitem__(self, i):
        return dict(mel_spec=self.mels[i], text=self.texts[i])


def iter_batches(dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, frame_bucket: int = 64, drop_last: bool = True):
    """Host-side batch iterator: indices shuffled per epoch by numpy's
    generator from ``seed``; an incomplete tail is dropped by default."""
    n = len(dataset)
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        idx = order[start: start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield collate_fn([dataset[int(i)] for i in idx], frame_bucket=frame_bucket)


def prefetch(iterator, size: int = 2):
    """Yield ``iterator``'s items, produced up to ``size`` ahead by a
    background thread (host-side collation and the dataset's mel overlap
    the device's step). Order is kept. An exception in the producer is
    raised here, after the items produced before it. A consumer that stops
    early stops the producer at its next item."""
    q = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()
    failure = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(item):
                    return
        except Exception as e:        # raised again in the consumer
            failure.append(e)
        put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()
