"""Datasets and collation in plain numpy (counterpart of
e2_tts_tpu/training/data.py): for the same dataset and seed the batches are
the JAX package's. Batches are padded to a multiple of ``frame_bucket``
frames; raggedness rides the length arrays; text stays a list of strings
until the trainer tokenizes it.

Not ported yet: ``HFDataset`` (it needs the mel frontend) and ``prefetch``.
"""

from __future__ import annotations

import numpy as np

from e2_tts_tpu_torch.utils.helpers import round_up_to_multiple


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
