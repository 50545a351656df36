"""Spectrogram figures for TensorBoard (counterpart of
e2_tts_tpu/utils/plotting.py)."""

from __future__ import annotations

import numpy as np


def plot_spectrogram(spectrogram):
    """A mel ``(n, d)`` -> a matplotlib figure, frames on x and channels on
    y. Needs matplotlib, imported here."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    spectrogram = np.asarray(spectrogram)
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(spectrogram.T, aspect='auto', origin='lower', interpolation='none')
    plt.colorbar(im, ax=ax)
    plt.xlabel('Frames')
    plt.ylabel('Channels')
    plt.tight_layout()
    fig.canvas.draw()
    plt.close()
    return fig
