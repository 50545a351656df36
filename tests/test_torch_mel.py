"""The port's mel frontend (ops/mel.py) and K11's plain version
(ops/mel_kernel.py) against the JAX package on the CPU.

The JAX side runs its own `MelSpec` in each mode, its Pallas kernel
``_mel_kernel`` in interpret mode; the oracle is torch.stft with the
reference's settings. Inputs come from numpy seeds.

Tolerances on log-mel: atol 2e-3, rtol 1e-3, as the JAX package holds its
own modes to torch.stft (tests/test_mel.py): the spectrum sums 1024
products in different orders, and the log amplifies the relative error of
quiet bins. The tables themselves are compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e2_tts_tpu.ops.mel as jmel
import e2_tts_tpu.ops.mel_kernel as jmk

from e2_tts_tpu_torch.ops import mel, mel_kernel

MEL_TOL = dict(atol=2e-3, rtol=1e-3)


def _wave(seed, *shape, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def interpret():
    saved = jmk._INTERPRET
    jmk._INTERPRET = True
    yield
    jmk._INTERPRET = saved


def _stft_oracle(wave, win=1024, power=1.0):
    """torchaudio's MelSpectrogram (centred, reflect pad, HTK, no norm) via
    torch.stft, then the natural log clamped at 1e-5."""
    window = torch.zeros(1024)
    lpad = (1024 - win) // 2
    window[lpad:lpad + win] = torch.hann_window(win)
    spec = torch.stft(torch.from_numpy(wave), n_fft=1024, hop_length=256, win_length=1024,
                      window=window, center=True, pad_mode='reflect', return_complex=True)
    spec = spec.abs() ** power
    fb = torch.from_numpy(jmel.melscale_fbanks(513, 0.0, 12000.0, 100, 24000))
    return torch.log(torch.clamp((spec.transpose(-1, -2) @ fb).transpose(-1, -2), min=1e-5)).numpy()


@pytest.mark.parametrize('mode', ['dft', 'fft', 'pallas'])
def test_melspec_matches_jax_and_stft(interpret, mode):
    wave = _wave(0, 2, 6000)
    port = mel.MelSpec(mode=mode)(torch.from_numpy(wave)).numpy()
    ref = np.asarray(jmel.MelSpec(mode=mode)(jnp.asarray(wave)))
    assert port.shape == ref.shape == (2, 100, 24)
    np.testing.assert_allclose(port, ref, **MEL_TOL)
    np.testing.assert_allclose(port, _stft_oracle(wave), **MEL_TOL)


def test_tables_are_bit_equal():
    port, ref = mel.MelSpec(win_length=800), jmel.MelSpec(win_length=800)
    np.testing.assert_array_equal(port.fbanks.numpy(), np.asarray(ref._fbanks))
    np.testing.assert_array_equal(port.dft_cos.numpy(), np.asarray(ref._dft_cos))
    np.testing.assert_array_equal(port.dft_sin.numpy(), np.asarray(ref._dft_sin))
    np.testing.assert_array_equal(mel.hann_window(1024), jmel.hann_window(1024))
    np.testing.assert_array_equal(mel.melscale_fbanks(513, 0.0, 12000.0, 80, 24000, norm='slaney'),
                                  jmel.melscale_fbanks(513, 0.0, 12000.0, 80, 24000, norm='slaney'))
    np.testing.assert_array_equal(mel.mel_to_hz(mel.hz_to_mel(np.array([50.0, 3000.0]), 'slaney'),
                                                'slaney'),
                                  jmel.mel_to_hz(jmel.hz_to_mel(np.array([50.0, 3000.0]), 'slaney'),
                                                 'slaney'))


@pytest.mark.parametrize('case', ['win800', 'power2', 'power0.7'])
def test_melspec_options(case):
    kw = {'win800': dict(win_length=800), 'power2': dict(power=2.0),
          'power0.7': dict(power=0.7)}[case]
    wave = _wave(1, 1, 5000)
    port = mel.MelSpec(mode='pallas', **kw)(torch.from_numpy(wave)).numpy()
    np.testing.assert_allclose(port, np.asarray(jmel.MelSpec(**kw)(jnp.asarray(wave))), **MEL_TOL)
    if case != 'power0.7':
        np.testing.assert_allclose(port, _stft_oracle(wave, win=kw.get('win_length', 1024),
                                                      power=kw.get('power', 1.0)), **MEL_TOL)


def test_input_layouts_and_silence():
    spec = mel.MelSpec()
    wave = torch.from_numpy(_wave(2, 3, 4096))
    out = spec(wave)
    assert out.shape == (3, 100, 17)
    torch.testing.assert_close(spec(wave[:, None, :]), out, rtol=0, atol=0)
    torch.testing.assert_close(spec(wave[1]), out[1], rtol=0, atol=0)
    silent = spec(torch.zeros(1, 2048))
    torch.testing.assert_close(silent, torch.full_like(silent, float(np.log(np.float32(1e-5)))))
    with pytest.raises(ValueError, match='more than 512'):
        spec(torch.zeros(1, 512))
    with pytest.raises(ValueError):
        mel.MelSpec(mode='cufft')


def test_fused_log_mel_plain_matches_jax_kernel(interpret):
    """300 rows (not a multiple of the TPU kernel's 256-row block) through
    ``_mel_kernel`` in interpret mode, against the plain version on both a
    materialised (rows, n_fft) frame tensor and the strided view the port
    hands the kernel."""
    spec = jmel.MelSpec()
    frames = _wave(3, 300, 1024)
    ref = np.asarray(jmk.fused_log_mel(jnp.asarray(frames), spec._dft_cos, spec._dft_sin,
                                       spec._fbanks, power=1.0))
    tables = mel.MelSpec()
    args = (tables.dft_cos, tables.dft_sin, tables.fbanks)
    port = mel_kernel.fused_log_mel(torch.from_numpy(frames), *args)
    assert port.shape == (300, 100)
    np.testing.assert_allclose(port.numpy(), ref, **MEL_TOL)

    wave = torch.from_numpy(_wave(4, 2, 76544))                # 300 frames per row
    view = mel.frame_signal(wave, 1024, 256, center=True)
    assert view.shape == (2, 300, 1024) and view.stride() == (77568, 256, 1)
    ref = np.asarray(jmk.fused_log_mel(jnp.asarray(view.reshape(600, 1024).numpy()),
                                       spec._dft_cos, spec._dft_sin, spec._fbanks, power=1.0))
    np.testing.assert_allclose(mel_kernel.fused_log_mel(view, *args).reshape(600, 100).numpy(),
                               ref, **MEL_TOL)


def test_fused_log_mel_plain_160_mels_n_fft_1000_matches_jax_kernel(interpret):
    """K11's plain version at a mel count over 128 (two mel groups on the
    card) and an n_fft that is not a multiple of 16 (a tail of 8 samples on
    the card), against ``_mel_kernel`` in interpret mode on the tables of a
    JAX `MelSpec` of that geometry."""
    kw = dict(filter_length=1000, win_length=1000, n_mel_channels=160)
    spec = jmel.MelSpec(**kw)
    tables = mel.MelSpec(**kw)
    assert tuple(tables.fbanks.shape) == (501, 160)
    np.testing.assert_array_equal(tables.fbanks.numpy(), np.asarray(spec._fbanks))
    frames = _wave(5, 90, 1000)
    ref = np.asarray(jmk.fused_log_mel(jnp.asarray(frames), spec._dft_cos, spec._dft_sin,
                                       spec._fbanks, power=1.0))
    port = mel_kernel.fused_log_mel(torch.from_numpy(frames), tables.dft_cos,
                                    tables.dft_sin, tables.fbanks)
    assert port.shape == (90, 160)
    np.testing.assert_allclose(port.numpy(), ref, **MEL_TOL)


def test_db_to_amplitude():
    x = np.linspace(-40.0, 10.0, 11).astype(np.float32)
    np.testing.assert_allclose(mel.db_to_amplitude(torch.from_numpy(x), 1.0, 0.5).numpy(),
                               np.asarray(jmel.db_to_amplitude(jnp.asarray(x), 1.0, 0.5)),
                               rtol=1e-6)
