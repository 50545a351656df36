"""Which design K8 / K9 run, on the CPU: `bhnd_design` maps the dtype and
the (padded) head width to the Hopper design (flash_attention_sm90.cuh:
bf16, heads up to 128) or the wmma templates (flash_attention.cuh: f32,
heads of 136-256), and the wrappers hand that choice to the C entry points.
The library is replaced by a recorder, so no kernel runs here: the card
tests (tests/test_torch_cuda.py) hold both designs against the plain
versions."""

import pytest
import torch

from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.ops import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize('dtype,dh,design', [
    (BF16, 8, 'sm90'), (BF16, 16, 'sm90'), (BF16, 64, 'sm90'), (BF16, 72, 'sm90'),
    (BF16, 120, 'sm90'), (BF16, 128, 'sm90'), (BF16, 136, 'wmma'), (BF16, 256, 'wmma'),
    (F32, 16, 'wmma'), (F32, 72, 'wmma'), (F32, 128, 'wmma'), (F32, 256, 'wmma')])
def test_bhnd_design(dtype, dh, design):
    assert fa.bhnd_design(dtype, dh) == design


class _Recorder:
    """Stands in for the kernel library: records each entry point's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_cuda, 'lib', lambda: rec)
    monkeypatch.setattr(_cuda, 'stream_ptr', lambda device: 0)
    return rec


def _views(b, h, n, dh, dtype):
    """(b, h, n, dh) views of one packed (b, n, 3 h dh) projection."""
    qkv = torch.zeros(b, n, 3 * h * dh, dtype=dtype)
    to = lambda t: t.unflatten(-1, (h, dh)).transpose(1, 2)
    return tuple(to(qkv[..., i * h * dh:(i + 1) * h * dh]) for i in range(3))


@pytest.mark.parametrize('dtype,dh,run_dh,design', [
    (BF16, 72, 72, 'sm90'), (BF16, 12, 16, 'sm90'), (BF16, 128, 128, 'sm90'),
    (BF16, 256, 256, 'wmma'), (F32, 72, 72, 'wmma'), (F32, 12, 16, 'wmma')])
def test_wrappers_pass_the_design(recorder, dtype, dh, run_dh, design):
    """K8 and K9's wrappers launch the design `bhnd_design` names for the
    head they run (a head of 12 is zero-padded to 16 first), with the head
    width, dtype code and design code in the entry points' last arguments."""
    b, h, n = 2, 3, 40
    q, k, v = _views(b, h, n, dh, dtype)
    out, lse = fa._flash_bhnd_cuda(q, k, v, None, dh ** -0.5, 50.0, 0.1, 7)
    assert out.shape == (b, h, n, dh) and lse.shape == (b * h, n)
    dq, dk, dv = fa._flash_bwd_bhnd_cuda(q, k, v, None, out, lse, torch.zeros_like(out),
                                         dh ** -0.5, 50.0, 0.1, 7)
    assert dq.shape == dk.shape == dv.shape == (b, h, n, dh) and dq.dtype == dtype
    (fwd, fargs), (bwd, bargs) = recorder.calls
    assert (fwd, bwd) == ('e2_flash_fwd_bhnd', 'e2_flash_bwd_bhnd')
    code = fa.BHND_DESIGNS[design]
    for args in (fargs, bargs):
        assert args[-3:-1] == (_cuda.DTYPE_CODES[dtype], code)
        assert run_dh in args       # the head width the kernel runs
    assert len(fargs) == len(_cuda._SIGNATURES['e2_flash_fwd_bhnd'])
    assert len(bargs) == len(_cuda._SIGNATURES['e2_flash_bwd_bhnd'])


def test_design_codes_match_the_entry_points():
    """The codes of csrc/flash_attention_bhnd.cu's `design` argument, which
    takes exactly the pairing `bhnd_design` makes."""
    assert fa.BHND_DESIGNS == {'wmma': 0, 'sm90': 1}
    src = (_cuda.CSRC / 'flash_attention_bhnd.cu').read_text()
    assert 'design == (dtype == e2::kBFloat16 && dh <= 128 ? 1 : 0)' in src
