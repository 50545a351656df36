"""Which design the flash-attention kernels run, on the CPU. The C entry
points choose it: K8 / K9's (flash_attention_bhnd.cu) from the dtype and
the (padded) head width, the Hopper design (flash_attention_sm90.cuh) for
bf16 heads up to 128 and the wmma templates (flash_attention.cuh) for f32
and heads of 136-256; K1 / K2's (flash_attention.cu, flash_attention_bwd.cu)
from the dtype alone. The wrappers pass no design. A gated K2 reads K10's
do_g, not the output grad itself. The library is replaced by a recorder,
so no kernel runs here: the card tests (tests/test_torch_cuda.py) hold
both designs against the plain versions."""

import re

import pytest
import torch

from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.ops import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32


def _entry_point(source: str, name: str) -> str:
    src = (_cuda.CSRC / source).read_text()
    start = src.index(f'extern "C" int {name}(')
    return src[start:src.index('\n}\n', start)]


def _bhnd_design(entry: str, dtype, dh: int) -> str:
    """The design a K8 / K9 entry point launches for ``dtype`` and a head of
    ``dh`` columns, read off its ``if (...) return ...`` dispatch lines in
    their order: the wide (wmma) build, the sm90 dispatch or the f32 (wmma)
    one."""
    env = {'dh': dh, 'dtype': _cuda.DTYPE_CODES[dtype]}
    codes = {'e2::kBFloat16': str(_cuda.DTYPE_CODES[BF16]),
             'e2::kFloat32': str(_cuda.DTYPE_CODES[F32])}
    for cond, target in re.findall(r'\n  if \((.*)\) return (.*);', entry):
        for name, code in codes.items():
            cond = cond.replace(name, code)
        if not re.fullmatch(r'[\w\s<>=!]+', cond):
            continue                       # the argument checks
        if eval(cond, {}, env):
            if 'sm90' in target:
                return 'sm90'
            assert 'wide' in target or 'f32' in target, target
            return 'wmma'
    raise AssertionError(f'no design for {dtype} at dh {dh}')


@pytest.mark.parametrize('dtype,dh,design', [
    (BF16, 8, 'sm90'), (BF16, 16, 'sm90'), (BF16, 64, 'sm90'), (BF16, 72, 'sm90'),
    (BF16, 120, 'sm90'), (BF16, 128, 'sm90'), (BF16, 136, 'wmma'), (BF16, 256, 'wmma'),
    (F32, 16, 'wmma'), (F32, 72, 'wmma'), (F32, 128, 'wmma'), (F32, 256, 'wmma')])
def test_bhnd_design(dtype, dh, design):
    """K8 and K9's entry points launch the Hopper design for bf16 heads up to
    128 and the wmma templates for f32 and for heads wider than 128."""
    for name in ('e2_flash_fwd_bhnd', 'e2_flash_bwd_bhnd'):
        assert _bhnd_design(_entry_point('flash_attention_bhnd.cu', name), dtype, dh) == design


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
    """K8 and K9's wrappers hand the entry points the head width they run (a
    head of 12 is zero-padded to 16 first) and the dtype code, and no design
    argument: the entry points choose it, as `design` for that head."""
    b, h, n = 2, 3, 40
    q, k, v = _views(b, h, n, dh, dtype)
    out, lse = fa._flash_bhnd_cuda(q, k, v, None, dh ** -0.5, 50.0, 0.1, 7)
    assert out.shape == (b, h, n, dh) and lse.shape == (b * h, n)
    dq, dk, dv = fa._flash_bwd_bhnd_cuda(q, k, v, None, out, lse, torch.zeros_like(out),
                                         dh ** -0.5, 50.0, 0.1, 7)
    assert dq.shape == dk.shape == dv.shape == (b, h, n, dh) and dq.dtype == dtype
    (fwd, fargs), (bwd, bargs) = recorder.calls
    assert (fwd, bwd) == ('e2_flash_fwd_bhnd', 'e2_flash_bwd_bhnd')
    for args in (fargs, bargs):
        assert args[-2:] == (_cuda.DTYPE_CODES[dtype], 0)    # dtype code, stream
        assert run_dh in args       # the head width the kernel runs
    for name in (fwd, bwd):
        assert _bhnd_design(_entry_point('flash_attention_bhnd.cu', name), dtype,
                            run_dh) == design
    assert len(fargs) == len(_cuda._SIGNATURES['e2_flash_fwd_bhnd'])
    assert len(bargs) == len(_cuda._SIGNATURES['e2_flash_bwd_bhnd'])


def test_design_codes_match_the_entry_points():
    """No entry point takes a design argument. K1 and K2's choose by the
    dtype: bf16 on the Hopper design at dim_head 32, 64 and 128, f32 on the
    wmma templates, which have no bf16 instantiation left there."""
    for source, names in (('flash_attention.cu', ('e2_flash_fwd',)),
                          ('flash_attention_bwd.cu', ('e2_flash_bwd',)),
                          ('flash_attention_bhnd.cu', ('e2_flash_fwd_bhnd',
                                                       'e2_flash_bwd_bhnd'))):
        for name in names:
            assert 'design' not in _entry_point(source, name).split(')')[0]
    for source, kind in (('flash_attention.cu', 'fwd'), ('flash_attention_bwd.cu', 'bwd')):
        src = (_cuda.CSRC / source).read_text()
        assert (f'return bf16 ? sm90::launch_{kind}<DH>(p, stream) : '
                f'launch_{kind}<float, DH>(p, stream);') in src
        assert f'launch_{kind}<__nv_bfloat16' not in src
        assert ('dispatch_dh(p, dtype == e2::kBFloat16, '
                'static_cast<cudaStream_t>(stream))') in _entry_point(source, f'e2_flash_{kind}')
        for dh in (32, 64, 128):
            assert f'case {dh}: return launch<{dh}>(p, bf16, stream);' in src


@pytest.mark.parametrize('gated', [False, True])
@pytest.mark.parametrize('dh', [32, 64, 128])
@pytest.mark.parametrize('dtype', [BF16, F32])
def test_packed_wrappers_pass_the_gate_and_do_g(recorder, dtype, dh, gated):
    """K1 and K2's wrappers hand the entry points the dtype code and no design
    argument at every head they take; K1 receives the gate logits; K10
    receives them with a do_g buffer, and a gated K2 reads that do_g as its
    output grad (an ungated one the output grad itself)."""
    b, h, n = 2, 3, 40
    D = h * dh
    q, k, v = torch.zeros(b, n, 3 * D, dtype=dtype).split(D, dim=-1)
    gate = torch.zeros(b, n, h, dtype=dtype) if gated else None
    out, lse = fa._flash_cuda(q, k, v, None, h, dh ** -0.5, 50.0, 0.1, 7, gate)
    dout = torch.zeros(b, n, D, dtype=dtype)
    dq, dk, dv, dgate = fa._flash_bwd_cuda(q, k, v, None, out, lse, dout, h, dh ** -0.5, 50.0,
                                           0.1, 7, gate)
    assert dq.shape == dk.shape == dv.shape == (b, n, D) and dq.dtype == dtype
    assert (dgate is None) == (not gated)
    (fwd, fargs), (delta, dargs), (bwd, bargs) = recorder.calls
    assert (fwd, delta, bwd) == ('e2_flash_fwd', 'e2_flash_delta', 'e2_flash_bwd')
    for name, args in ((fwd, fargs), (delta, dargs), (bwd, bargs)):
        assert len(args) == len(_cuda._SIGNATURES[name])
    for args in (fargs, bargs):
        assert args[-2:] == (_cuda.DTYPE_CODES[dtype], 0)    # dtype code, stream
    assert fargs[16] == bargs[19] == dargs[7] == dh              # dim_head
    assert fargs[10] == (gate.data_ptr() if gated else None)    # K1's gate
    assert dargs[2] == (gate.data_ptr() if gated else None)     # K10's gate
    do_g = dargs[3]
    if gated:
        assert do_g is not None and do_g != dout.data_ptr()
        assert bargs[9] == do_g                                 # K2's do: K10's do_g
    else:
        assert do_g is None and bargs[9] == dout.data_ptr()


def _n_short() -> int:
    src = (_cuda.CSRC / 'flash_attention_short.cuh').read_text()
    found = re.findall(r'constexpr int N_SHORT = (\d+);', src)
    assert len(found) == 1
    return int(found[0])


@pytest.mark.parametrize('source,kind', [('flash_attention.cu', 'fwd'),
                                         ('flash_attention_bwd.cu', 'bwd')])
def test_packed_entry_points_branch_on_the_length(source, kind):
    """K1 and K2's entry points take one rule between their two designs: a
    sequence of at most N_SHORT tokens (8 to 64: the measured crossover)
    launches the few-token kernels, bf16 or f32, before the dtype's tiled
    dispatch; nothing else (an argument, an environment variable) picks a
    design."""
    entry = _entry_point(source, f'e2_flash_{kind}')
    short = entry.index('if (n <= short_seq::N_SHORT)')
    assert entry.index(f'return (int)short_seq::launch_{kind}(p, dtype == e2::kBFloat16,') > short
    assert entry.index('return (int)dispatch_dh(p, dtype == e2::kBFloat16,') > short
    assert entry.count('short_seq::N_SHORT') == 1 and 'getenv' not in entry
    assert 8 <= _n_short() <= 64
    src = (_cuda.CSRC / 'flash_attention_short.cuh').read_text()
    assert 'getenv' not in src and '__nv_bfloat16' in src and 'launch_fwd_dh<float>' in src


@pytest.mark.parametrize('n', [1, 2, 8, 65])
def test_packed_wrappers_pass_any_length(recorder, n):
    """The wrappers hand every length to the same entry points (the rule is
    in C): no Python route depends on n."""
    b, h, dh = 2, 3, 64
    D = h * dh
    q, k, v = torch.zeros(b, n, 3 * D, dtype=BF16).split(D, dim=-1)
    out, lse = fa._flash_cuda(q, k, v, None, h, dh ** -0.5, None, 0.0, 0, None)
    fa._flash_bwd_cuda(q, k, v, None, out, lse, torch.zeros(b, n, D, dtype=BF16), h,
                       dh ** -0.5, None, 0.0, 0, None)
    names = [name for name, _ in recorder.calls]
    assert names == ['e2_flash_fwd', 'e2_flash_delta', 'e2_flash_bwd']
    assert recorder.calls[0][1][14] == recorder.calls[2][1][17] == n     # the length
