"""Which design the hyper-connection kernels run, on the CPU. The C entry
points choose it from the dtype and the stream count: the adjoints K5b / K4
(hyper_conn_bwd.cu) and their save-state variants K5bs / K4s
(hyper_conn_bwd_save.cu) on bf16 at 4 streams run the Hopper design
(hyper_conn_bwd_sm90.cuh, its SAVE flag false and true); f32 and bf16 at the
other stream counts keep the templates of hyper_conn_bwd.cuh. The forwards K5 / K3 and their save variants K5s /
K3s (hyper_conn.cu, hyper_conn_save.cu) on bf16 at 4 streams run the Hopper
design of hyper_conn_sm90.cuh, everything else the templates of
hyper_conn.cuh. The wrappers pass no design, only (for the adjoints) the
partial rows they allocated and, for the templates, the warps a block (the
Hopper designs set their own). The dispatch and the checks are read off the
sources; a recorder stands in for the kernel library, so no kernel runs
here: the card tests (tests/test_torch_cuda.py) hold both designs against
the plain versions."""

import re

import pytest
import torch

from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.ops import hyper_conn_kernel as hck

BF16, F32 = torch.bfloat16, torch.float32
ENTRY_POINTS = {'e2_hc_width_bwd': 'hyper_conn_bwd.cu',
                'e2_hc_width_fused_bwd': 'hyper_conn_bwd.cu',
                'e2_hc_width_bwd_save': 'hyper_conn_bwd_save.cu',
                'e2_hc_width_fused_bwd_save': 'hyper_conn_bwd_save.cu'}
CODES = {'e2::kBFloat16': str(_cuda.DTYPE_CODES[BF16]),
         'e2::kFloat32': str(_cuda.DTYPE_CODES[F32])}


def _source(name: str) -> str:
    return (_cuda.CSRC / name).read_text()


def _body(src: str, head: str) -> str:
    start = src.index(head)
    return src[start:src.index('\n}\n', start)]


def _design(entry: str, dtype, s: int) -> str:
    """The design an adjoint entry point launches for ``dtype`` at ``s``
    streams, read off its ``if (...) return ...`` lines in their order (the
    argument checks left out) and its final ``return``."""
    env = {'dtype': _cuda.DTYPE_CODES[dtype], 's': s}
    lines = re.findall(r'\n  if \((.*)\) return (.*);', entry)
    for cond, target in lines:
        for name, code in CODES.items():
            cond = cond.replace(name, code)
        if not set(re.findall(r'[A-Za-z_]\w*', cond)) <= set(env):
            continue                       # the argument checks
        if eval(cond.replace('&&', ' and ').replace('||', ' or '), {}, env):
            assert 'hc_sm90::bwd_run' in target, target
            return 'sm90'
    final = re.findall(r'\n  return (.*);\n?$', entry + '\n')
    assert final and 'bwd_route<' in final[-1], final
    return 'template'


def _route(dtype) -> str:
    """What hyper_conn_bwd.cuh's bwd_route<SAVE> runs: a template
    instantiation of the other-stream-count source or of the f32 source;
    never the Hopper design, and no template of its own."""
    body = _body(_source('hyper_conn_bwd.cuh'), 'int bwd_route(')
    assert 'hc_sm90' not in body and 'bwd_run<' not in body
    if dtype == BF16:
        assert 'if (dtype == e2::kBFloat16)\n    return e2_hc_bwd_streams_run(' in body
        return 'template, bf16 at other stream counts'
    assert 'if (dtype == e2::kFloat32)\n    return e2_hc_bwd_f32_run(' in body
    return 'template, f32'


@pytest.mark.parametrize('s', range(hck.MIN_STREAMS, hck.MAX_STREAMS + 1))
@pytest.mark.parametrize('dtype', [BF16, F32])
@pytest.mark.parametrize('name', ENTRY_POINTS)
def test_adjoint_design(name, dtype, s):
    """K5b / K4 and their save variants K5bs / K4s on bf16 at 4 streams
    launch the Hopper design; every other dtype and stream count keeps the
    templates of hyper_conn_bwd.cuh."""
    entry = _body(_source(ENTRY_POINTS[name]), f'extern "C" int {name}(')
    sm90 = dtype == BF16 and s == 4
    design = _design(entry, dtype, s)
    assert design == ('sm90' if sm90 else 'template')
    if not sm90:
        assert _route(dtype).startswith('template')
    assert 'design' not in entry.split(')')[0]           # no design argument


def test_only_the_recomputing_source_builds_the_hopper_design():
    """Exactly the two adjoint entry sources include the Hopper design, each
    instantiating only its own SAVE flag (hyper_conn_bwd.cu false,
    hyper_conn_bwd_save.cu true); the template sources keep
    hyper_conn_bwd.cuh and build no bf16 template at 4 streams, and
    bwd_route instantiates none (the save variants' old bf16 4-stream
    route is gone)."""
    own = {'hyper_conn_bwd.cu': 'false', 'hyper_conn_bwd_save.cu': 'true'}
    for src in sorted(_cuda.CSRC.glob('*.cu')):
        text = src.read_text()
        assert ('#include "hyper_conn_bwd_sm90.cuh"' in text) == (src.name in own)
        flags = re.findall(r'hc_sm90::bwd_run<(\w+)>', text)
        assert flags == ([own[src.name]] * 2 if src.name in own else []), (src.name, flags)
    for name in ('hyper_conn_bwd_streams.cu', 'hyper_conn_bwd_f32.cu'):
        assert '#include "hyper_conn_bwd.cuh"' in _source(name)
    assert 'Streams::kNot4' in _source('hyper_conn_bwd_streams.cu')
    assert 'bwd_run<__nv_bfloat16' not in _source('hyper_conn_bwd_f32.cu')
    header = _source('hyper_conn_bwd.cuh')
    assert 'enum class Streams { kAll, kNot4 };' in header
    route = _body(header, 'int bwd_route(')
    assert 'if constexpr (SAVE)' not in route and 's == 4' not in route
    assert 'bwd_run<' not in route and 'Streams::' not in route


@pytest.mark.parametrize('m', [1, 700, 1056, 16819, 100_000])
def test_wrapper_partial_rows_are_what_the_c_side_takes(m):
    """The Hopper entry sets its own warps a block (block_warps(d), no
    warps argument) and takes 1 <= blocks <= MAX_BLOCKS partial rows: the
    wrapper allocates min(M, MAX_BLOCKS) for bf16 at 4 streams (the save
    variants too: the geometry does not depend on the saved state), and the
    f32 templates keep their own geometry."""
    src = _source('hyper_conn_bwd_sm90.cuh')
    (max_blocks,) = re.findall(r'constexpr int MAX_BLOCKS = (\d+);', src)
    run = _body(src, 'inline int bwd_run(')
    assert 'warps' not in run[:run.index('{')]                # no warps argument
    assert 'const int threads = block_warps(p.d) * 32;' in src
    check = run[run.index('if ('):run.index('return (int)cudaErrorInvalidValue;')]
    assert 'blocks < 1' in check and 'blocks > MAX_BLOCKS' in check
    assert hck._SM90_MAX_BLOCKS == int(max_blocks)
    for d in (1, 1024, 1152, 4840):
        assert hck._bwd_geometry(4, m, d, BF16) == (0, min(m, int(max_blocks)))
        warps = hck._bwd_warps(4, d)
        assert hck._bwd_geometry(4, m, d, F32) == (
            warps, max(1, min(-(-m // warps), hck._BWD_MAX_BLOCKS)))


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


@pytest.mark.parametrize('save', [False, True])
@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('dtype,s,d', [(BF16, 4, 1024), (BF16, 4, 1152), (BF16, 4, 7),
                                       (BF16, 2, 64), (F32, 4, 1024)])
def test_wrappers_pass_the_geometry(recorder, dtype, s, d, fused, save):
    """The adjoint wrappers hand the entry points the dtype code, the
    stream count and the (warps, blocks) of `_bwd_geometry` (warps 0 and
    min(M, 1056) partial rows for the Hopper design of bf16 at 4 streams,
    saving or not), and no design argument."""
    m = 40
    dev = torch.device('cpu')
    ins = ([(torch.zeros(s, m, d, dtype=dtype), 'carried'), (torch.zeros(m, d, dtype=dtype), 'branch'),
            (torch.zeros(s, m, dtype=dtype), 'beta')] if fused
           else [(torch.zeros(s, m, d, dtype=dtype), 'residuals')])
    grads = [(torch.zeros(m, d, dtype=dtype), 'g_branch_in'),
             (torch.zeros(s, m, d, dtype=dtype), 'g_carried'), (torch.zeros(s, m, dtype=dtype), 'g_beta')]
    params = (torch.zeros(s, s + 1), torch.zeros(s), torch.zeros(d, s + 1), torch.tensor(0.5),
              torch.zeros(d), torch.tensor(0.5))
    outs = [torch.empty_like(t) for t, _ in ins]
    state = (torch.zeros(s, m, s + 2), torch.zeros(s, m)) if save else None
    name = 'hc_width_fused_bwd' if fused else 'hc_width_bwd'
    hck._launch_bwd(name, ins, grads, params, s, m, d, dtype, dev, outs, state)
    ((called, args),) = recorder.calls
    assert called == 'e2_' + name + ('_save' if save else '')
    assert len(args) == len(_cuda._SIGNATURES[called])
    blocks, warps, s_arg, m_arg, d_arg, code, stream = args[-7:]
    assert (s_arg, m_arg, d_arg, code, stream) == (s, m, d, _cuda.DTYPE_CODES[dtype], 0)
    assert (warps, blocks) == hck._bwd_geometry(s, m, d, dtype)
    if dtype == BF16 and s == 4:
        assert (warps, blocks) == (0, min(m, hck._SM90_MAX_BLOCKS))


def _forward_design(dtype, s: int) -> str:
    """The design `width_run` (hyper_conn_sm90.cuh) launches for ``dtype``
    at ``s`` streams, read off its ``if (...) return ...`` lines and its
    final ``return``."""
    body = _body(_source('hyper_conn_sm90.cuh'), 'int width_run(')
    env = {'dtype': _cuda.DTYPE_CODES[dtype], 's': s}
    for cond, target in re.findall(r'\n  if \((.*)\) return (.*);', body):
        for name, code in CODES.items():
            cond = cond.replace(name, code)
        if eval(cond.replace('&&', ' and ').replace('||', ' or '), {}, env):
            assert 'hc_sm90::fwd_run<SAVE>' in target, target
            return 'sm90'
    final = re.findall(r'\n  return (.*);\n?$', body + '\n')
    assert final and final[-1].startswith('fwd_run<SAVE>(p, s, fused, dtype'), final
    return 'template'


@pytest.mark.parametrize('save', [False, True])
@pytest.mark.parametrize('s', range(hck.MIN_STREAMS, hck.MAX_STREAMS + 1))
@pytest.mark.parametrize('dtype', [BF16, F32])
def test_forward_design(dtype, s, save):
    """K5 / K3 and their save variants K5s / K3s on bf16 at 4 streams launch
    the Hopper design; every other dtype and stream count keeps the
    templates of hyper_conn.cuh. Both entry sources reach `width_run` with
    their SAVE flag and no design argument."""
    assert _forward_design(dtype, s) == ('sm90' if dtype == BF16 and s == 4 else 'template')
    if save:
        entry = _body(_source('hyper_conn_save.cu'), 'int e2_hc_width_save_run(')
        assert 'return width_run<true>(' in entry
    else:
        entry = _body(_source('hyper_conn.cu'), 'int run(')
        assert 'return width_run<false>(p, s, fused, dtype, stream);' in entry
        assert 'return e2_hc_width_save_run(&p, s, fused, dtype, stream);' in entry
    for name in ('e2_hc_width', 'e2_hc_width_fused'):
        head = _source('hyper_conn.cu').split(f'extern "C" int {name}(')[1].split('{')[0]
        assert 'design' not in head and 'warps' not in head


def test_forward_templates_leave_bf16_at_four_streams_to_the_hopper_design():
    """hyper_conn.cuh instantiates no bf16 4-stream template (its stream
    dispatch launches 4 streams for f32 only) and keeps no register tile of
    the old design; the forward and adjoint Hopper designs share one
    geometry header."""
    body = _body(_source('hyper_conn.cuh'), 'cudaError_t dispatch_s(')
    case4 = body.split('case 4:')[1].split('case 5:')[0]
    assert 'if constexpr (std::is_same<T, float>::value) return launch<T, 4,' in case4
    assert case4.strip().endswith('return cudaErrorInvalidValue;')
    assert 'FULL' not in _source('hyper_conn.cuh')
    for name in ('hyper_conn_sm90.cuh', 'hyper_conn_bwd_sm90.cuh'):
        assert '#include "hyper_conn_sm90_common.cuh"' in _source(name)
    for src in sorted(_cuda.CSRC.glob('*.cu')):
        includes = '#include "hyper_conn_sm90.cuh"' in src.read_text()
        assert includes == (src.name in ('hyper_conn.cu', 'hyper_conn_save.cu'))


@pytest.mark.parametrize('save', [False, True])
@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('dtype,s,d', [(BF16, 4, 1024), (BF16, 4, 1152), (BF16, 4, 7),
                                       (BF16, 2, 64), (F32, 4, 1024)])
def test_forward_wrappers_pass_no_design(recorder, dtype, s, d, fused, save):
    """The forward wrappers hand the entry points the streams, parameters
    and outputs (ta and inv only with ``save_state``), then the stream
    count, rows, width, dtype code and stream: no design, no geometry."""
    m = 40
    dev = torch.device('cpu')
    ins = ([(torch.zeros(s, m, d, dtype=dtype), 'carried'), (torch.zeros(m, d, dtype=dtype), 'branch'),
            (torch.zeros(s, m, dtype=dtype), 'beta')] if fused
           else [(torch.zeros(s, m, d, dtype=dtype), 'residuals')])
    params = (torch.zeros(s, s + 1), torch.zeros(s), torch.zeros(d, s + 1), torch.tensor(0.5),
              torch.zeros(d), torch.tensor(0.5))
    name = 'hc_width_fused' if fused else 'hc_width'
    hck._launch(name, ins, params, s, m, d, dtype, dev, save)
    ((called, args),) = recorder.calls
    assert called == 'e2_' + name
    assert len(args) == len(_cuda._SIGNATURES[called])
    ta, inv, s_arg, m_arg, d_arg, code, stream = args[-7:]
    assert (s_arg, m_arg, d_arg, code, stream) == (s, m, d, _cuda.DTYPE_CODES[dtype], 0)
    assert (ta is None) == (inv is None) == (not save)
