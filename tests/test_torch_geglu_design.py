"""Which design K6 / K7 run, and the vector design's index math, on the CPU.

csrc/geglu.cu has two designs. The vector design moves 16 bytes a load and
store (8 bf16 or 4 f32), takes its batch from blockIdx.y and maps each
vector to its row and first column with one 32-bit division; the scalar
design walks (b, n, inner) element by element. The C entry points choose
the vector design for bf16 at inner % 8 == 0 and f32 at inner % 4 == 0 when
every pointer is 16-byte aligned, and the scalar design otherwise.

Here a numpy uint32 model of the vector design's mapping (read off the
source: block and unroll sizes, the division, the counter terms) regenerates
the dropout mask and must give exactly ``ops/dropout.hash_keep``'s, with
every element covered once; the dispatch is read off the entry points; a
recorder stands in for the kernel library to show what the wrappers hand
them. No kernel runs here: the card tests (tests/test_torch_cuda.py) hold
both designs against the plain versions."""

import re

import numpy as np
import pytest
import torch

from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.ops import geglu_kernel as gk
from e2_tts_tpu_torch.ops.dropout import PRIMES, hash_keep, keep_threshold

BF16, F32 = torch.bfloat16, torch.float32
U32 = np.uint32
CODES = {'e2::kBFloat16': str(_cuda.DTYPE_CODES[BF16]),
         'e2::kFloat32': str(_cuda.DTYPE_CODES[F32])}
C_TYPES = {BF16: '__nv_bfloat16', F32: 'float'}
ENTRIES = {'fwd': 'e2_geglu_fwd', 'bwd': 'e2_geglu_bwd'}


def _source(name: str = 'geglu.cu') -> str:
    return (_cuda.CSRC / name).read_text()


def _body(src: str, head: str) -> str:
    start = src.index(head)
    return src[start:src.index('\n}\n', start)]


def _const(name: str) -> int:
    (value,) = re.findall(rf'constexpr int {name} = (\d+);', _source())
    return int(value)


def _vec_width(dtype) -> int:
    """kVec<T>: the elements in one 16-byte vector."""
    assert 'template <typename T> constexpr int kVec = 16 / sizeof(T);' in _source()
    return 16 // torch.empty((), dtype=dtype).element_size()


def _fmix32(x):
    """common.cuh's fmix32 at two rounds, its multipliers read off the source."""
    mults = [int(m, 16) for m in re.findall(r'x \*= (0x[0-9A-Fa-f]+)u;', _source('common.cuh'))]
    assert len(mults) == 2
    x = x ^ (x >> U32(16))
    x = x * U32(mults[0])
    x = x ^ (x >> U32(15))
    x = x * U32(mults[1])
    return x ^ (x >> U32(16))


def test_vector_kernels_compute_the_modelled_indices():
    """Both vector kernels map a thread's vectors as the model below does:
    UNROLL vectors THREADS apart, one division by the row's vector count,
    the counter's (b, row, column) terms once a vector and P2 an element."""
    src = _source()
    (p0, p1, p2) = [int(v, 16) for v in re.findall(
        r'constexpr unsigned P0 = (0x\w+)u, P1 = (0x\w+)u, P2 = (0x\w+)u;', src)[0]]
    assert (p0, p1, p2) == PRIMES[:3]
    grid = _body(src, 'template <typename T, typename Params> dim3 vector_grid(')
    assert 'const long long per_batch = (long long)p.n * (p.inner / kVec<T>);' in grid
    assert 'const long long x = (per_batch + THREADS * UNROLL - 1) / (THREADS * UNROLL);' in grid
    assert 'const int y = p.b < 1 ? 1 : (p.b > MAX_GRID_Y ? MAX_GRID_Y : p.b);' in grid
    for kernel in ('geglu_fwd_vec_kernel', 'geglu_bwd_vec_kernel'):
        body = _body(src, f'__global__ void __launch_bounds__(THREADS) {kernel}(')
        for line in ('const unsigned nv = (unsigned)p.inner / V;',
                     'const unsigned per_batch = (unsigned)p.n * nv;',
                     'const unsigned first = blockIdx.x * (THREADS * UNROLL) + threadIdx.x;',
                     'for (int bi = blockIdx.y; bi < p.b; bi += gridDim.y) {',
                     'const unsigned ctr_b = p.seed + (unsigned)bi * P0;',
                     'const unsigned w = first + u * THREADS;',
                     'row[u] = w / nv;',
                     'col[u] = (w - row[u] * nv) * V;',
                     'if (w < per_batch) {',
                     'if (first + u * THREADS >= per_batch) break;',
                     'const unsigned ctr = ctr_b + row[u] * P1 + col[u] * P2;',
                     'if constexpr (DROP) {',
                     'drop(', 'ctr + (unsigned)j * P2, p.threshold, p.inv_keep);'):
            assert line in body, (kernel, line)
        # the only division is the vector's: no 64-bit index arithmetic
        assert body.count(' / ') == 2 and 'long long' not in body, kernel


def _vector_mask(b, n, inner, vec, seed, threshold, max_grid_y=None):
    """The vector design's keep bits over (b, n, inner), and how often each
    element was visited, in uint32 arithmetic as the kernel computes them."""
    threads, unroll = _const('THREADS'), _const('UNROLL')
    max_grid_y = max_grid_y or _const('MAX_GRID_Y')
    nv = inner // vec
    per_batch = n * nv
    gx = max(1, -(-per_batch // (threads * unroll)))
    gy = 1 if b < 1 else min(b, max_grid_y)
    keep = np.zeros((b, n, inner), dtype=bool)
    visits = np.zeros((b, n, inner), dtype=np.int64)
    first = (np.arange(gx, dtype=U32)[:, None] * U32(threads * unroll)
             + np.arange(threads, dtype=U32)[None, :]).ravel()
    for by in range(gy):
        for bi in range(by, b, gy):
            ctr_b = U32((seed + bi * PRIMES[0]) & 0xFFFFFFFF)
            for u in range(unroll):
                w = first + U32(u * threads)
                row = w // U32(nv)
                col = (w - row * U32(nv)) * U32(vec)
                ctr = ctr_b + row * U32(PRIMES[1]) + col * U32(PRIMES[2])
                live = w < U32(per_batch)
                for j in range(vec):
                    bits = _fmix32(ctr + U32(j * PRIMES[2] & 0xFFFFFFFF)) >= U32(threshold)
                    keep[bi, row[live], col[live] + j] = bits[live]
                    np.add.at(visits, (bi, row[live], col[live] + j), 1)
    return keep, visits


@pytest.mark.parametrize('dtype', [BF16, F32])
@pytest.mark.parametrize('b,n', [(2, 77), (3, 1)])
@pytest.mark.parametrize('inner', [96, 704, 1408, 1536, 2752, 3072])
def test_vector_mapping_gives_hash_keep(inner, b, n, dtype):
    """Every element of (b, n, inner) is visited exactly once, and its keep
    bit is hash_keep's, at every width the repo runs and ragged (b, n)."""
    seed, rate = 0xDEADBEEF, 0.1
    keep, visits = _vector_mask(b, n, inner, _vec_width(dtype), seed, keep_threshold(rate))
    assert (visits == 1).all()
    ref = hash_keep((b, n, inner), seed, rate).numpy()
    assert ref.any() and not ref.all()
    np.testing.assert_array_equal(keep, ref)


def test_vector_mapping_strides_batches_past_the_grid():
    """With fewer grid rows than batches (past MAX_GRID_Y), the batch loop
    strides by gridDim.y and still covers every batch once."""
    seed, rate = 7, 0.5
    keep, visits = _vector_mask(5, 33, 704, 8, seed, keep_threshold(rate), max_grid_y=2)
    assert (visits == 1).all()
    np.testing.assert_array_equal(keep, hash_keep((5, 33, 704), seed, rate).numpy())


def _pointer_args(entry: str):
    head = entry[entry.index('(') + 1:entry.index(')')]
    return [p for p in re.findall(r'void\* (\w+)', head) if p != 'stream']


def _design(entry: str, dtype, inner: int, vec: bool) -> str:
    """The kernel an entry point launches for ``dtype`` and ``inner`` when
    its ``vec`` test (alignment and 32-bit bound) is ``vec``, read off its
    ``if (...) return ...`` lines in their order."""
    env = {'dtype': _cuda.DTYPE_CODES[dtype], 'inner': inner, 'vec': vec}
    for cond, target in re.findall(r'\n  if \((.*)\)\n\s*return (.*);', entry):
        for name, code in CODES.items():
            cond = cond.replace(name, code)
        for t in (BF16, F32):
            cond = cond.replace(f'kVec<{C_TYPES[t]}>', str(_vec_width(t)))
        cond = cond.replace('&&', ' and ').replace('||', ' or ')
        if eval(cond, {}, env):
            return target
    raise AssertionError(f'no design for {dtype} at inner {inner}')


@pytest.mark.parametrize('inner', [100, 12, 704, 1408, 2752, 3072])
@pytest.mark.parametrize('dtype', [BF16, F32])
@pytest.mark.parametrize('kind', ENTRIES)
def test_entry_point_chooses_the_design(kind, dtype, inner):
    """The vector design for bf16 at inner % 8 == 0 and f32 at inner % 4 ==
    0 when every pointer is 16-byte aligned (and a batch's n * inner fits 32
    bits); the scalar design otherwise. No design argument."""
    src = _source()
    entry = _body(src, f'extern "C" int {ENTRIES[kind]}(')
    pointers = _pointer_args(entry)
    assert pointers == (['h2', 'out'] if kind == 'fwd' else ['h2', 'gout', 'gh2'])
    assert 'design' not in entry[:entry.index('{')]
    (vec_test,) = re.findall(r'const bool vec = (.*?);', entry, re.S)
    assert ' '.join(vec_test.split()) == ' && '.join(
        [f'aligned16({p})' for p in pointers] + ['(long long)n * inner <= INT_MAX'])
    assert 'return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;' in _body(
        src, 'bool aligned16(')
    t = C_TYPES[dtype]
    vector = f'{kind}_vector<{t}>(p, stream)'
    scalar = f'launch(geglu_{kind}_kernel<{t}>, scalar_grid(p), p, stream)'
    # the vector design's dropout is a template flag: one path a kernel
    run = ' '.join(_body(src, f'template <typename T> int {kind}_vector(').split())
    assert (f'return launch(p.dropping ? geglu_{kind}_vec_kernel<T, true> : '
            f'geglu_{kind}_vec_kernel<T, false>, vector_grid<T>(p), p, stream);') in run
    fits_vector = inner % _vec_width(dtype) == 0
    assert _design(entry, dtype, inner, True) == (vector if fits_vector else scalar)
    assert _design(entry, dtype, inner, False) == scalar


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


def _operand(shape, dtype, offset: bool):
    """A contiguous tensor; with ``offset`` a view one element into its
    storage, whose data pointer is not 16-byte aligned."""
    numel = int(np.prod(shape))
    if not offset:
        return torch.zeros(shape, dtype=dtype)
    t = torch.zeros(1 + numel, dtype=dtype)[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16
    return t


@pytest.mark.parametrize('offset', [False, True])
@pytest.mark.parametrize('dtype', [BF16, F32])
@pytest.mark.parametrize('kind', ENTRIES)
def test_wrappers_hand_the_views_pointers_to_the_dispatch(recorder, kind, dtype, offset):
    """The wrappers pass each operand's own data pointer (an offset view is
    not copied), the shape and the dtype code, and count one launch; so a
    view one element into its storage reaches the scalar design and an
    aligned tensor the vector design."""
    b, n, inner = 2, 5, 1408
    h2 = _operand((b, n, 2 * inner), dtype, offset)
    name = 'geglu_fwd' if kind == 'fwd' else 'geglu_bwd'
    before = _cuda.launch_counts[name]
    if kind == 'fwd':
        out = gk._geglu_cuda(h2, 3, 0.1)
        pointers = (h2, out)
    else:
        gout = _operand((b, n, inner), dtype, offset)
        out = gk._geglu_bwd_cuda(h2, gout, 3, 0.1)
        pointers = (h2, gout, out)
    assert _cuda.launch_counts[name] == before + 1
    ((called, args),) = recorder.calls
    assert called == ENTRIES[kind]
    assert len(args) == len(_cuda._SIGNATURES[called])
    k = len(pointers)
    assert args[:k] == tuple(t.data_ptr() for t in pointers)
    assert args[k:k + 3] == (b, n, inner)
    assert args[-2:] == (_cuda.DTYPE_CODES[dtype], 0)
    aligned = all(p % 16 == 0 for p in args[:k])
    assert aligned == (not offset)
    entry = _body(_source(), f'extern "C" int {called}(')
    design = _design(entry, dtype, inner, aligned)
    assert ('_vector<' in design) == (not offset)
