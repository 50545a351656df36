"""K11's design, on the CPU: the arithmetic and the geometry of csrc/mel.cu.

The kernel computes both DFT products and the mel product as three TF32
tensor-core products in split precision. `_kernel_model` repeats that
arithmetic in torch: ``cvt.rna.tf32`` emulated on the f32 bits (round to
nearest, ties away from zero, 13 low bits cleared), each operand split as
hi = tf32(x), lo = tf32(x - hi), and lo_a hi_b, hi_a lo_b, hi_a hi_b added
to one f32 accumulator in a tensor core's order: k8 step after k8 step,
each product's 8-term dot product (exact in f64) added and rounded to f32.
The order is the model's own, not the BLAS library's: an f32 matmul's
summation order is chosen at run time and moves the worst ratio against
the limit several-fold. It must hold K11's tolerance (2e-3 + 1e-3 |ref|) against an f64
reference on a prompt with a tone, noise and a digitally silent tail,
whose quiet frames the log amplifies; one TF32 product a product (the
planted fault) must not. The tile geometry, the choice between the two
geometries, the copy width of the frames and the wrapper's frequency split
are read off the source and held against the wrapper; the card tests
(tests/test_torch_cuda.py) hold the kernel itself against the plain
version.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_mel_variants as cmv
from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.ops import mel_kernel as mk
from e2_tts_tpu_torch.ops.mel import MelSpec, frame_signal

LIMIT = dict(atol=2e-3, rtol=1e-3)     # K11's tolerance, as the card tests hold it
SMS = 132                              # the H100's SMs


def _source() -> str:
    return (_cuda.CSRC / 'mel.cu').read_text()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the f32 bits: add half of the dropped 13 bits'
    range to the magnitude, then clear them (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(a, b, single_tf32=False):
    """``a @ b`` as the kernel's mma.m16n8k8 steps form it: per k8 step the
    8-term dot product of each TF32 product, exact in f64, added to the f32
    accumulator (lo hi, hi lo, hi hi; with ``single_tf32`` one hi hi)."""
    if single_tf32:
        pairs = [(_tf32(a), _tf32(b))]
    else:
        ah, al = _split(a)
        bh, bl = _split(b)
        pairs = [(al, bh), (ah, bl), (ah, bh)]
    pad = -a.shape[-1] % 8                   # zero columns add nothing
    steps = [torch.bmm(torch.nn.functional.pad(x.double(), (0, pad)).unflatten(-1, (-1, 8))
                       .transpose(0, 1),
                       torch.nn.functional.pad(y.double(), (0, 0, 0, pad)).unflatten(0, (-1, 8)))
             for x, y in pairs]             # each (k8 steps, m, n)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for i in range(steps[0].shape[0]):
        for step in steps:
            acc = (acc.double() + step[i]).float()
    return acc


def _kernel_model(frames, spec, single_tf32=False):
    re = _product(frames, spec.dft_cos, single_tf32)
    im = _product(frames, spec.dft_sin, single_tf32)
    mag = mk.spectrum(re * re + im * im, spec.power)
    return torch.log(torch.clamp(_product(mag, spec.fbanks, single_tf32), min=1e-5))


def _reference(frames, spec):
    f = frames.double()
    re, im = f @ spec.dft_cos.double(), f @ spec.dft_sin.double()
    sq = re * re + im * im
    mag = sq.sqrt() if spec.power == 1.0 else sq if spec.power == 2.0 else sq ** (spec.power / 2)
    return torch.log(torch.clamp(mag @ spec.fbanks.double(), min=1e-5))


def _prompt():
    """A 3-s prompt at 24 kHz: a 220-Hz tone, noise, and the last 30% zeros."""
    t = np.arange(72000) / 24000
    wave = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.default_rng(0).standard_normal(72000)
    wave[50400:] = 0.0
    return torch.from_numpy(wave.astype(np.float32))[None]


CASES = {'power 1': {}, 'power 2': dict(power=2.0),
         '160 mels n_fft 1000': dict(filter_length=1000, win_length=1000, n_mel_channels=160)}


@pytest.fixture
def one_thread():
    """One torch thread for the model's many small products (restored
    after): other test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _worst_ratio(case, single_tf32):
    spec = MelSpec(**CASES[case])
    frames = frame_signal(_prompt(), spec.dft_cos.shape[0], 256, center=True)[0]
    got = _kernel_model(frames, spec, single_tf32).double()
    ref = _reference(frames, spec)
    return float(((got - ref).abs() / (LIMIT['atol'] + LIMIT['rtol'] * ref.abs())).max())


def test_tf32_rounding():
    """The emulated cvt.rna: ties away from zero, the split exact to 2^-22."""
    one_and_half_ulp = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert _tf32(one_and_half_ulp).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
    x = torch.randn(10000, generator=torch.Generator().manual_seed(0)) * 1e3
    hi, lo = _split(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi.double() + lo.double() - x.double()).abs() <= x.double().abs() * 2.0 ** -21).all()


@pytest.mark.parametrize('case', list(CASES))
def test_split_tf32_holds_the_tolerance(case, one_thread):
    """Three TF32 products a product hold K11's limit against f64 on the
    silent-tail prompt, with room (~0.008-0.017 of the limit)."""
    assert _worst_ratio(case, single_tf32=False) < 0.1


@pytest.mark.parametrize('case', list(CASES))
def test_single_tf32_fails_the_tolerance(case, one_thread):
    """The planted fault: one TF32 product a product fails the same check
    (7-17x the limit), so the check can tell the two arithmetics apart."""
    assert _worst_ratio(case, single_tf32=True) > 2.0


# -- the geometry, read off csrc/mel.cu -------------------------------------------------

def _constant(name: str) -> int:
    return int(re.search(rf'constexpr int {name} = (\d+);', _source()).group(1))


def _geometry(name: str) -> dict:
    wm, kg, bk = map(int, re.search(
        rf'using {name} = Geometry<(\d+), (\d+), (\d+)>;', _source()).groups())
    mt, nt, wn = map(int, re.search(
        r'static constexpr int MT = (\d+), NT = (\d+), WN = (\d+),', _source()).groups())
    pad = lambda field: int(re.search(rf'static constexpr int {field} = \w+ \+ (\d+);',
                                      _source()).group(1))
    maxm = _constant('MAXM')
    return dict(threads=32 * wm * wn * kg, rows=16 * mt * wm, bins=8 * nt * wn,
                lda=bk + pad('LDA'), ldb=8 * nt * wn + pad('LDB'), ldm=8 * nt * wn + pad('LDM'),
                mel_ld=maxm + int(re.search(r'constexpr int MEL_LD = MAXM \+ (\d+);',
                                            _source()).group(1)))


def _entry_point() -> str:
    src = _source()
    start = src.index('extern "C" int e2_mel_fwd(')
    return src[start:src.index('\n}\n', start)]


def test_wrapper_mirrors_the_geometries():
    """The wrapper's (rows, bins) per block and its switch to the large
    geometry are the source's; the entry point chooses by the row count."""
    for name, key in (('Small', 'small'), ('Large', 'large')):
        geo = _geometry(name)
        assert mk.GEOMETRIES[key] == (geo['rows'], geo['bins'])
    assert mk.LARGE_ROWS == _constant('LARGE_ROWS')
    entry = _entry_point()
    assert 'if (rows >= LARGE_ROWS) return launch<Large>(p, nsplit, s);' in entry
    assert entry.rstrip().endswith('return launch<Small>(p, nsplit, s);')
    assert [mk.geometry(r) for r in (1, 282, 1151, 1152, 16384)] == [
        'small', 'small', 'small', 'large', 'large']


@pytest.mark.parametrize('name', ['Small', 'Large'])
def test_fragment_reads_are_conflict_free(name):
    """At the source's pitches every fragment read of a warp is free of bank
    conflicts. A fragments (frames, magnitudes): rows g and g + 8, samples
    2t and 2t + 1 as one 8-byte load, served a half-warp at a time (each
    half's 16 lanes on 32 distinct banks). B fragments (bases, filterbank
    rows): samples 2t and 2t + 1 (rows), column g, one 4-byte load each (32
    distinct banks)."""
    geo = _geometry(name)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for ld in (geo['lda'], geo['ldm']):
        for row in (g, g + 8):
            words = row * ld + 2 * t
            for half in (lane < 16, lane >= 16):
                banks = np.concatenate([words[half], words[half] + 1]) % 32
                assert len(set(banks)) == 32
        assert (ld * 4) % 16 == 0            # 16-byte cp.async rows
    for ld in (geo['ldb'], geo['mel_ld']):
        for row in (2 * t, 2 * t + 1):
            assert len(set((row * ld + g) % 32)) == 32


def test_prompt_geometry():
    """At the 3-s prompt (282 frames, 513 bins) the small geometry with the
    wrapper's split runs one tile a block: 9 row blocks x 9 tiles of 16
    warps (four k-groups), 1296 warps, ten an SM on 132 SMs; the Nyquist
    bin's tile is one n8 chunk, 8 columns of work, not a whole tile."""
    rows, n_freqs = 282, 513
    assert mk.geometry(rows) == 'small'
    geo = _geometry('Small')
    block_rows, tile_bins = mk.GEOMETRIES['small']
    tiles = -(-n_freqs // tile_bins)
    nsplit = mk.frequency_splits(rows, n_freqs, SMS)
    blocks = -(-rows // block_rows) * nsplit
    assert (tiles, nsplit, blocks, geo['threads'] // 32) == (9, 9, 81, 16)
    assert blocks * geo['threads'] // 32 >= 8 * SMS
    last = n_freqs - (tiles - 1) * tile_bins
    assert -(-last // 8) * 8 == 8
    # the training shape: 128 large blocks walk all 9 tiles, no split
    assert mk.geometry(16384) == 'large' and mk.frequency_splits(16384, n_freqs, SMS) == 1
    assert -(-16384 // mk.GEOMETRIES['large'][0]) == 128


@pytest.mark.parametrize('rows,n_freqs,sms,expected', [
    (1, 513, 132, 9), (282, 513, 132, 9), (300, 513, 132, 9), (282, 501, 132, 8),
    (1024, 513, 132, 5), (1151, 513, 132, 5), (1152, 513, 132, 9), (2048, 513, 132, 9), (8192, 513, 132, 3), (16384, 513, 132, 1),
    (16896, 513, 132, 1), (282, 513, 1, 1), (282, 33, 132, 1), (282, 1025, 132, 17),
    (100000, 513, 132, 1)])
def test_frequency_splits(rows, n_freqs, sms, expected):
    assert mk.frequency_splits(rows, n_freqs, sms) == expected


@pytest.mark.parametrize('rows', [1, 31, 32, 282, 1000, 1151, 1152, 2048, 5000, 16384, 40000])
@pytest.mark.parametrize('n_freqs', [33, 257, 501, 513])
def test_splits_cover_every_tile_once(rows, n_freqs):
    """The entry point's split of the tiles (tiles_per_split = ceil(tiles /
    nsplit), then nsplit recomputed so no split is empty) leaves the
    wrapper's nsplit as it is, and the blocks' tile ranges cover every tile
    of a row block exactly once."""
    nsplit = mk.frequency_splits(rows, n_freqs, SMS)
    tiles = -(-n_freqs // mk.GEOMETRIES[mk.geometry(rows)][1])
    assert 1 <= nsplit <= tiles
    per = -(-tiles // nsplit)
    assert -(-tiles // per) == nsplit
    covered = [tile for y in range(nsplit) for tile in range(y * per, min(tiles, (y + 1) * per))]
    assert covered == list(range(tiles))


def _vec(frames_ptr, batch_stride, frame_stride, n_fft) -> bool:
    """The entry point's choice of 16-byte frame copies, read off its source."""
    cond = re.search(r'p\.vec = (.*?);', _entry_point(), re.S).group(1)
    cond = cond.replace('reinterpret_cast<uintptr_t>(frames)', 'frames').replace('&&', 'and')
    return eval(' '.join(cond.split()), {}, dict(frames=frames_ptr, batch_stride=batch_stride,
                                                 frame_stride=frame_stride, n_fft=n_fft))


class _Recorder:
    def __init__(self):
        self.calls = []

    def e2_mel_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize('nw,b,n_fft,vec', [
    (72000, 1, 1024, True), (72001, 2, 1024, False), (300 * 256 + 77, 2, 1024, False),
    (149 * 256, 2, 1024, True),
    (72000, 1, 1000, True), (72000, 1, 1002, False)])
def test_wrapper_passes_the_split_and_the_view(monkeypatch, nw, b, n_fft, vec):
    """The wrapper hands the entry point the strided view's own pointer and
    strides (no frame tensor), its frequency split with a scratch buffer of
    that many splits, and counts one launch; a wave whose padded length is
    odd (batch stride not a multiple of 4 floats) or an n_fft that is not a
    multiple of 4 reaches the 4-byte frame copies."""
    rec = _Recorder()
    monkeypatch.setattr(_cuda, 'lib', lambda: rec)
    monkeypatch.setattr(_cuda, 'stream_ptr', lambda device: 0)
    monkeypatch.setattr(mk.torch.cuda, 'get_device_properties',
                        lambda device: SimpleNamespace(multi_processor_count=SMS))
    spec = MelSpec(filter_length=n_fft, win_length=n_fft)
    frames = frame_signal(torch.zeros(b, nw), n_fft, 256, center=True)
    before = _cuda.launch_counts['mel_fwd']
    out = mk._mel_cuda(frames, spec.dft_cos, spec.dft_sin, spec.fbanks, 1.0)
    assert _cuda.launch_counts['mel_fwd'] == before + 1
    ((args),) = rec.calls
    assert len(args) == len(_cuda._SIGNATURES['e2_mel_fwd'])
    t = frames.shape[1]
    rows, n_freqs = b * t, spec.fbanks.shape[0]
    assert args[:6] == (frames.data_ptr(), frames.stride(0), frames.stride(1), t, rows, n_fft)
    nsplit = args[13]
    assert nsplit == mk.frequency_splits(rows, n_freqs, SMS)
    assert (args[12] is not None) == (nsplit > 1)
    assert out.shape == (b, t, spec.fbanks.shape[1])
    assert _vec(args[0], args[1], args[2], args[5]) == vec


# -- the variants that chip_mel_variants.py measures on the card ----------------------

@pytest.mark.parametrize('name', list(cmv.VARIANTS))
def test_mel_variants_apply_to_the_source(name):
    """Each variant (chip_smoke.py's planted one-TF32 fault among them) is
    one change to today's csrc/mel.cu, each of its strings found once; the
    design's geometries, read as the script reads them, are the wrapper's."""
    src = _source()
    changed = cmv.variant_source(src, cmv.VARIANTS[name])
    assert (changed == src) == (name == 'design')
    geo, large_rows = cmv.geometries(changed)
    if name == 'design':
        assert (geo, large_rows) == (mk.GEOMETRIES, mk.LARGE_ROWS)
    if name.startswith('bins32'):
        assert geo['small'] == (32, 32)
