"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: these need an NVIDIA GPU with nvcc (sm_90a) and skip
elsewhere; the decision is made in a fixture, never at import time. Run
them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`` (the
card machine has no JAX, which tests/conftest.py imports).
`chip_smoke.py` holds the same kernels against the same plain versions at
the flagship shapes.

Tolerances: bf16 outputs within 1e-2 + 1e-2 |ref| (two bf16 ulps; the
kernels and the plain versions round at the same points but sum in other
orders), f32 within 1e-4 + 1e-4 |ref|. The backward kernels' grads are held
to the same relative terms with the absolute term scaled by the largest
|ref| of each grad (grads of sums over thousands of rows are far from
unit scale); K2's dq also sums key tiles by atomicAdd in an order that
changes from run to run, which stays within the f32 term. K11's log-mel is
held to 2e-3 + 1e-3 |ref| (the JAX package's tolerance between its mel
modes: 1024-term f32 sums in other orders, amplified by the log in quiet
bins); K10's f32 sums to 1e-5 relative plus 1e-5 of the largest |ref|.
K8 / K9 as K1 / K2; the probe's bf16 output within 1e-2 |ref| plus 1e-2
of the largest |ref| (see the test). K10's do_g as the dtype's outputs
(one ulp: the kernel's expf and torch's sigmoid may differ in the last
bit before the rounding).
"""

import math
import re

import numpy as np
import pytest
import torch

from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.ops import flash_attention as fa
from e2_tts_tpu_torch.ops import geglu_kernel as gk
from e2_tts_tpu_torch.ops import hyper_conn_kernel as hck
from e2_tts_tpu_torch.ops import mel_kernel as mk
from e2_tts_tpu_torch.ops.mel import MelSpec, frame_signal

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2), torch.float32: dict(atol=1e-4, rtol=1e-4)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (the kernels have no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


def _close(out, ref, dtype):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(outs, refs):
        torch.testing.assert_close(o.float(), r.float(), **TOL[dtype])


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_flash_kernel(dev, dtype, rate):
    g = torch.Generator(device=dev).manual_seed(0)
    b, n, h, dh = 2, 200, 8, 64
    qkv = torch.randn(b, n, 3 * h * dh, generator=g, device=dev).to(dtype)
    q, k, v = qkv.split(h * dh, dim=-1)
    mask = torch.arange(n, device=dev)[None] < torch.tensor([n, 131], device=dev)[:, None]
    gate = torch.randn(b, n, h, generator=g, device=dev).to(dtype)
    kw = dict(heads=h, softclamp_value=50.0, dropout_rate=rate, dropout_seed=7,
              gate_logits=gate)
    before = _cuda.launch_counts['flash_fwd']
    out = fa.flash_attention_packed(q, k, v, mask, return_lse=True, **kw)
    assert _cuda.launch_counts['flash_fwd'] == before + 1
    ref = fa.flash_attention_packed_plain(q, k, v, mask, scale=dh ** -0.5, **kw)
    _close(out, ref, dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('d', [256, 512, 576, 1152])
def test_width_kernels(dev, dtype, fused, d):
    g = torch.Generator(device=dev).manual_seed(1)
    s, m = 4, 333
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
    params = (torch.eye(s, s + 1, device=dev) + rnd(s, s + 1, scale=0.1),
              1.0 + rnd(s, scale=0.1), rnd(d, s + 1, scale=0.05),
              torch.tensor(0.5, device=dev), rnd(d, scale=0.05), torch.tensor(0.5, device=dev))
    if fused:
        args = (rnd(s, m, d).to(dtype), rnd(m, d).to(dtype), rnd(s, m, scale=0.5).to(dtype))
        out, ref = hck.width_connection_fused(*args, *params), \
            hck.width_connection_fused_plain(*args, *params)
    else:
        res = rnd(s, m, d).to(dtype)
        out, ref = hck.width_connection(res, *params), hck.width_connection_plain(res, *params)
    _close(out, ref, dtype)


def _geglu_operand(g, shape, dtype, dev, offset):
    """Random values of ``shape``; with ``offset`` as a contiguous view one
    element into its storage (a data pointer that is not 16-byte aligned:
    the scalar design of csrc/geglu.cu)."""
    numel = math.prod(shape)
    buf = torch.randn(numel + int(offset), generator=g, device=dev).to(dtype)
    t = buf[int(offset):].view(shape)
    assert (t.data_ptr() % 16 != 0) == offset
    return t


# inner 1408 / 704 / 2752 run the vector design at an aligned base, 100 (not a
# multiple of the vector width) and every offset view the scalar design
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('inner', [1408, 704, 2752, 100])
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('offset', [False, True])
def test_geglu_kernel(dev, dtype, inner, rate, offset):
    g = torch.Generator(device=dev).manual_seed(2)
    h2 = _geglu_operand(g, (2, 100, 2 * inner), dtype, dev, offset)
    before = _cuda.launch_counts['geglu_fwd']
    got = gk.geglu_dropout(h2, 99, rate)
    assert _cuda.launch_counts['geglu_fwd'] == before + 1
    _close(got, gk.geglu_dropout_plain(h2, 99, rate), dtype)


def _close_grads(out, ref, dtype, joint=False):
    """Each grad within `TOL`'s relative term, its absolute term scaled by
    its largest |ref| (``joint``: by the largest |ref| of all the grads)."""
    rtol = TOL[dtype]['rtol']
    scale = max(float(r.float().abs().max()) for r in ref)
    for o, r in zip(out, ref):
        o, r = o.float(), r.float()
        assert torch.isfinite(o).all()
        torch.testing.assert_close(o, r, rtol=rtol, atol=rtol * (
            scale if joint else float(r.abs().max())) + 1e-12)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('gated', [False, True])
def test_flash_bwd_kernel(dev, dtype, rate, gated):
    g = torch.Generator(device=dev).manual_seed(3)
    b, n, h, dh = 2, 200, 8, 64
    qkv = torch.randn(b, n, 3 * h * dh, generator=g, device=dev).to(dtype)
    q, k, v = qkv.split(h * dh, dim=-1)
    mask = torch.arange(n, device=dev)[None] < torch.tensor([n, 131], device=dev)[:, None]
    gate = torch.randn(b, n, h, generator=g, device=dev).to(dtype) if gated else None
    kw = dict(heads=h, softclamp_value=50.0, dropout_rate=rate, dropout_seed=7,
              gate_logits=gate)
    out, lse = fa.flash_attention_packed(q, k, v, mask, return_lse=True, **kw)
    dout = torch.randn(b, n, h * dh, generator=g, device=dev).to(dtype)
    before = dict(_cuda.launch_counts)
    got = fa.flash_attention_packed_backward(q, k, v, mask, out, lse, dout, **kw)
    assert _cuda.launch_counts['flash_bwd'] == before['flash_bwd'] + 1
    assert _cuda.launch_counts['flash_delta'] == before['flash_delta'] + 1
    ref = fa.flash_attention_packed_backward_plain(q, k, v, mask, out, lse, dout,
                                                   scale=dh ** -0.5, **kw)
    assert (got[3] is None) == (not gated)
    _close_grads([t for t in got if t is not None], [t for t in ref if t is not None], dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('d', [256, 512, 576, 1152])
def test_width_bwd_kernels(dev, dtype, fused, d):
    g = torch.Generator(device=dev).manual_seed(4)
    s, m = 4, 333
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
    params = (torch.eye(s, s + 1, device=dev) + rnd(s, s + 1, scale=0.1),
              1.0 + rnd(s, scale=0.1), rnd(d, s + 1, scale=0.05),
              torch.tensor(0.5, device=dev), rnd(d, scale=0.05), torch.tensor(0.5, device=dev))
    grads = (rnd(m, d).to(dtype), rnd(s, m, d).to(dtype), rnd(s, m).to(dtype))
    name = 'hc_width_fused_bwd' if fused else 'hc_width_bwd'
    before = _cuda.launch_counts[name]
    if fused:
        args = (rnd(s, m, d).to(dtype), rnd(m, d).to(dtype), rnd(s, m, scale=0.5).to(dtype))
        got = hck.width_connection_fused_backward(*args, *params, *grads)
        ref = hck.width_connection_fused_backward_plain(*args, *params, *grads)
    else:
        res = rnd(s, m, d).to(dtype)
        got = hck.width_connection_backward(res, *params, *grads)
        ref = hck.width_connection_backward_plain(res, *params, *grads)
    assert _cuda.launch_counts[name] == before + 1
    _close_grads(got, ref, dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('inner', [1408, 704, 2752, 100])
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('offset', [False, True])
def test_geglu_bwd_kernel(dev, dtype, inner, rate, offset):
    g = torch.Generator(device=dev).manual_seed(5)
    h2 = _geglu_operand(g, (2, 100, 2 * inner), dtype, dev, offset)
    gout = _geglu_operand(g, (2, 100, inner), dtype, dev, offset)
    before = _cuda.launch_counts['geglu_bwd']
    got = gk.geglu_dropout_backward(h2, gout, 99, rate)
    assert _cuda.launch_counts['geglu_bwd'] == before + 1
    _close(got, gk.geglu_dropout_backward_plain(h2, gout, 99, rate), dtype)


def _tone_prompt():
    """A 3-s prompt at 24 kHz: a 220-Hz tone, noise (numpy seed 0) and the
    last 30% zeros, the wave of tests/test_torch_mel_design.py, on which one
    TF32 product a product fails K11's limit."""
    t = np.arange(72000) / 24000
    wave = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.default_rng(0).standard_normal(72000)
    wave[50400:] = 0.0
    return torch.from_numpy(wave.astype(np.float32))[None]


@pytest.mark.parametrize('case', ['prompt', 'power2', 'power0.7', 'win800', 'ragged_b2',
                                  'silent_tail', 'odd_batch_stride', 'large_2048', 'rows1',
                                  'n_fft1002'])
def test_mel_kernel(dev, case):
    """K11 against its plain version: the prompt and its options (both
    through the small geometry, split over frequency tiles), a prompt of a
    tone and noise whose last 30% is digital silence (the DFT's sums cancel
    around the tone and the log amplifies the quiet frames' errors), a
    batch of two waves whose padded length is odd (a batch stride that is
    not 16-byte aligned: 4-byte frame copies), 2 x 1024 frames (the large
    geometry), a single frame row, and n_fft 1002 (4-byte frame copies and
    a last k8 step of two samples)."""
    g = torch.Generator(device=dev).manual_seed(6)
    kw = dict(power2=dict(power=2.0), win800=dict(win_length=800),
              n_fft1002=dict(filter_length=1002, win_length=1002),
              **{'power0.7': dict(power=0.7)}).get(case, {})
    spec = MelSpec(mode='pallas', **kw).to(dev)
    n_fft = spec.dft_cos.shape[0]
    b, nw = dict(ragged_b2=(2, 300 * 256 + 77), odd_batch_stride=(2, 72001),
                 large_2048=(2, 1023 * 256)).get(case, (1, 72000))
    wave = (_tone_prompt().to(dev) if case == 'silent_tail'
            else torch.randn(b, nw, generator=g, device=dev) * 0.1)
    frames = frame_signal(wave, n_fft, 256, center=True)
    if case == 'odd_batch_stride':
        assert frames.stride(0) % 4
    if case == 'rows1':
        frames = frames[0, :1]
    assert mk.geometry(frames.numel() // n_fft) == ('large' if case == 'large_2048' else 'small')
    before = _cuda.launch_counts['mel_fwd']
    if case == 'rows1':
        got = mk.fused_log_mel(frames, spec.dft_cos, spec.dft_sin, spec.fbanks, spec.power)
    else:
        got = spec(wave)
    assert _cuda.launch_counts['mel_fwd'] == before + 1
    ref = mk.fused_log_mel_plain(frames, spec.dft_cos, spec.dft_sin, spec.fbanks, spec.power)
    torch.testing.assert_close(got, ref if case == 'rows1' else ref.transpose(1, 2),
                               atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(16, 1056, 8, 64), (3, 333, 4, 32), (2, 65, 2, 128)])
def test_flash_delta_kernel(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(7)
    b, n, h, dh = shape
    o, do = (torch.randn(b, n, h * dh, generator=g, device=dev).to(dtype) for _ in range(2))
    before = _cuda.launch_counts['flash_delta']
    got, do_g = fa.flash_delta(o, do, heads=h)
    assert _cuda.launch_counts['flash_delta'] == before + 1
    assert do_g is do                                   # ungated: no do_g buffer
    ref, _ = fa.flash_delta_plain(o, do, h)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(16, 1056, 8, 64), (3, 333, 4, 32), (2, 65, 2, 128)])
def test_flash_delta_kernel_gated(dev, dtype, shape):
    """The gated K10: delta as without the gate, and do_g = do * sigmoid(gate)."""
    g = torch.Generator(device=dev).manual_seed(8)
    b, n, h, dh = shape
    o, do = (torch.randn(b, n, h * dh, generator=g, device=dev).to(dtype) for _ in range(2))
    gate = (2 * torch.randn(b, n, h, generator=g, device=dev)).to(dtype)
    before = _cuda.launch_counts['flash_delta']
    delta, do_g = fa.flash_delta(o, do, heads=h, gate_logits=gate)
    assert _cuda.launch_counts['flash_delta'] == before + 1
    ref_delta, ref_do_g = fa.flash_delta_plain(o, do, h, gate)
    torch.testing.assert_close(delta, ref_delta, rtol=1e-5,
                               atol=1e-5 * float(ref_delta.abs().max()))
    _close(do_g, ref_do_g, dtype)


def test_wrappers_keep_the_graph(dev):
    """On CUDA tensors that require grad, every kernel wrapper's output has
    a grad_fn (the autograd.Functions tie each forward kernel to its
    backward kernel)."""
    x = torch.randn(1, 64, 512, device=dev, dtype=torch.bfloat16, requires_grad=True)
    gate = torch.zeros(1, 64, 8, device=dev, dtype=torch.bfloat16, requires_grad=True)
    assert fa.flash_attention_packed(x, x, x, heads=8, gate_logits=gate).grad_fn is not None
    assert gk.geglu_dropout(x, 1, 0.1).grad_fn is not None
    params = [torch.zeros(4, 5, device=dev, requires_grad=True),
              torch.ones(4, device=dev, requires_grad=True),
              torch.zeros(256, 5, device=dev, requires_grad=True),
              torch.tensor(0.01, device=dev, requires_grad=True),
              torch.zeros(256, device=dev, requires_grad=True),
              torch.tensor(0.01, device=dev, requires_grad=True)]
    r = torch.randn(4, 64, 256, device=dev, dtype=torch.bfloat16)
    assert all(t.grad_fn is not None for t in hck.width_connection(r, *params))
    assert all(t.grad_fn is not None for t in hck.width_connection_fused(
        r, r[0], torch.ones(4, 64, device=dev, dtype=torch.bfloat16), *params))


def test_loss_backward_reaches_every_parameter(dev):
    """`loss.backward()` on the card from a raw-wave batch, through all ten
    kernels, gives every parameter a finite grad."""
    gen = torch.Generator().manual_seed(0)
    model = E2TTS(transformer=dict(dim=512, depth=2, heads=8, dim_head=64, num_registers=4,
                                   kernel_size=7, dropout=0.1),
                  mel_spec_kwargs=dict(mode='pallas'), dtype=torch.bfloat16, generator=gen,
                  device=dev).train()
    wave = 0.1 * torch.randn(2, 119 * 256, generator=gen).to(dev)     # 120 frames
    before = dict(_cuda.launch_counts)
    out = model(wave, text=['hello there', 'a b c'], lens=torch.tensor([120, 90]),
                drop_text_cond=False, generator=torch.Generator().manual_seed(1))
    out.loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(out.loss)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    # the flagship's heads of 64 run on K1 / K2: K8, K9 and the probe stay
    # idle, and so do the hyper-connection save-state variants (hc_save_state
    # is off)
    idle = ('flash_fwd_bhnd', 'flash_bwd_bhnd', 'flash_probe', 'hc_width_save',
            'hc_width_fused_save', 'hc_width_bwd_save', 'hc_width_fused_bwd_save')
    assert all(_cuda.launch_counts[k] > before[k] for k in _cuda.KERNELS if k not in idle)
    assert all(_cuda.launch_counts[k] == before[k] for k in idle)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 16, 96, device=dev)                     # dim_head 24
    with pytest.raises(ValueError):
        fa.flash_attention_packed(x, x, x, heads=4)
    with pytest.raises(ValueError):
        hck.width_connection(torch.zeros(3, 8, 64, device=dev),
                             *(torch.zeros(1, device=dev),) * 6)
    with pytest.raises(ValueError):
        gk.geglu_dropout(torch.zeros(1, 8, 64, device=dev).half())
    spec = MelSpec().to(dev)
    frames = torch.zeros(2, 1024, device=dev)
    with pytest.raises(ValueError):                            # f64 frames
        mk.fused_log_mel(frames.double(), spec.dft_cos, spec.dft_sin, spec.fbanks)
    with pytest.raises(ValueError):                            # tables on the CPU
        mk.fused_log_mel(frames, spec.dft_cos.cpu(), spec.dft_sin, spec.fbanks)
    o = torch.zeros(1, 16, 128, device=dev)
    with pytest.raises(ValueError):                            # not contiguous
        fa.flash_delta(o[:, ::2], o[:, ::2], heads=4)


def _bhnd_inputs(dev, dtype, b, n, h, dh, seed):
    """q, k, v as (b, h, n, dh) views of one packed (b, n, 3 h dh) projection
    (strided, as the model hands them to K8) and a ragged mask."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g, device=dev).to(dtype)
    q, k, v = (t.unflatten(-1, (h, dh)).transpose(1, 2) for t in qkv.split(h * dh, dim=-1))
    mask = torch.arange(n, device=dev)[None] < torch.tensor([n, 131], device=dev)[:b, None]
    return q, k, v, mask, g


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('dh', [8, 72, 128])
def test_flash_bhnd_kernels(dev, dtype, rate, dh):
    """K8 and K9 against their plain versions, on strided views, with a
    ragged mask, the softclamp and dropout."""
    b, n, h = 2, 200, 3
    q, k, v, mask, g = _bhnd_inputs(dev, dtype, b, n, h, dh, seed=5)
    kw = dict(softclamp_value=5.0, dropout_rate=rate, dropout_seed=7)
    before = dict(_cuda.launch_counts)
    out, lse = fa.flash_attention(q, k, v, mask, return_lse=True, **kw)
    assert _cuda.launch_counts['flash_fwd_bhnd'] == before['flash_fwd_bhnd'] + 1
    ref = fa.flash_attention_plain(q, k, v, mask, scale=dh ** -0.5, **kw)
    _close((out, lse), ref, dtype)
    dout = torch.randn(b, h, n, dh, generator=g, device=dev).to(dtype)
    got = fa.flash_attention_backward(q, k, v, mask, out, lse, dout, **kw)
    assert _cuda.launch_counts['flash_bwd_bhnd'] == before['flash_bwd_bhnd'] + 1
    ref = fa.flash_attention_backward_plain(q, k, v, mask, out, lse, dout, scale=dh ** -0.5,
                                            **kw)
    _close_grads(got, ref, dtype)


def test_flash_bhnd_rejects_other_heads(dev):
    """K8 / K9 take any dim_head from 1 to 256: just past that raises."""
    x = torch.zeros(1, 2, 16, 257, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='from 1 to 256'):
        fa.flash_attention(x, x, x)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('dh', [12, 136, 256])
def test_flash_bhnd_kernels_any_dim_head(dev, dtype, dh):
    """K8 / K9 at a head that is not a multiple of 8 (zero-padded by the
    wrapper) and at heads wider than 128 (two column chunks), ragged n = 777,
    softclamp and dropout, against their plain versions."""
    b, n, h = 2, 777, 2
    q, k, v, mask, g = _bhnd_inputs(dev, dtype, b, n, h, dh, seed=dh)
    kw = dict(softclamp_value=5.0, dropout_rate=0.1, dropout_seed=7)
    before = dict(_cuda.launch_counts)
    out, lse = fa.flash_attention(q, k, v, mask, return_lse=True, **kw)
    assert _cuda.launch_counts['flash_fwd_bhnd'] == before['flash_fwd_bhnd'] + 1
    assert out.shape == (b, h, n, dh)
    _close((out, lse), fa.flash_attention_plain(q, k, v, mask, scale=dh ** -0.5, **kw), dtype)
    dout = torch.randn(b, h, n, dh, generator=g, device=dev).to(dtype)
    got = fa.flash_attention_backward(q, k, v, mask, out, lse, dout, **kw)
    assert _cuda.launch_counts['flash_bwd_bhnd'] == before['flash_bwd_bhnd'] + 1
    ref = fa.flash_attention_backward_plain(q, k, v, mask, out, lse, dout, scale=dh ** -0.5,
                                            **kw)
    _close_grads(got, ref, dtype)


def _hc_args(dev, dtype, s, m, d, fused, seed):
    """Parameters, streams (one zero row) and incoming grads on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
    params = (torch.eye(s, s + 1, device=dev) + rnd(s, s + 1, scale=0.1),
              1.0 + rnd(s, scale=0.1), rnd(d, s + 1, scale=0.05),
              torch.tensor(0.5, device=dev), rnd(d, scale=0.05), torch.tensor(0.5, device=dev))
    if fused:
        ins = [rnd(s, m, d), rnd(m, d), rnd(s, m, scale=0.5)]
        ins[0][:, 5] = 0.0
        ins[1][5] = 0.0
    else:
        ins = [rnd(s, m, d)]
        ins[0][:, 5] = 0.0
    grads = (rnd(m, d).to(dtype), rnd(s, m, d).to(dtype), rnd(s, m).to(dtype))
    return [t.to(dtype) for t in ins], params, grads


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('d', [32, 64, 100, 768, 1024])
@pytest.mark.parametrize('s', [2, 3, 8])
def test_width_kernels_any_streams_and_width(dev, s, d, dtype):
    """K3 / K5 and K4 / K5b at stream counts and widths outside the
    flagship's, against their plain versions."""
    for fused in (False, True):
        ins, params, grads = _hc_args(dev, dtype, s, 700, d, fused, seed=s * 10 + d)
        fwd = hck.width_connection_fused_forward if fused else hck.width_connection_forward
        plain = hck.width_connection_fused_plain if fused else hck.width_connection_plain
        _close(fwd(*ins, *params), plain(*ins, *params), dtype)
        bwd = hck.width_connection_fused_backward if fused else hck.width_connection_backward
        bplain = (hck.width_connection_fused_backward_plain if fused
                  else hck.width_connection_backward_plain)
        _close_grads(bwd(*ins, *params, *grads), bplain(*ins, *params, *grads), dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('s,d', [(4, 1024), (4, 2048), (8, 2048), (2, 64), (3, 100)])
def test_width_save_variants(dev, s, d, dtype):
    """K5s / K3s write the same public outputs as K5 / K3, bit for bit, and a
    state that matches the plain version's (inv 1e-6 relative; ta, the tanh
    of a d-term sum, 1e-5 absolute in f32); K5bs / K4s from that state match
    the plain save adjoint and (where one template runs both) the
    recomputing K5b / K4, a zero row included. At bf16 and 4 streams each
    of K5bs / K4s and K5b / K4 is held against the f64 reference instead."""
    for fused in (False, True):
        ins, params, grads = _hc_args(dev, dtype, s, 900, d, fused, seed=s + d)
        fwd = hck.width_connection_fused_forward if fused else hck.width_connection_forward
        plain = hck.width_connection_fused_plain if fused else hck.width_connection_plain
        name = 'hc_width_fused' if fused else 'hc_width'
        before = dict(_cuda.launch_counts)
        pub, (ta, inv) = fwd(*ins, *params, save_state=True)
        assert _cuda.launch_counts[name + '_save'] == before[name + '_save'] + 1
        assert _cuda.launch_counts[name] == before[name]
        for a, b in zip(pub, fwd(*ins, *params)):
            assert torch.equal(a, b)
        _, (pta, pinv) = plain(*ins, *params, save_state=True)
        torch.testing.assert_close(inv, pinv, atol=0, rtol=1e-6)
        # ta is tanh of a d-term f32 sum taken in another order: 1e-5 absolute
        # in f32 (up to 2048 terms); in bf16 a normed value may round the
        # other way
        torch.testing.assert_close(ta, pta, rtol=0,
                                   atol=1e-5 if dtype == torch.float32 else 1e-2)
        bwd = hck.width_connection_fused_backward if fused else hck.width_connection_backward
        bplain = (hck.width_connection_fused_backward_plain if fused
                  else hck.width_connection_backward_plain)
        got = bwd(*ins, *params, *grads, state=(ta, inv))
        assert _cuda.launch_counts[name + '_bwd_save'] == before[name + '_bwd_save'] + 1
        _close_grads(got, bplain(*ins, *params, *grads, state=(ta, inv)), dtype)
        recompute = bwd(*ins, *params, *grads)
        if dtype == torch.bfloat16 and s == 4:
            # two designs, two summation orders: each kernel on its own
            # against the f64 reference, and two planted faults must fail it:
            # row 0 left out (its incoming grads zero), dyn_beta_scale x0.7
            args = (*ins, *params, *grads)
            drop = tuple(g.clone() for g in grads)
            drop[0][0], drop[1][:, 0], drop[2][:, 0] = 0, 0, 0
            for out, st in ((got, (ta, inv)), (recompute, None)):
                _hold_against_f64(fused, args, out, st)
                with pytest.raises(AssertionError):
                    _hold_against_f64(fused, args, bwd(*ins, *params, *drop, state=st), st)
                with pytest.raises(AssertionError):
                    _hold_against_f64(fused, args, (*out[:-1], out[-1] * 0.7), st)
        else:
            _close_save_recompute(got, recompute)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_width_save_keeps_the_clamp_on_tiny_rows(dev, dtype):
    """A row of rms 1e-7 (variance under the 1e-12 clamp, streams not zero)
    and a zero row: K5s / K3s save inv = exactly 1e6 there, the value the
    reference saves, so that K5bs / K4s's test inv < 1e6 agrees with the
    recomputing var > 1e-12; their stream grads then match K5b / K4's (one
    bf16 ulp at 4 bf16 streams, where the saved and recomputed tanh are sums
    in two orders; 1e-5 in f32, one template)."""
    s, m, d = 4, 600, 1024
    for fused in (False, True):
        ins, params, grads = _hc_args(dev, dtype, s, m, d, fused, seed=41)
        for t in ins[:2]:
            t[..., 7, :] *= 1e-7
        fwd = hck.width_connection_fused_forward if fused else hck.width_connection_forward
        bwd = hck.width_connection_fused_backward if fused else hck.width_connection_backward
        _, (ta, inv) = fwd(*ins, *params, save_state=True)
        assert float(ins[0][:, 7].float().abs().max()) > 0
        assert bool((inv[:, [5, 7]] == 1e6).all()), inv[:, [5, 7]]
        got, rec = bwd(*ins, *params, *grads, state=(ta, inv)), bwd(*ins, *params, *grads)
        for a, b in zip(got[:2 if fused else 1], rec):
            a, b = a.float(), b.float()
            rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
            torch.testing.assert_close(a, b, rtol=rtol, atol=1e-5 * float(b.abs().max()))


def _close_save_recompute(save, recompute):
    """K5bs / K4s against K5b / K4 where both run one template (f32, bf16 at
    other stream counts): 1e-5 relative plus 1e-5 of the largest |ref|."""
    for a, b in zip(save, recompute):
        a, b = a.float(), b.float()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()) + 1e-12)


def _hold_against_f64(fused, args, got, state):
    """One of K5b / K4 / K5bs / K4s (bf16, 4 streams) against the f64
    reference (`hck.width_backward_reference`): the bf16 input grads at one
    bf16 ulp (2**-7 relative plus 1e-5 of the largest |ref|) of the
    reference or of one of its alternatives, where a rounding point lies so
    near a bf16 midpoint that f32 sums may land on either side; each f32
    parameter grad on its own: the static ones (f32 sums with no rounding
    point) at 1e-5 relative plus 1e-5 of the largest |ref|, the dynamic
    weights and scales at 3e-4 of the largest |ref| (they sum products with
    gp, and a recomputing kernel's ta, that f32 sums may round the other way
    in a few rows)."""
    n_in = 3 if fused else 1
    ref, alts = hck.width_backward_reference(fused, *args, state=state)
    assert max(hck.reference_ratios(got[:n_in], ref[:n_in], alts)) <= 1.0
    for i, (a, b) in enumerate(zip(got[-6:], ref[-6:])):
        tol = 1e-5 if i < 2 else 3e-4
        torch.testing.assert_close(a.double(), b, rtol=1e-5 if i < 2 else 0,
                                   atol=tol * float(b.abs().max()) + 1e-12)


def test_width_kernels_reject_other_geometries(dev):
    """Stream counts outside 2..8 and widths past `max_dim` raise."""
    for s, d in ((1, 64), (9, 64), (4, hck.max_dim(4) + 1), (8, hck.max_dim(8) + 1)):
        ins, params, _ = _hc_args(dev, torch.bfloat16, s, 16, d, False, seed=0)
        with pytest.raises(ValueError, match='streams|width'):
            hck.width_connection(*ins, *params)


def _close_forward(out, ref, ins, params, fused):
    """K5 / K3 (bf16, 4 streams) against the plain version at the bf16
    tolerance; past it only where alphas from the kernel's saved tanh round
    otherwise than the plain version's, and then at one ulp of an alpha
    near 1 (2**-7) times the largest |stream| more (chip_smoke's
    `alpha_tol`)."""
    try:
        _close(out, ref, torch.bfloat16)
    except AssertionError:
        fwd = hck.width_connection_fused_forward if fused else hck.width_connection_forward
        plain = hck.width_connection_fused_plain if fused else hck.width_connection_plain
        (_, (ta, _)), (_, (pta, _)) = (fwd(*ins, *params, save_state=True),
                                       plain(*ins, *params, save_state=True))
        affine = lambda t: (t[..., :5] * params[3] + params[0][:, None]).to(torch.bfloat16)
        assert int((affine(ta) != affine(pta)).sum()) > 0
        atol = 1e-2 + 2 ** -7 * max(float(t.abs().max()) for t in ins[:2])
        for o, r in zip(out, ref):
            torch.testing.assert_close(o.float(), r.float(), atol=atol, rtol=1e-2)


def _check_width_sm90(dev, m, d, fused, seed):
    """The Hopper K5 / K3 (bf16, 4 streams, a zero row where m > 5) against
    the plain version, the launch counted once; K5s / K3s's outputs and a
    second call equal the first bit for bit."""
    if m > 5:
        ins, params, _ = _hc_args(dev, torch.bfloat16, 4, m, d, fused, seed)
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
        params = (torch.eye(4, 5, device=dev) + rnd(4, 5, scale=0.1), 1.0 + rnd(4, scale=0.1),
                  rnd(d, 5, scale=0.05), torch.tensor(0.5, device=dev), rnd(d, scale=0.05),
                  torch.tensor(0.5, device=dev))
        ins = [t.to(torch.bfloat16) for t in
               ([rnd(4, m, d), rnd(m, d), rnd(4, m, scale=0.5)] if fused else [rnd(4, m, d)])]
    fwd = hck.width_connection_fused_forward if fused else hck.width_connection_forward
    plain = hck.width_connection_fused_plain if fused else hck.width_connection_plain
    name = 'hc_width_fused' if fused else 'hc_width'
    before = _cuda.launch_counts[name]
    out = fwd(*ins, *params)
    assert _cuda.launch_counts[name] == before + 1
    _close_forward(out, plain(*ins, *params), ins, params, fused)
    for a, b, c in zip(out, fwd(*ins, *params), fwd(*ins, *params, save_state=True)[0]):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('d', [1, 7, 100, 250, 256, 512, 576, 1000, 1024, 1152, 2048, 4840])
def test_width_sm90_every_width(dev, d, fused):
    """The Hopper K5 / K3 at widths from 1 to max_dim(4) (odd widths copy
    2-byte pieces, 250 4-byte and 100 8-byte ones, both ending in a part
    chunk; 2048 is the widest one-chunk row, 4840 two chunks a thread)."""
    _check_width_sm90(dev, 700, d, fused, seed=d)


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('m,d', [(16819, 1024), (16819, 1152), (16819, 512), (1, 1024),
                                 (1, 7), (1, 4840)])
def test_width_sm90_rows(dev, m, d, fused):
    """The Hopper K5 / K3 at a ragged training M (16819 rows over a grid that
    does not divide them) and at M = 1."""
    _check_width_sm90(dev, m, d, fused, seed=m + d)


def _width_bwd_pair(dev, m, d, fused, seed, zero_row=True):
    """The Hopper K5b / K4 (bf16, 4 streams) and its plain version at (4, m,
    d), with one all-zero stream row where m allows (the rms clamp)."""
    s, dtype = 4, torch.bfloat16
    if zero_row and m > 5:
        ins, params, grads = _hc_args(dev, dtype, s, m, d, fused, seed)
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
        params = (torch.eye(s, s + 1, device=dev) + rnd(s, s + 1, scale=0.1),
                  1.0 + rnd(s, scale=0.1), rnd(d, s + 1, scale=0.05),
                  torch.tensor(0.5, device=dev), rnd(d, scale=0.05),
                  torch.tensor(0.5, device=dev))
        ins = ([rnd(s, m, d), rnd(m, d), rnd(s, m, scale=0.5)] if fused else [rnd(s, m, d)])
        ins = [t.to(dtype) for t in ins]
        grads = (rnd(m, d).to(dtype), rnd(s, m, d).to(dtype), rnd(s, m).to(dtype))
    bwd = hck.width_connection_fused_backward if fused else hck.width_connection_backward
    bplain = (hck.width_connection_fused_backward_plain if fused
              else hck.width_connection_backward_plain)
    return (lambda: bwd(*ins, *params, *grads)), (lambda: bplain(*ins, *params, *grads))


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('d', [1, 7, 100, 250, 256, 512, 576, 1000, 1024, 1152, 2048, 4840])
def test_width_bwd_sm90_every_width(dev, d, fused):
    """The Hopper K5b / K4 against the plain versions at widths from 1 to
    max_dim(4) (odd widths copy 2-byte pieces, 250 4-byte and 100 8-byte
    ones, both ending in a part chunk; 1000 leaves 3 of the team's 128
    threads idle, 2048 is the widest one-chunk row, 4840 two chunks a
    thread), with a zero row; the launch counted once."""
    name = 'hc_width_fused_bwd' if fused else 'hc_width_bwd'
    run, plain = _width_bwd_pair(dev, 700, d, fused, seed=d)
    before = _cuda.launch_counts[name]
    got = run()
    assert _cuda.launch_counts[name] == before + 1
    _close_grads(got, plain(), torch.bfloat16)


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('m,d', [(16819, 1024), (16819, 1152), (16819, 512), (1, 1024),
                                 (1, 7), (1, 4840)])
def test_width_bwd_sm90_rows(dev, m, d, fused):
    """The Hopper K5b / K4 at a ragged training M (16819 rows over a grid
    that does not divide them) and at M = 1, against the plain versions."""
    run, plain = _width_bwd_pair(dev, m, d, fused, seed=m + d)
    _close_grads(run(), plain(), torch.bfloat16)


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('d', [256, 1024, 1152, 4840])
def test_width_bwd_sm90_bit_equal(dev, d, fused):
    """Two calls of the Hopper K5b / K4 give the same bits: the parameter
    grads are per-block rows summed in block order, no float atomics."""
    run, _ = _width_bwd_pair(dev, 16896 if d <= 1152 else 2000, d, fused, seed=7)
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


def test_width_bwd_sm90_zero_rows(dev):
    """Every stream of many rows zero (var <= 1e-12 on each): the Hopper
    adjoints take the clamp branch as the plain versions do."""
    for fused in (False, True):
        g = torch.Generator(device=dev).manual_seed(11)
        s, m, d = 4, 3000, 1024
        rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
        params = (torch.eye(s, s + 1, device=dev) + rnd(s, s + 1, scale=0.1),
                  1.0 + rnd(s, scale=0.1), rnd(d, s + 1, scale=0.05),
                  torch.tensor(0.5, device=dev), rnd(d, scale=0.05), torch.tensor(0.5, device=dev))
        carried = rnd(s, m, d)
        carried[:, ::3] = 0.0
        ins = [carried, rnd(m, d), rnd(s, m, scale=0.5)] if fused else [carried]
        if fused:
            ins[1][::3] = 0.0
        ins = [t.to(torch.bfloat16) for t in ins]
        grads = (rnd(m, d).to(torch.bfloat16), rnd(s, m, d).to(torch.bfloat16),
                 rnd(s, m).to(torch.bfloat16))
        bwd = hck.width_connection_fused_backward if fused else hck.width_connection_backward
        bplain = (hck.width_connection_fused_backward_plain if fused
                  else hck.width_connection_backward_plain)
        _close_grads(bwd(*ins, *params, *grads), bplain(*ins, *params, *grads), torch.bfloat16)


def test_mel_kernel_160_mels_n_fft_1000(dev):
    """K11 with two mel groups and a 1000-sample frame (a tail of 8)."""
    g = torch.Generator(device=dev).manual_seed(8)
    spec = MelSpec(filter_length=1000, win_length=1000, n_mel_channels=160,
                   mode='pallas').to(dev)
    wave = torch.randn(1, 72000, generator=g, device=dev) * 0.1
    frames = frame_signal(wave, 1000, 256, center=True)
    got = spec(wave)
    assert got.shape[1] == 160
    ref = mk.fused_log_mel_plain(frames, spec.dft_cos, spec.dft_sin, spec.fbanks,
                                 spec.power).transpose(1, 2)
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize('mode', fa.PROBE_MODES)
@pytest.mark.parametrize('dh', list(range(8, 129, 8)))
def test_flash_probe_kernel(dev, mode, dh):
    g = torch.Generator(device=dev).manual_seed(6)
    x = (0.25 * torch.randn(2, 3, 150, dh, generator=g, device=dev)).to(torch.bfloat16)
    before = _cuda.launch_counts['flash_probe']
    out = fa.flash_probe(x, mode)
    assert _cuda.launch_counts['flash_probe'] == before + 1
    # mode 2 rounds s - (max + sum), of magnitude ~70, to bf16: a sum taken in
    # another order moves it by an ulp of that, so the absolute term scales
    # with the largest |ref|
    _close_grads((out,), (fa.flash_probe_plain(x, mode),), torch.bfloat16)


@pytest.mark.parametrize('mode', fa.PROBE_MODES)
@pytest.mark.parametrize('heads,dh', [(8, 64), (16, 72)])
def test_flash_probe_kernel_training_shapes(dev, mode, heads, dh):
    """The probe at the training shapes, where K8's launch geometry (and so
    the probe's) takes two warpgroups a block."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = (0.25 * torch.randn(16, heads, 1056, dh, generator=g, device=dev)).to(torch.bfloat16)
    _close_grads((fa.flash_probe(x, mode),), (fa.flash_probe_plain(x, mode),), torch.bfloat16)


def test_remat_matches_no_remat(dev):
    """A heads-of-72 E2TTS in f32 at dropout 0.1 on the card: per-layer
    remat gives the loss of the un-checkpointed model exactly (the same
    kernels on the same inputs) and grads within the f32 tolerance: K9's dq
    sums key tiles by atomics in a run-dependent order."""
    cfg = dict(dim=512, depth=2, heads=4, dim_head=72, num_registers=4, kernel_size=7,
               dropout=0.1, attn_laser=True)
    gen = torch.Generator().manual_seed(0)
    wave = 0.1 * torch.randn(2, 119 * 256, generator=gen).to(dev)     # 120 frames
    noise = torch.randn(2, 120, 100, generator=gen)
    results = []
    for remat in (True, False):
        model = E2TTS(transformer=dict(cfg, remat=remat),
                      generator=torch.Generator().manual_seed(1), device=dev).train()
        before = dict(_cuda.launch_counts)
        out = model(wave, text=['hello there', 'a b c'], lens=torch.tensor([120, 90]),
                    drop_text_cond=False, generator=torch.Generator().manual_seed(2),
                    times=torch.tensor([0.3, 0.6]), noise=noise,
                    rand_span_mask=torch.ones(2, 120, dtype=torch.bool))
        out.loss.backward()
        torch.cuda.synchronize()
        fwd = _cuda.launch_counts['flash_fwd_bhnd'] - before['flash_fwd_bhnd']
        assert fwd == (8 if remat else 4)
        assert _cuda.launch_counts['flash_fwd'] == before['flash_fwd']
        grads = [p.grad.float() for p in model.parameters()]
        results.append((float(out.loss.detach()), grads))
    (loss_on, grads_on), (loss_off, grads_off) = results
    assert loss_on == loss_off
    _close_grads(grads_on, grads_off, torch.float32)


def test_scan_layers_matches_unrolled(dev):
    """``scan_layers`` on the card (depth 6, heads 8 x 64: K1 / K2, f32,
    dropout 0.1), from the unrolled model's state dict: a CFG evaluation
    bit for bit; one train step's loss exactly and its grads within the
    f32 tolerance (K2's dq sums key tiles by atomics in a run-dependent
    order), with every layer of the plan's two scan groups (1-2, 3-4; both
    streams) run forward twice."""
    cfg = dict(dim=512, depth=6, heads=8, dim_head=64, num_registers=4, kernel_size=7,
               dropout=0.1)
    unrolled = E2TTS(transformer=cfg, generator=torch.Generator().manual_seed(1), device=dev)
    scan = E2TTS(transformer=dict(cfg, scan_layers=True), device=dev)
    scan.load_state_dict(unrolled.state_dict())
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 120, 100, generator=gen).to(dev)
    lens = torch.tensor([120, 90])
    ids = torch.as_tensor(unrolled.tokenizer(['hello there', 'a b c']), dtype=torch.long,
                          device=dev)
    with torch.no_grad():
        outs = [m.eval().cfg_transformer_with_pred_head(
            x, 0.5 * x, torch.tensor([0.3, 0.6], device=dev), text=ids,
            mask=torch.arange(120, device=dev)[None] < lens.to(dev)[:, None], cfg_strength=1.0)
            for m in (unrolled, scan)]
    assert torch.equal(*outs)
    results = []
    for model in (unrolled, scan):
        model.train()
        before = dict(_cuda.launch_counts)
        out = model(x, text=['hello there', 'a b c'], lens=lens, drop_text_cond=False,
                    generator=torch.Generator().manual_seed(2), times=torch.tensor([0.3, 0.6]),
                    noise=torch.randn(2, 120, 100, generator=torch.Generator().manual_seed(3)),
                    rand_span_mask=torch.ones(2, 120, dtype=torch.bool))
        out.loss.backward()
        torch.cuda.synchronize()
        fwd = _cuda.launch_counts['flash_fwd'] - before['flash_fwd']
        assert fwd == (12 if model is unrolled else 12 + 2 * 4)
        results.append((float(out.loss.detach()), [p.grad.float() for p in model.parameters()]))
    (loss_u, grads_u), (loss_s, grads_s) = results
    assert loss_s == loss_u
    _close_grads(grads_s, grads_u, torch.float32)


# -- K8 / K9 on the Hopper design (flash_attention_sm90.cuh) ----------------------------

SM90_HEADS = (8, 12, 16, 32, 48, 64, 72, 80, 96, 112, 128)


def _sm90_inputs(dev, b, n, h, dh, seed):
    """bf16 (b, h, n, dh) views of one packed projection, a ragged key mask
    (the second row keeps half its keys) and an output grad."""
    q, k, v, _, g = _bhnd_inputs(dev, torch.bfloat16, b, n, h, dh, seed)
    lens = torch.tensor([n, max(1, n // 2)], device=dev)[:b]
    mask = torch.arange(n, device=dev)[None] < lens[:, None]
    dout = torch.randn(b, h, n, dh, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, mask, dout


def _check_sm90(q, k, v, mask, dout, **kw):
    dh = q.shape[-1]
    assert q.dtype == torch.bfloat16 and dh <= 128           # the Hopper design
    before = dict(_cuda.launch_counts)
    out, lse = fa.flash_attention(q, k, v, mask, return_lse=True, **kw)
    got = fa.flash_attention_backward(q, k, v, mask, out, lse, dout, **kw)
    assert _cuda.launch_counts['flash_fwd_bhnd'] == before['flash_fwd_bhnd'] + 1
    assert _cuda.launch_counts['flash_bwd_bhnd'] == before['flash_bwd_bhnd'] + 1
    _close((out, lse), fa.flash_attention_plain(q, k, v, mask, scale=dh ** -0.5, **kw),
           torch.bfloat16)
    ref = fa.flash_attention_backward_plain(q, k, v, mask, out, lse, dout, scale=dh ** -0.5,
                                            **kw)
    _close_grads(got, ref, torch.bfloat16)


@pytest.mark.parametrize('n', [1, 63, 64, 65, 1056])
@pytest.mark.parametrize('dh', SM90_HEADS)
def test_flash_sm90_every_head_and_length(dev, dh, n):
    """The Hopper K8 / K9 at every padded head width from 16 to 128 (and
    heads of 8, 12, 72), lengths around the 64-row tile, a ragged mask,
    softclamp 50 and dropout 0.1, against the plain versions."""
    _check_sm90(*_sm90_inputs(dev, 2, n, 2, dh, seed=dh + n), softclamp_value=50.0,
                dropout_rate=0.1, dropout_seed=11)


@pytest.mark.parametrize('softclamp', [None, 50.0])
@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_flash_sm90_softclamp_and_dropout(dev, softclamp, rate):
    """Softclamp on and off, dropout on and off, at the DiT head (72)."""
    _check_sm90(*_sm90_inputs(dev, 2, 300, 4, 72, seed=3), softclamp_value=softclamp,
                dropout_rate=rate, dropout_seed=5)


def test_flash_sm90_keep_bits(dev):
    """The keep bits of both kernels are `dropout_keep_mask`'s, bit for bit:
    with q = k = 0 every probability is 1 / n, so with v (forward) and do
    (backward) the identity, o = keep / ((1 - rate) n) and dv = its
    transpose: each element is positive exactly where a key is kept."""
    b, h, n, rate, seed = 2, 3, 64, 0.25, 1234
    zeros = torch.zeros(b, h, n, n, device=dev, dtype=torch.bfloat16)
    eye = torch.eye(n, device=dev, dtype=torch.bfloat16).expand(b, h, n, n).contiguous()
    keep = fa.dropout_keep_mask(seed, b * h, n, rate, device=dev).view(b, h, n, n)
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    out, lse = fa.flash_attention(zeros, zeros, eye, return_lse=True, **kw)
    assert torch.equal(out > 0, keep)
    _, _, dv = fa.flash_attention_backward(zeros, zeros, eye, None, out, lse, eye, **kw)
    assert torch.equal(dv > 0, keep.transpose(-1, -2))


def test_flash_sm90_laser(dev):
    """LASER attention (log of K8 over exp(v)) on the Hopper design."""
    from e2_tts_tpu_torch.ops import attention as attention_op
    q, k, v, mask, _ = _sm90_inputs(dev, 2, 300, 4, 72, seed=9)
    got = attention_op.attention(q, k, v, mask, laser=True)
    laser_v = torch.exp(attention_op.softclamp(v.float(), 15.0)).to(torch.bfloat16)
    ref = torch.log(fa.flash_attention_plain(q, k, laser_v, mask, scale=72 ** -0.5,
                                             softclamp_value=50.0)[0].float().clamp(min=1e-20))
    # the log turns one bf16 ulp of out into ~4e-3, rounded to bf16 again
    torch.testing.assert_close(got.float(), ref, atol=2e-2, rtol=1e-2)


def test_remat_matches_no_remat_bf16(dev):
    """The heads-of-72 E2TTS in bf16 (K8 / K9 on the Hopper design): remat
    gives the same loss as no remat, grads within the bf16 tolerance (dq's
    vector reductions run in a run-dependent order)."""
    cfg = dict(dim=512, depth=2, heads=4, dim_head=72, num_registers=4, kernel_size=7,
               dropout=0.1)
    gen = torch.Generator().manual_seed(0)
    mel = torch.randn(2, 120, 100, generator=gen)
    noise = torch.randn(2, 120, 100, generator=gen)
    results = []
    for remat in (True, False):
        model = E2TTS(transformer=dict(cfg, remat=remat), dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(1), device=dev).train()
        out = model(mel.to(dev), text=['hello there', 'a b c'], lens=torch.tensor([120, 90]),
                    drop_text_cond=False, generator=torch.Generator().manual_seed(2),
                    times=torch.tensor([0.3, 0.6]), noise=noise,
                    rand_span_mask=torch.ones(2, 120, dtype=torch.bool))
        out.loss.backward()
        torch.cuda.synchronize()
        results.append((float(out.loss.detach()), [p.grad.float() for p in model.parameters()
                                                   if p.grad is not None]))
    (loss_on, grads_on), (loss_off, grads_off) = results
    assert loss_on == loss_off
    _close_grads(grads_on, grads_off, torch.bfloat16)


# -- K1 / K2 on the Hopper design (flash_attention_sm90.cuh) ----------------------------

def _packed_inputs(dev, b, n, h, dh, seed, gated=True):
    """bf16 q, k, v as views of one (b, n, 3 h dh) projection, a ragged key
    mask (the second row keeps half its keys), gate logits ~N(0, 2^2) and an
    output grad."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv.split(h * dh, dim=-1)
    lens = torch.tensor([n, max(1, n // 2)], device=dev)[:b]
    mask = torch.arange(n, device=dev)[None] < lens[:, None]
    gate = (2 * torch.randn(b, n, h, generator=g, device=dev)).to(torch.bfloat16)
    dout = torch.randn(b, n, h * dh, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, mask, gate if gated else None, dout


def _drop_none(ts):
    return tuple(t for t in ts if t is not None)


def _check_packed_sm90(q, k, v, mask, gate, dout, heads, **kw):
    """K1 then K2 (with K10) on the Hopper design against the plain versions;
    returns the kernels' (out, lse) and grads."""
    dh = q.shape[-1] // heads
    before = dict(_cuda.launch_counts)
    out, lse = fa.flash_attention_packed(q, k, v, mask, heads=heads, gate_logits=gate,
                                         return_lse=True, **kw)
    got = fa.flash_attention_packed_backward(q, k, v, mask, out, lse, dout, heads=heads,
                                             gate_logits=gate, **kw)
    for name in ('flash_fwd', 'flash_bwd', 'flash_delta'):
        assert _cuda.launch_counts[name] == before[name] + 1
    _close((out, lse), fa.flash_attention_packed_plain(q, k, v, mask, heads=heads,
                                                       scale=dh ** -0.5, gate_logits=gate,
                                                       **kw), torch.bfloat16)
    ref = fa.flash_attention_packed_backward_plain(q, k, v, mask, out, lse, dout, heads=heads,
                                                   scale=dh ** -0.5, gate_logits=gate, **kw)
    assert (got[3] is None) == (gate is None)
    _close_grads(_drop_none(got), _drop_none(ref), torch.bfloat16)
    return (out, lse), got


@pytest.mark.parametrize('n', [1, 63, 64, 65, 314, 1056])
@pytest.mark.parametrize('dh', [32, 64, 128])
def test_flash_packed_sm90_every_head_and_length(dev, dh, n):
    """The Hopper K1 / K2 at every head they take, lengths around the 64-row
    tile and the duration predictor's 314, a ragged mask, the gate,
    softclamp 50 and dropout 0.1, against the plain versions."""
    _check_packed_sm90(*_packed_inputs(dev, 2, n, 2, dh, seed=dh + n), heads=2,
                       softclamp_value=50.0, dropout_rate=0.1, dropout_seed=11)


@pytest.mark.parametrize('gated', [False, True])
@pytest.mark.parametrize('softclamp', [None, 50.0])
@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_flash_packed_sm90_gate_softclamp_and_dropout(dev, gated, softclamp, rate):
    """Gate, softclamp and dropout each on and off, at the flagship's heads."""
    _check_packed_sm90(*_packed_inputs(dev, 2, 300, 8, 64, seed=4, gated=gated), heads=8,
                       softclamp_value=softclamp, dropout_rate=rate, dropout_seed=5)


def test_flash_packed_sm90_keeps_the_gate(dev):
    """A gated layer keeps its gate: K1's output is far from the ungated
    plain version's, and K2's grads far from those the plain backward gives
    when it reads the ungated output grad (what K2 would give reading dout
    in place of K10's do_g)."""
    q, k, v, mask, gate, dout = _packed_inputs(dev, 2, 300, 8, 64, seed=6)
    kw = dict(heads=8, softclamp_value=50.0, dropout_rate=0.1, dropout_seed=3)
    (out, lse), got = _check_packed_sm90(q, k, v, mask, gate, dout, **kw)
    ungated, _ = fa.flash_attention_packed_plain(q, k, v, mask, scale=64 ** -0.5, **kw)
    assert (out.float() - ungated.float()).abs().max() > 10 * TOL[torch.bfloat16]['atol']
    wrong = fa.flash_attention_packed_backward_plain(q, k, v, mask, out, lse, dout,
                                                     scale=64 ** -0.5, **kw)
    for g, w in zip(got[:3], wrong[:3]):
        with pytest.raises(AssertionError):
            _close_grads((g,), (w,), torch.bfloat16)


@pytest.mark.parametrize('gated', [False, True])
def test_flash_packed_sm90_keep_bits(dev, gated):
    """The keep bits of the Hopper K1 / K2 are `dropout_keep_mask`'s, bit for
    bit: with q = k = 0 every probability is 1 / n, so with each head's v
    (forward) and do (backward) the identity, o = keep g / ((1 - rate) n)
    and dv its transpose (g = sigmoid(0) = 1/2 when gated): each element is
    positive exactly where a key is kept."""
    b, h, n, rate, seed = 2, 3, 64, 0.25, 1234
    zeros = torch.zeros(b, n, h * n, device=dev, dtype=torch.bfloat16)
    eye = torch.eye(n, device=dev, dtype=torch.bfloat16).repeat(b, 1, h).contiguous()
    gate = torch.zeros(b, n, h, device=dev, dtype=torch.bfloat16) if gated else None
    keep = fa.dropout_keep_mask(seed, b * h, n, rate, device=dev).view(b, h, n, n)
    kw = dict(heads=h, dropout_rate=rate, dropout_seed=seed, gate_logits=gate)
    out, lse = fa.flash_attention_packed(zeros, zeros, eye, return_lse=True, **kw)
    heads_of = lambda t: t.view(b, n, h, n).transpose(1, 2)
    assert torch.equal(heads_of(out) > 0, keep)
    _, _, dv, _ = fa.flash_attention_packed_backward(zeros, zeros, eye, None, out, lse, eye,
                                                     **kw)
    assert torch.equal(heads_of(dv) > 0, keep.transpose(-1, -2))


# -- the training stack's checkpoints on the card ------------------------------------------

def test_trainer_resume_round_trip(dev, tmp_path):
    """At the port's test width (SMALL_TF) with dropout 0.1, a trained
    duration predictor and accumulation 2 on the card: `train` saves after
    three micro-steps (mid-accumulation); a trainer built from other weights
    resumes to the same state bit for bit (CUDA tensors, the CPU generator),
    then one more step on both gives equal losses and a parameter gap of at
    most 0.1 of the step in L2 norm (K2's dq atomics sum in a run-dependent
    order; chip_smoke.py's RESUME_STEP_TOL gives the reason)."""
    from e2_tts_tpu_torch.models.duration import DurationPredictor
    from e2_tts_tpu_torch.training.data import ArrayDataset
    from e2_tts_tpu_torch.training.trainer import E2Trainer

    cfg = dict(dim=128, depth=2, heads=4, dim_head=32, num_registers=4, max_seq_len=256,
               kernel_size=7, dropout=0.1)

    def trainer(seed):
        gen = torch.Generator().manual_seed(seed)
        model = E2TTS(transformer=dict(cfg), generator=gen, device=dev)
        dp = DurationPredictor(transformer=dict(cfg), generator=gen, device=dev)
        return E2Trainer(model, duration_predictor=dp, train_duration_predictor=True,
                         dtype=torch.bfloat16, learning_rate=1e-3, num_warmup_steps=0,
                         total_steps=100, grad_accumulation_steps=2,
                         checkpoint_path=str(tmp_path / 'ckpt'))

    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((100, 90 - 7 * (i % 4))).astype(np.float32) for i in range(12)]
    a = trainer(1)
    a.train(ArrayDataset(mels, ['hello there', 'ok'] * 6), epochs=1, batch_size=4, save_step=3)
    b = trainer(2)
    assert b.resume() == 3
    for x, y in ((a.model, b.model), (a.ema.ema_model, b.ema.ema_model),
                 (a.duration_predictor, b.duration_predictor)):
        sx, sy = x.state_dict(), y.state_dict()
        assert all(torch.equal(sx[n], sy[n]) for n in sx)
    for oa, ob in ((a.optimizer, b.optimizer), (a.dp_optimizer, b.dp_optimizer)):
        sa, sb = oa.state_dict()['state'], ob.state_dict()['state']
        assert sa.keys() == sb.keys() and all(
            sa[i]['step'] == sb[i]['step'] and torch.equal(sa[i]['m'], sb[i]['m'])
            and torch.equal(sa[i]['v'], sb[i]['v']) for i in sa)
    assert (b.ema.step, b.ema.initted, b.accumulator.mini_step) == (
        a.ema.step, a.ema.initted, a.accumulator.mini_step) == (3, True, 1)
    assert all(torch.equal(x, y) for x, y in zip(a.accumulator.grads, b.accumulator.grads))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())

    mel = torch.from_numpy(np.stack([m[:, :64].T for m in mels[:4]])).to(dev)
    lens = torch.full((4,), 64, device=dev)
    text = a.prepare_batch(dict(mel=np.zeros((4, 100, 64)), mel_lengths=None,
                                text=['hello there', 'ok'] * 2))[2]
    p0 = [p.detach().clone() for p in a.model.parameters()]
    losses = []
    for t in (a, b):
        t.duration_step(mel, lens)
        losses.append(float(t.train_step(mel, lens, text, drop_text_cond=False)[0]))
    assert losses[0] == losses[1]
    sq = lambda x: float(x.double().square().sum())
    move = math.sqrt(sum(sq(p.detach() - q) for p, q in zip(a.model.parameters(), p0)))
    gap = math.sqrt(sum(sq(p.detach() - q.detach())
                        for p, q in zip(a.model.parameters(), b.model.parameters())))
    assert move > 0 and gap <= 0.1 * move


def _close_few_tokens(out, ref, dtype):
    """K8 / K9, and K1's tiled design past N_SHORT, over a few tokens:
    outputs are means of a few value rows of order 1, and the bf16 tiled
    kernels round each probability before the product (2**-9 max |v|) and
    the output after it (up to 2**-8 |o|): 2e-2 + 1e-2 |ref| in bf16, `TOL`
    in f32. (K1 / K2 up to N_SHORT tokens run the few-token design, f32
    probabilities: `TOL`.)"""
    tol = dict(atol=2e-2, rtol=1e-2) if dtype == torch.bfloat16 else TOL[dtype]
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.float(), r.float(), **tol)


# the frequency attention: a batch of b (n + registers) sequences of f tokens,
# no mask, softclamp, gate or dropout, q / k / v views of one projection;
# 66,048 sequences (B = 16 at N = 4096 frames) pass gridDim.z's 65,535
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,f', [(1037, 2), (1037, 4), (66_048, 2)])
def test_flash_kernels_across_frequency_tokens(dev, dtype, b, f):
    g = torch.Generator(device=dev).manual_seed(21)
    h, dh = 8, 64
    qkv = torch.randn(b, f, 3 * h * dh, generator=g, device=dev).to(dtype)
    q, k, v = qkv.split(h * dh, dim=-1)
    kw = dict(heads=h, softclamp_value=None)
    before = dict(_cuda.launch_counts)
    out, lse = fa.flash_attention_packed(q, k, v, return_lse=True, **kw)
    # the few-token design keeps its probabilities in f32: the usual limits
    _close((out, lse), fa.flash_attention_packed_plain(q, k, v, scale=dh ** -0.5, **kw), dtype)
    with pytest.raises(AssertionError):             # the limit sees a 5% scale fault
        _close(out, fa.flash_attention_packed_plain(q, k, v, scale=1.05 * dh ** -0.5, **kw)[0],
               dtype)
    dout = torch.randn(b, f, h * dh, generator=g, device=dev).to(dtype)
    got = fa.flash_attention_packed_backward(q, k, v, None, out, lse, dout, **kw)[:3]
    ref = fa.flash_attention_packed_backward_plain(q, k, v, None, out, lse, dout,
                                                   scale=dh ** -0.5, **kw)[:3]
    _close_grads(got, ref, dtype)
    for name in ('flash_fwd', 'flash_bwd', 'flash_delta'):
        assert _cuda.launch_counts[name] == before[name] + 1


def _n_short():
    """The largest n the few-token K1 / K2 take
    (csrc/flash_attention_short.cuh; the tiled designs above it)."""
    src = (_cuda.CSRC / 'flash_attention_short.cuh').read_text()
    return int(re.search(r'constexpr int N_SHORT = (\d+);', src).group(1))


N_SHORT = _n_short()
# the dropout hash's place of a launch away from the origin on every axis
FEW_HASH = dict(hash_b0=3, hash_h0=2, hash_heads=12, hash_r0=5, hash_c0=7)


def _few_inputs(dev, dtype, b, n, h, dh, seed):
    """q, k, v views of one (b, n, 3 h dh) projection, a ragged key mask
    (row 0 whole, row 1 a single key), gate logits and an output grad."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D = h * dh
    q, k, v = torch.randn(b, n, 3 * D, generator=g, device=dev).to(dtype).split(D, dim=-1)
    lens = torch.randint(1, n + 1, (b,), generator=g, device=dev)
    lens[0], lens[1] = n, 1
    mask = torch.arange(n, device=dev)[None] < lens[:, None]
    gate = (2 * torch.randn(b, n, h, generator=g, device=dev)).to(dtype)
    dout = torch.randn(b, n, D, generator=g, device=dev).to(dtype)
    return q, k, v, mask, gate, dout


def _check_few(q, k, v, mask, gate, dout, heads, fault=True, **kw):
    """K1, then K2 with K10, against the plain versions at `TOL` (past
    N_SHORT, K1 at `_close_few_tokens`; a softmax over one key has no logit
    gradient: at n = 1 dq and dk are rounding alone, held to the grads'
    joint scale); with ``fault`` a plain version with its softmax scale 5%
    off must fail K1's limit."""
    n, dh = q.shape[1], q.shape[-1] // heads
    kw = dict(heads=heads, gate_logits=gate, **kw)
    before = dict(_cuda.launch_counts)
    out, lse = fa.flash_attention_packed(q, k, v, mask, return_lse=True, **kw)
    # past N_SHORT the tiled bf16 design rounds each probability (`_close_few_tokens`)
    close = _close if n <= N_SHORT else _close_few_tokens
    close((out, lse), fa.flash_attention_packed_plain(q, k, v, mask, scale=dh ** -0.5, **kw),
          q.dtype)
    if fault:
        with pytest.raises(AssertionError):
            close((out,), fa.flash_attention_packed_plain(q, k, v, mask, scale=1.05 * dh ** -0.5,
                                                          **kw)[:1], q.dtype)
    got = fa.flash_attention_packed_backward(q, k, v, mask, out, lse, dout, **kw)
    ref = fa.flash_attention_packed_backward_plain(q, k, v, mask, out, lse, dout,
                                                   scale=dh ** -0.5, **kw)
    _close_grads(_drop_none(got), _drop_none(ref), q.dtype, joint=n == 1)
    for name in ('flash_fwd', 'flash_bwd', 'flash_delta'):
        assert _cuda.launch_counts[name] == before[name] + 1


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('n', [1, 2, 3, 4, 8, 16, N_SHORT, N_SHORT + 1])
def test_flash_few_tokens(dev, dtype, n):
    """K1 / K2 at a few tokens, up to N_SHORT on the few-token design and
    past it on the tiled one: a ragged key mask, softclamp 50, the gate,
    dropout 0.1 at non-zero hash offsets on every axis, at the usual limits
    (the few-token design keeps its probabilities in f32)."""
    _check_few(*_few_inputs(dev, dtype, 37, n, 4, 64, seed=40 + n), heads=4, fault=n > 1,
               softclamp_value=50.0, dropout_rate=0.1, dropout_seed=99, **FEW_HASH)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('dh', [32, 128])
def test_flash_few_tokens_every_head(dev, dtype, dh):
    """The few-token K1 / K2 at dim_head 32 and 128 (groups of 4 to 32
    lanes), f = 3, every feature on."""
    _check_few(*_few_inputs(dev, dtype, 29, 3, 2, dh, seed=dh), heads=2, softclamp_value=50.0,
               dropout_rate=0.1, dropout_seed=5, **FEW_HASH)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('n', [2, 3, 16])
def test_flash_few_tokens_keep_bits(dev, dtype, n):
    """The few-token K1 / K2 draw `dropout_keep_mask`'s bits at every hash
    offset, bit for bit: q = k = 0 makes every probability 1 / n, each
    head's v (forward) and do (backward) are the first n columns of the
    identity, so o and dv are positive exactly where a key is kept (gated:
    sigmoid(0) = 1/2)."""
    b, h, dh, rate, seed = 5, 3, 32, 0.25, 1234
    zeros = torch.zeros(b, n, h * dh, device=dev, dtype=dtype)
    eye = torch.eye(n, dh, device=dev, dtype=dtype).repeat(b, 1, h).contiguous()
    gate = torch.zeros(b, n, h, device=dev, dtype=dtype)
    keep = fa.dropout_keep_mask(seed, b * h, n, rate, device=dev, heads=h,
                                **FEW_HASH).view(b, h, n, n)
    kw = dict(heads=h, dropout_rate=rate, dropout_seed=seed, gate_logits=gate, **FEW_HASH)
    out, lse = fa.flash_attention_packed(zeros, zeros, eye, return_lse=True, **kw)
    heads_of = lambda t: t.view(b, n, h, dh).transpose(1, 2)[..., :n]
    assert torch.equal(heads_of(out) > 0, keep)
    _, _, dv, _ = fa.flash_attention_packed_backward(zeros, zeros, eye, None, out, lse, eye,
                                                     **kw)
    assert torch.equal(heads_of(dv) > 0, keep.transpose(-1, -2))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_flash_few_tokens_misaligned_views(dev, dtype, monkeypatch):
    """The few-token K1 / K2 read q, k, v through element loads where a
    view's start or row stride is not in whole 16 bytes (the scalar path):
    views of a (b, n, 3 h dh + 1) projection, one element in. The wrappers
    refuse such views (the tiled designs take 16-byte chunks), so their
    operand check is stood aside here and the entry points read them."""
    monkeypatch.setattr(fa, '_check_operand', lambda t, name, shape, device, dt, vec:
                        _cuda.check_cuda_tensor(t, name, device, dt))
    b, n, h, dh = 23, 3, 8, 64
    D = h * dh
    q, k, v, mask, gate, dout = _few_inputs(dev, dtype, b, n, h, dh, seed=8)
    qkv = torch.cat((torch.zeros(b, n, 1, device=dev, dtype=dtype), q, k, v), dim=-1)
    q, k, v = qkv[..., 1:D + 1], qkv[..., D + 1:2 * D + 1], qkv[..., 2 * D + 1:]
    assert q.data_ptr() % 16 and q.stride(1) % 8
    _check_few(q, k, v, mask, gate, dout, heads=h, softclamp_value=50.0, dropout_rate=0.1,
               dropout_seed=3, **FEW_HASH)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('P', [2, 4])
def test_ring_few_tokens_matches_one_launch(dev, P, dtype):
    """The ring (`sp.Loopback`, P shards) over 8 tokens runs few-token K1 /
    K2 blocks of 8 / P tokens at their hash_r0 / hash_c0 against one
    launch over the 8: a wholly masked shard, softclamp 50, dropout 0.1."""
    from e2_tts_tpu_torch.parallel import sp
    g = torch.Generator(device=dev).manual_seed(12)
    b, heads, n, dh = 41, 8, 8, 64
    q, k, v, do = (torch.randn(b, n, heads * dh, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    mask = torch.ones(b, n, dtype=torch.bool, device=dev)
    mask[1, 3:] = False
    kw = dict(heads=heads, softclamp_value=50.0, dropout_rate=0.1, dropout_seed=77, hash_b0=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sp.ring_attention(*leaves, mask, mesh=sp.Loopback(P), **kw)
    ref = fa.flash_attention_packed(*refs, mask, **kw)
    _close(out, ref, dtype)
    out.backward(do)
    ref.backward(do)
    _close_grads([t.grad for t in leaves], [t.grad for t in refs], dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('heads,dh', [(8, 8), (1, 136)])
def test_bhnd_kernels_past_grid_z(dev, dtype, heads, dh):
    """K8 / K9 at 66,048 sequences of 2 tokens: dh 8 (the JAX tests'
    freq_dim_head) and 136 (the wide template's two column chunks)."""
    g = torch.Generator(device=dev).manual_seed(22)
    b, n = 66_048, 2
    q, k, v, dout = (torch.randn(b, heads, n, dh, generator=g, device=dev).to(dtype)
                     for _ in range(4))
    out, lse = fa.flash_attention(q, k, v, return_lse=True, softclamp_value=None)
    _close_few_tokens((out, lse), fa.flash_attention_plain(q, k, v, scale=dh ** -0.5), dtype)
    got = fa.flash_attention_backward(q, k, v, None, out, lse, dout, softclamp_value=None)
    _close_grads(got, fa.flash_attention_backward_plain(q, k, v, None, out, lse, dout,
                                                        scale=dh ** -0.5), dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('layout', ['packed', 'bhnd'])
def test_flash_hash_b0(dev, layout, dtype):
    """``hash_b0``: K1 / K2 (packed, heads of 64) and K8 / K9 (heads of 72)
    launched on rows [b, 2b) with ``hash_b0 = b`` give the rows of one
    launch over all 2b rows: out, lse, dk and dv bit for bit (the same
    arithmetic on the same inputs), dq within the f32 atomics' order; the
    keep bits are `dropout_keep_mask`'s at the offset (q = k = 0, v the
    identity: o > 0 exactly where a key is kept); at offset 0 they are not."""
    g = torch.Generator(device=dev).manual_seed(3)
    b, n, heads, rate, seed = 2, 128, 4, 0.1, 99
    dh = 64 if layout == 'packed' else 72
    shape = (2 * b, n, heads * dh) if layout == 'packed' else (2 * b, heads, n, dh)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4))
    mask = torch.ones(2 * b, n, dtype=torch.bool, device=dev)
    mask[1, 100:] = mask[3, 77:] = False
    kw = dict(softclamp_value=50.0, dropout_rate=rate, dropout_seed=seed)
    if layout == 'packed':
        fwd = lambda *a, **o: fa.flash_attention_packed(*a, heads=heads, return_lse=True,
                                                        **kw, **o)
        bwd = lambda *a, **o: fa.flash_attention_packed_backward(*a, heads=heads, **kw,
                                                                 **o)[:3]
    else:
        fwd = lambda *a, **o: fa.flash_attention(*a, return_lse=True, **kw, **o)
        bwd = lambda *a, **o: fa.flash_attention_backward(*a, **kw, **o)
    out, lse = fwd(q, k, v, mask)
    dq, dk, dv = bwd(q, k, v, mask, out, lse, do)
    h = lambda t: t[b:]
    o2, l2 = fwd(h(q), h(k), h(v), h(mask), hash_b0=b)
    dq2, dk2, dv2 = bwd(h(q), h(k), h(v), h(mask), o2, l2, h(do), hash_b0=b)
    assert torch.equal(o2, h(out)) and torch.equal(l2, lse[b * heads:])
    assert torch.equal(dk2, h(dk)) and torch.equal(dv2, h(dv))
    torch.testing.assert_close(dq2.float(), h(dq).float(), atol=1e-4 * float(dq.abs().max()),
                               rtol=TOL[dtype]['rtol'])
    assert not torch.equal(fwd(h(q), h(k), h(v), h(mask))[0], h(out))

    if layout == 'bhnd':
        zeros = torch.zeros(b, heads, n, dh, device=dev, dtype=dtype)
        eye = torch.eye(n, dh, device=dev, dtype=dtype).expand(b, heads, n, dh).contiguous()
        keep = fa.dropout_keep_mask(seed, b * heads, n, rate, device=dev, hash_b0=b,
                                    heads=heads).view(b, heads, n, n)
        o3 = fwd(zeros, zeros, eye, hash_b0=b)[0]
        assert torch.equal(o3 > 0, keep[..., :dh])


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('layout', ['packed', 'bhnd'])
def test_flash_hash_h0(dev, layout, dtype):
    """``hash_h0`` of ``hash_heads``: K1 / K2 (packed, gated, heads of 64) and
    K8 / K9 (heads of 72) launched on heads [h0, h0 + H/T), T = 2 and 4,
    with ``hash_h0 = h0``, ``hash_heads = H`` and ``hash_b0 = 2`` give those
    heads of one launch over all H: out, lse, dk and dv bit for bit, dq
    within the f32 atomics' order, the gate grad bit for bit; the keep bits
    are `dropout_keep_mask`'s at the offsets (q = k = 0, v the identity); at
    ``hash_h0 = 0`` they are not."""
    g = torch.Generator(device=dev).manual_seed(5)
    b, n, heads, rate, seed, b0 = 2, 128, 8, 0.1, 99, 2
    dh = 64 if layout == 'packed' else 72
    shape = (b, n, heads * dh) if layout == 'packed' else (b, heads, n, dh)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4))
    mask = torch.ones(b, n, dtype=torch.bool, device=dev)
    mask[1, 100:] = False
    kw = dict(softclamp_value=50.0, dropout_rate=rate, dropout_seed=seed, hash_b0=b0)
    if layout == 'packed':
        gate = (2 * torch.randn(b, n, heads, generator=g, device=dev)).to(dtype)
        fwd = lambda q, k, v, gt, hl, **o: fa.flash_attention_packed(
            q, k, v, mask, heads=hl, gate_logits=gt, return_lse=True, **kw, **o)
        bwd = lambda q, k, v, gt, out, lse, do, hl, **o: fa.flash_attention_packed_backward(
            q, k, v, mask, out, lse, do, heads=hl, gate_logits=gt, **kw, **o)
        part = lambda t, h0, hl: t[..., h0 * dh:(h0 + hl) * dh]
    else:
        gate = None
        fwd = lambda q, k, v, gt, hl, **o: fa.flash_attention(q, k, v, mask, return_lse=True,
                                                              **kw, **o)
        bwd = lambda q, k, v, gt, out, lse, do, hl, **o: fa.flash_attention_backward(
            q, k, v, mask, out, lse, do, **kw, **o)
        part = lambda t, h0, hl: t[:, h0:h0 + hl]
    out, lse = fwd(q, k, v, gate, heads)
    grads = bwd(q, k, v, gate, out, lse, do, heads)
    for T in (2, 4):
        hl = heads // T
        for h0 in range(0, heads, hl):
            gate_r = gate[..., h0:h0 + hl].contiguous() if gate is not None else None
            args = [part(t, h0, hl) for t in (q, k, v)]
            o2, l2 = fwd(*args, gate_r, hl, hash_h0=h0, hash_heads=heads)
            g2 = bwd(*args, gate_r, o2, l2, part(do, h0, hl), hl, hash_h0=h0, hash_heads=heads)
            assert torch.equal(o2, part(out, h0, hl))
            assert torch.equal(l2, lse.view(b, heads, n)[:, h0:h0 + hl].reshape(b * hl, n))
            assert torch.equal(g2[1], part(grads[1], h0, hl))
            assert torch.equal(g2[2], part(grads[2], h0, hl))
            ref_dq = part(grads[0], h0, hl).float()
            torch.testing.assert_close(g2[0].float(), ref_dq, rtol=TOL[dtype]['rtol'],
                                       atol=1e-4 * float(grads[0].abs().max()))
            if gate is not None:
                assert torch.equal(g2[3], grads[3][..., h0:h0 + hl])
            if h0:
                assert not torch.equal(fwd(*args, gate_r, hl, hash_heads=heads)[0],
                                       part(out, h0, hl))
    if layout == 'bhnd':
        h0, hl = heads // 2, heads // 2
        zeros = torch.zeros(b, hl, n, dh, device=dev, dtype=dtype)
        eye = torch.eye(n, dh, device=dev, dtype=dtype).expand(b, hl, n, dh).contiguous()
        keep = fa.dropout_keep_mask(seed, b * hl, n, rate, device=dev, hash_b0=b0, heads=hl,
                                    hash_h0=h0, hash_heads=heads).view(b, hl, n, n)
        o3 = fwd(zeros, zeros, eye, None, hl, hash_h0=h0, hash_heads=heads)[0]
        assert torch.equal(o3 > 0, keep[..., :dh])


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('layout', ['packed', 'bhnd'])
def test_flash_hash_row_col_offsets(dev, layout, dtype):
    """``hash_r0`` / ``hash_c0``: K1 / K2 (packed, heads of 64) and K8 / K9
    (heads of 72) launched on one block of a ring, rows [r0, r0 + 64) against
    keys [c0, c0 + 64), draw `dropout_keep_mask`'s bits at those offsets (q =
    k = 0, v the identity: a kept key's column is positive), and K2's dv of
    that block is the keep mask's column sums; at offsets 0 they differ. At
    the default offsets a launch is the one of before (the keep bits of
    rows and columns from 0)."""
    b, heads, nl, rate, seed, b0 = 2, 2, 64, 0.1, 321, 3
    dh = 64 if layout == 'packed' else 72
    zeros = torch.zeros(b, heads, nl, dh, device=dev, dtype=dtype)
    eye = torch.eye(nl, dh, device=dev, dtype=dtype).expand(b, heads, nl, dh).contiguous()
    to_packed = lambda t: t.transpose(1, 2).reshape(b, nl, heads * dh).contiguous()
    kw = dict(softclamp_value=50.0, dropout_rate=rate, dropout_seed=seed, hash_b0=b0)

    def launch(**o):
        if layout == 'packed':
            out = fa.flash_attention_packed(to_packed(zeros), to_packed(zeros), to_packed(eye),
                                            heads=heads, **kw, **o)
            return out.view(b, nl, heads, dh).transpose(1, 2)
        return fa.flash_attention(zeros, zeros, eye, **kw, **o)
    for r0, c0 in ((0, 0), (128, 64), (64, 192), (192, 0)):
        keep = fa.dropout_keep_mask(seed, b * heads, nl, rate, device=dev, hash_b0=b0,
                                    heads=heads, hash_r0=r0, hash_c0=c0).view(b, heads, nl, nl)
        got = launch(hash_r0=r0, hash_c0=c0)
        assert torch.equal(got > 0, keep[..., :dh] if dh <= nl else
                           torch.nn.functional.pad(keep, (0, dh - nl)))
        if r0 or c0:
            assert not torch.equal(launch() > 0, got > 0)
    # K2 / K9 at the block's offsets: with p uniform, dv = keep^T do / (1 - rate) / nl
    r0, c0 = 64, 128
    keep = fa.dropout_keep_mask(seed, b * heads, nl, rate, device=dev, hash_b0=b0, heads=heads,
                                hash_r0=r0, hash_c0=c0).view(b, heads, nl, nl)
    ones = torch.ones(b, heads, nl, dh, device=dev, dtype=dtype)
    lse = torch.full((b * heads, nl), math.log(nl), device=dev)
    if layout == 'packed':
        out = to_packed(torch.zeros_like(ones))
        dv = fa.flash_attention_packed_backward(
            to_packed(zeros), to_packed(zeros), to_packed(eye), None, out, lse, to_packed(ones),
            heads=heads, hash_r0=r0, hash_c0=c0, **kw)[2].view(b, nl, heads, dh).transpose(1, 2)
    else:
        dv = fa.flash_attention_backward(zeros, zeros, eye, None, torch.zeros_like(ones), lse,
                                         ones, hash_r0=r0, hash_c0=c0, **kw)[2]
    want = keep.float().sum(2)[..., None].expand(b, heads, nl, dh) / (1 - rate) / nl
    torch.testing.assert_close(dv.float(), want, **TOL[dtype])


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('dh', [64, 72])
@pytest.mark.parametrize('P', [2, 4])
def test_ring_matches_one_launch(dev, P, dh, dtype):
    """`parallel.sp.ring_attention` on a `Loopback` of P shards (K1 / K2 or
    K8 / K9 a block, K10 or a sum for delta) against one launch over the
    whole sequence: a ragged mask with wholly masked shards, softclamp 50,
    dropout 0.1; out and the grads within the kernels' limits."""
    from e2_tts_tpu_torch.parallel import sp
    g = torch.Generator(device=dev).manual_seed(9)
    b, heads, n = 2, 4, 256
    D = heads * dh
    q, k, v, do = (torch.randn(b, n, D, generator=g, device=dev).to(dtype) for _ in range(4))
    mask = torch.ones(b, n, dtype=torch.bool, device=dev)
    mask[1, 50:] = False
    kw = dict(heads=heads, softclamp_value=50.0, dropout_rate=0.1, dropout_seed=77, hash_b0=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sp.ring_attention(*leaves, mask, mesh=sp.Loopback(P), **kw)
    if dh in fa.SUPPORTED_DIM_HEAD:
        ref = fa.flash_attention_packed(*refs, mask, **kw)
    else:
        to = lambda t: t.unflatten(-1, (heads, dh)).transpose(1, 2)
        ref = fa.flash_attention(*(to(t) for t in refs), mask,
                                 **{x: y for x, y in kw.items() if x != 'heads'})
        ref = ref.transpose(1, 2).reshape(b, n, D)
    _close(out, ref, dtype)
    out.backward(do)
    ref.backward(do)
    _close_grads([t.grad for t in leaves], [t.grad for t in refs], dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('inner', [1408, 2752, 3072])
def test_geglu_column_fold(dev, dtype, inner):
    """K6 / K7 on a tensor-parallel rank's value and gate columns [c0, c0 +
    I/T) (T = 2 and 4) under ``fold_column_offset(seed, c0)`` (rows from
    b0 = 3 folded too) give those columns of one launch over all I, bit for
    bit; unfolded they do not."""
    from e2_tts_tpu_torch.ops.dropout import fold_batch_offset, fold_column_offset
    g = torch.Generator(device=dev).manual_seed(6)
    b, n, rate, seed = 4, 96, 0.1, 1234
    h2 = torch.randn(b, n, 2 * inner, generator=g, device=dev).to(dtype)
    gout = torch.randn(b, n, inner, generator=g, device=dev).to(dtype)
    act = gk.geglu_dropout(h2[3:], fold_batch_offset(seed, 3), rate)
    grad = gk.geglu_dropout_backward(h2[3:], gout[3:], fold_batch_offset(seed, 3), rate)
    whole_act = gk.geglu_dropout(h2, seed, rate)[3:]
    assert torch.equal(act, whole_act)
    for T in (2, 4):
        c = inner // T
        for c0 in range(0, inner, c):
            cols = lambda t: torch.cat((t[..., c0:c0 + c], t[..., inner + c0:inner + c0 + c]),
                                       -1).contiguous()
            folded = fold_column_offset(fold_batch_offset(seed, 3), c0)
            assert torch.equal(gk.geglu_dropout(cols(h2[3:]), folded, rate),
                               act[..., c0:c0 + c])
            assert torch.equal(gk.geglu_dropout_backward(
                cols(h2[3:]), gout[3:, :, c0:c0 + c].contiguous(), folded, rate), cols(grad))
            if c0:
                assert not torch.equal(gk.geglu_dropout(cols(h2[3:]), fold_batch_offset(seed, 3),
                                                        rate), act[..., c0:c0 + c])
