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
"""

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
@pytest.mark.parametrize('d', [256, 512])
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


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('inner', [1408, 704])
@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_geglu_kernel(dev, dtype, inner, rate):
    g = torch.Generator(device=dev).manual_seed(2)
    h2 = torch.randn(2, 100, 2 * inner, generator=g, device=dev).to(dtype)
    _close(gk.geglu_dropout(h2, 99, rate), gk.geglu_dropout_plain(h2, 99, rate), dtype)


def _close_grads(out, ref, dtype):
    rtol = TOL[dtype]['rtol']
    for o, r in zip(out, ref):
        o, r = o.float(), r.float()
        assert torch.isfinite(o).all()
        torch.testing.assert_close(o, r, rtol=rtol, atol=rtol * float(r.abs().max()) + 1e-12)


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
@pytest.mark.parametrize('d', [256, 512])
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
@pytest.mark.parametrize('inner', [1408, 704])
@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_geglu_bwd_kernel(dev, dtype, inner, rate):
    g = torch.Generator(device=dev).manual_seed(5)
    h2 = torch.randn(2, 100, 2 * inner, generator=g, device=dev).to(dtype)
    gout = torch.randn(2, 100, inner, generator=g, device=dev).to(dtype)
    before = _cuda.launch_counts['geglu_bwd']
    got = gk.geglu_dropout_backward(h2, gout, 99, rate)
    assert _cuda.launch_counts['geglu_bwd'] == before + 1
    _close(got, gk.geglu_dropout_backward_plain(h2, gout, 99, rate), dtype)


@pytest.mark.parametrize('case', ['prompt', 'power2', 'power0.7', 'win800', 'ragged_b2'])
def test_mel_kernel(dev, case):
    g = torch.Generator(device=dev).manual_seed(6)
    kw = dict(power2=dict(power=2.0), win800=dict(win_length=800),
              **{'power0.7': dict(power=0.7)}).get(case, {})
    spec = MelSpec(mode='pallas', **kw).to(dev)
    b, nw = (2, 300 * 256 + 77) if case == 'ragged_b2' else (1, 72000)
    wave = torch.randn(b, nw, generator=g, device=dev) * 0.1
    frames = frame_signal(wave, 1024, 256, center=True)
    before = _cuda.launch_counts['mel_fwd']
    got = spec(wave)
    assert _cuda.launch_counts['mel_fwd'] == before + 1
    ref = mk.fused_log_mel_plain(frames, spec.dft_cos, spec.dft_sin, spec.fbanks,
                                 spec.power).transpose(1, 2)
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(16, 1056, 8, 64), (3, 333, 4, 32), (2, 65, 2, 128)])
def test_flash_delta_kernel(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(7)
    b, n, h, dh = shape
    o, do = (torch.randn(b, n, h * dh, generator=g, device=dev).to(dtype) for _ in range(2))
    before = _cuda.launch_counts['flash_delta']
    got = fa.flash_delta(o, do, heads=h)
    assert _cuda.launch_counts['flash_delta'] == before + 1
    ref = fa.flash_delta_plain(o, do, h)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


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
    assert all(_cuda.launch_counts[k] > before[k] for k in _cuda.KERNELS)


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
