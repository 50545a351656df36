"""K1 / K2 across a few tokens (the frequency attention's sequences), the
port against the JAX package on the CPU.

On the card, sequences of at most N_SHORT tokens run the few-token design
of K1 / K2 (csrc/flash_attention_short.cuh), held there to the same plain
versions these tests hold to JAX. Here the port's wrappers run those plain
versions (CPU tensors); the JAX side runs its packed Pallas kernel in
interpret mode, as its own tests run it (the JAX package would send such
short sequences to XLA on a TPU, whose dropout draws other bits).

- Kernel level, f in {1, 3, 5, 16}: a ragged key mask, softclamp 50, the
  gate and dropout 0.1: out, lse and the q / k / v / gate grads.
- The dropout hash's offsets, which JAX's kernel does not take: hash_b0 /
  hash_h0 as a launch on some rows and heads against those rows and heads of
  JAX's launch over all of them, hash_r0 / hash_c0 through the ring
  (`sp.Loopback`, blocks of a few tokens) against JAX's one launch.
- Model level: E2TTS with num_freq_tokens=3 (its Transformer with the
  frequency axis at an odd f), its loss and every grad with dropout 0.1
  (tests/_torch_options_helpers.py, one JAX compile).

Tolerances: all f32; outputs and lse 1e-5 absolute and relative (summation
order and tanh / exp implementations, as tests/test_torch_kernels.py);
grads 1e-5 relative plus 1e-5 of each grad's largest |ref| (sums over rows
and heads). At f = 1 a softmax over one key has no logit gradient: dq and
dk are rounding alone on both sides and take 1e-5 of the largest |ref| of
all the grads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e2_tts_tpu.ops.flash_attention as jfa

import _torch_options_helpers as helpers
from e2_tts_tpu_torch.ops import flash_attention as fa
from e2_tts_tpu_torch.parallel import sp

settings = pytest.fixture(scope='module', autouse=True)(helpers.cpu_test_settings)

HEADS, DH = 4, 32                # the JAX packed kernel's lane tiles: heads * dh = 128
PAD = 128                        # its smallest sequence tile
SEED, RATE = 1234, 0.1


def _inputs(b, f, seed):
    rng = np.random.default_rng(seed)
    D = HEADS * DH
    q, k, v, dout = (rng.standard_normal((b, f, D)).astype(np.float32) for _ in range(4))
    lens = rng.integers(min(2, f), f + 1, b)    # one key would leave dq, dk rounding alone
    lens[0] = f
    mask = np.arange(f)[None] < lens[:, None]
    gate = (2 * rng.standard_normal((b, f, HEADS))).astype(np.float32)
    return q, k, v, mask, gate, dout


def _jax(q, k, v, mask, gate, dout, rate=RATE):
    """JAX's out, lse (b*h, n) and the q, k, v, gate grads for ``dout``, from
    its Pallas kernels on the sequence padded to 128 tokens: the pad keys
    masked (probability 0) and the pad rows' output grads 0 (they add
    nothing to dk, dv), rows and keys below n drawing the same dropout bits.
    Below 128 tokens its backward reads the tile's ragged tail uninitialized
    in interpret mode (NaN dk / dv; the JAX package sends such sequences to
    XLA)."""
    b, f, _ = q.shape
    pad = lambda a: np.concatenate([a, np.zeros((b, PAD - f, *a.shape[2:]), a.dtype)], 1)
    j = lambda a: jnp.asarray(pad(a))
    kw = dict(heads=HEADS, softclamp_value=50.0, dropout_rate=rate,
              dropout_seed=SEED if rate else None)
    fn = lambda q, k, v, g: jfa.flash_attention_packed(q, k, v, j(mask), gate_logits=g, **kw)
    out, vjp = jax.vjp(fn, j(q), j(k), j(v), j(gate))
    bias = jnp.where(j(mask), 0.0, jfa.NEG_INF).astype(jnp.float32)
    _, lse = jfa._flash_packed_forward(j(q), j(k), j(v), bias,
                                       jnp.full((1,), SEED if rate else 0, jnp.int32), HEADS,
                                       DH ** -0.5, 50.0, rate)
    return [np.asarray(t)[:, :f] for t in (out, lse[..., 0].reshape(b * HEADS, PAD),
                                           *vjp(j(dout)))]


def _port(q, k, v, mask, gate, dout, rate=RATE, **hash_kw):
    """The port's (plain) out, lse and the q, k, v, gate grads."""
    leaves = [torch.from_numpy(t.copy()).requires_grad_() for t in (q, k, v, gate)]
    out, lse = fa.flash_attention_packed(
        *leaves[:3], torch.from_numpy(mask), heads=HEADS, softclamp_value=50.0,
        dropout_rate=rate, dropout_seed=SEED, gate_logits=leaves[3], return_lse=True,
        **hash_kw)
    out.backward(torch.from_numpy(dout))
    return [t.detach().numpy() for t in (out, lse, *(x.grad for x in leaves))]


def _assert_match(got, want, one_key=False):
    """out and lse at 1e-5; each grad at 1e-5 relative plus 1e-5 of its
    largest |ref| (with ``one_key``, dq and dk: of the largest |ref| of all
    grads)."""
    for name, g, w in zip(('out', 'lse'), got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)
    joint = max(float(np.abs(w).max()) for w in want[2:])
    for name, g, w in zip(('dq', 'dk', 'dv', 'dgate'), got[2:], want[2:]):
        scale = joint if one_key and name in ('dq', 'dk') else float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale + 1e-12, err_msg=name)


@pytest.mark.parametrize('f', [1, 3, 5, 16])
def test_few_tokens_match_jax(f):
    """The plain K1 / K2 at f tokens, every feature on, against JAX's
    Pallas kernel: out, lse and every grad."""
    ins = _inputs(7, f, seed=f)
    _assert_match(_port(*ins), _jax(*ins), one_key=f == 1)


def test_few_tokens_without_dropout_match_jax():
    """f = 3 without dropout (the frequency attention's own setting)."""
    ins = _inputs(5, 3, seed=30)
    _assert_match(_port(*ins, rate=0.0), _jax(*ins, rate=0.0))


@pytest.mark.parametrize('f', [3, 5])
def test_batch_and_head_offsets_match_jax(f):
    """A launch on rows [2, 5) and heads [1, 3) of 4 with hash_b0 = 2,
    hash_h0 = 1, hash_heads = 4 gives those rows and heads of JAX's launch
    over all of them: its dropout bits are the global rows' and heads'."""
    q, k, v, mask, gate, dout = _inputs(5, f, seed=40 + f)
    b0, h0, h = 2, 1, 2
    cols = slice(h0 * DH, (h0 + h) * DH)
    part = lambda t: t[b0:, :, cols]
    want = _jax(q, k, v, mask, gate, dout)
    leaves = [torch.from_numpy(part(t).copy()).requires_grad_() for t in (q, k, v)]
    g = torch.from_numpy(gate[b0:, :, h0:h0 + h].copy()).requires_grad_()
    out, lse = fa.flash_attention_packed(
        *leaves, torch.from_numpy(mask[b0:]), heads=h, softclamp_value=50.0, dropout_rate=RATE,
        dropout_seed=SEED, gate_logits=g, return_lse=True, hash_b0=b0, hash_h0=h0,
        hash_heads=HEADS)
    out.backward(torch.from_numpy(part(dout).copy()))
    lse_rows = want[1].reshape(5, HEADS, f)[b0:, h0:h0 + h].reshape(-1, f)
    got = [t.detach().numpy() for t in (out, lse, *(x.grad for x in leaves), g.grad)]
    _assert_match(got, [part(want[0]), lse_rows, *map(part, want[2:5]),
                        want[5][b0:, :, h0:h0 + h]])
    # at offset 0 the port draws other bits
    other = fa.flash_attention_packed(*(x.detach() for x in leaves), torch.from_numpy(mask[b0:]),
                                      heads=h, softclamp_value=50.0, dropout_rate=RATE,
                                      dropout_seed=SEED, gate_logits=g.detach())
    assert np.abs(other.numpy() - part(want[0])).max() > 1e-2


@pytest.mark.parametrize('f,P', [(6, 2), (16, 4)])
def test_ring_blocks_match_jax(f, P):
    """The ring over P shards of f / P tokens (K1 / K2 blocks at their
    hash_r0 / hash_c0, combined by lse) against JAX's one launch over the f
    tokens, dropout 0.1: out and the q, k, v grads."""
    q, k, v, mask, gate, dout = _inputs(3, f, seed=60 + f)
    mask[1, f // P:] = False                      # wholly masked shards
    ones = np.full_like(gate, 30.0)               # sigmoid(30) = 1 in f32: no gate
    want = _jax(q, k, v, mask, ones, dout)
    leaves = [torch.from_numpy(t.copy()).requires_grad_() for t in (q, k, v)]
    out = sp.ring_attention(*leaves, torch.from_numpy(mask), mesh=sp.Loopback(P), heads=HEADS,
                            softclamp_value=50.0, dropout_rate=RATE, dropout_seed=SEED)
    out.backward(torch.from_numpy(dout))
    got = [out.detach().numpy(), want[1], *(x.grad.numpy() for x in leaves), want[5]]
    _assert_match(got, want)


def test_odd_freq_tokens_loss_and_every_grad_match_jax(monkeypatch):
    """E2TTS with num_freq_tokens=3: the Transformer with the frequency axis
    at an odd f, its loss, prediction and every grad against JAX's with
    dropout 0.1 (tests/_torch_options_helpers.py)."""
    monkeypatch.setitem(helpers.OPTIONS, 'freq_f3', (dict(num_freq_tokens=3), dict()))
    j, p = helpers.check_loss_and_grads('freq_f3', monkeypatch)
    assert p.transformer.has_freq_axis and p.num_freq_tokens == 3
