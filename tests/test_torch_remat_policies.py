"""Selective remat: ``Transformer(remat=<name>)`` for each argument-free
policy of ``jax.checkpoint_policies``, against the JAX package's layer
under the same policy on the CPU and against the port without remat; a
name that is no policy raises.

Tolerances (f32): the loss 1e-5 relative and the grads 1e-4 in relative L2
against JAX; against the port without remat: equal, since a recompute
runs the same CPU ops on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models.transformer import Transformer as JaxTransformer

from _torch_options_helpers import flat, cpu_test_settings
from _torch_port_helpers import SMALL_TF, flat_state, perturb
from e2_tts_tpu_torch.convert import load_jax_params, map_jax_tree
from e2_tts_tpu_torch.models.transformer import Transformer

settings = pytest.fixture(scope='module', autouse=True)(cpu_test_settings)

POLICIES = ['nothing_saveable', 'everything_saveable', 'dots_saveable', 'checkpoint_dots',
            'dots_with_no_batch_dims_saveable', 'checkpoint_dots_with_no_batch_dims']
POLICY_TF = dict(SMALL_TF, dropout=0.0)


@pytest.fixture(scope='module')
def policy_case():
    j = perturb(JaxTransformer(**POLICY_TF, attn_backend='xla', rngs=nnx.Rngs(0)), seed=61)
    rng = np.random.default_rng(62)
    x = rng.standard_normal((2, 16, POLICY_TF['dim'])).astype(np.float32)
    text = rng.standard_normal((2, 16, POLICY_TF['dim'] // 2)).astype(np.float32)
    times = np.array([0.2, 0.9], np.float32)

    def port(remat):
        p = Transformer(**POLICY_TF, remat=remat, device='cpu')
        load_jax_params(p, flat_state(j))
        p.train()
        p.zero_grad(set_to_none=True)
        out = p(*map(torch.from_numpy, (x, times)), text_embed=torch.from_numpy(text))
        loss = (out * out).mean()
        loss.backward()
        return float(loss.detach()), {n: t.grad.numpy().copy() for n, t in p.named_parameters()
                                      if t.grad is not None}

    return j, (x, times, text), port, port(False)


@pytest.mark.parametrize('name', POLICIES)
def test_selective_remat_matches_jax_and_remat_off(policy_case, name):
    j, (x, times, text), port, (loss_off, grads_off) = policy_case
    jm = JaxTransformer(**POLICY_TF, attn_backend='xla', remat=name, rngs=nnx.Rngs(0))
    nnx.update(jm, nnx.state(j))

    @nnx.jit
    def jax_loss_and_grads(m, x, times, text):
        def f(m):
            out = m(x, times=times, text_embed=text)
            return (out * out).mean()
        return nnx.value_and_grad(f)(m)

    loss_j, grads_j = jax_loss_and_grads(jm, *map(jnp.asarray, (x, times, text)))
    loss_p, grads_p = port(name)
    assert loss_p == loss_off
    assert grads_p.keys() == grads_off.keys()
    for n in grads_p:
        np.testing.assert_array_equal(grads_p[n], grads_off[n], err_msg=n)
    np.testing.assert_allclose(loss_p, float(loss_j), rtol=1e-5)
    mapped = map_jax_tree(flat(grads_j), {n: v.shape for n, v in grads_off.items()})
    vp = np.concatenate([grads_p[n].ravel() for n in sorted(grads_p)])
    vj = np.concatenate([np.asarray(mapped[n]).ravel() for n in sorted(grads_p)])
    assert np.linalg.norm(vp - vj) <= 1e-4 * np.linalg.norm(vj)


@pytest.mark.parametrize('name', ['save_only_these_names', 'offload_dot_with_no_batch_dims',
                                  'dots_saveble', 'checkpoint_policies'])
def test_remat_name_that_is_no_policy_raises(name):
    """Not a name of jax.checkpoint_policies, or one of its factories (JAX
    takes those and fails at the first grad with a TypeError)."""
    with pytest.raises(ValueError, match='checkpoint_policies'):
        Transformer(**POLICY_TF, remat=name, device='cpu')


