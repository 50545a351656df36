"""``Transformer(scan_layers=True)``: the port against the JAX package's scan
backbone at depths 6 and 8 (two real scan groups each), its state dict
against the unrolled model's, the recompute of the scanned groups, and the
weight bridge's refusals. The shallow-text plans are held in
tests/test_torch_scan_text_depth.py, the dropout path, the sampler and the
training state in tests/test_torch_scan_dropout.py and
tests/test_torch_scan_e2tts.py. Tolerances: tests/_torch_scan_helpers.py;
against the port's unrolled model on the CPU, equal (a recompute runs the
same CPU ops on the same inputs).
"""

import numpy as np
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models.transformer import Transformer as JaxTransformer

from _torch_port_helpers import flat_state
from _torch_scan_helpers import (SCAN_CFG, build_pair, check_backbone, inputs,
                                 one_torch_thread, port_value_and_grads)
from e2_tts_tpu_torch.convert import load_jax_params
from e2_tts_tpu_torch.models.transformer import Transformer, scan_plan

settings = pytest.fixture(scope='module', autouse=True)(one_torch_thread)


@pytest.fixture(scope='module', params=[6, 8], ids=['depth6', 'depth8'])
def pair(request):
    return build_pair(request.param, request.param)


def test_scan_backbone_matches_jax(pair):
    """The plan (depth 6: two groups of two; depth 8: two of three), the
    forward, the input grads and every parameter grad."""
    j, p = pair
    assert [kind for kind, *_ in p.scan_plan] == ['scan', 'scan']
    check_backbone(j, p)


def test_scan_bridge_is_strict(pair):
    """A scan-layout tree into a backbone built without ``scan_layers``
    raises naming the flag, so does an unrolled tree into a scan backbone;
    a stacked group whose leading axis is not the plan's count raises."""
    j, p = pair
    depth, tree = p.depth, flat_state(j)
    unrolled_cfg = dict(SCAN_CFG, depth=depth)
    with pytest.raises(ValueError, match='scan_layers=True'):
        load_jax_params(Transformer(**unrolled_cfg, device='cpu'), tree)
    unrolled = flat_state(JaxTransformer(**unrolled_cfg, attn_backend='xla', rngs=nnx.Rngs(2)))
    with pytest.raises(ValueError, match='scan_layers=True'):
        load_jax_params(Transformer(**unrolled_cfg, scan_layers=True, device='cpu'), unrolled)
    key = 'scan_mid.0.speech.ff.proj_in.kernel'
    short = dict(tree, **{key: tree[key][:-1]})
    with pytest.raises(ValueError, match='plan puts'):
        load_jax_params(Transformer(**unrolled_cfg, scan_layers=True, device='cpu'), short)


def test_scan_state_dict_is_unrolled(pair):
    """The scan backbone's state dict has the unrolled model's names: an
    unrolled model's state dict loads strictly, and the forward and every
    grad are the unrolled model's bit for bit on the CPU."""
    _, p = pair
    u = Transformer(**dict(SCAN_CFG, depth=p.depth), device='cpu')
    assert list(u.state_dict()) == list(p.state_dict())
    u.load_state_dict(p.state_dict())
    got, want = port_value_and_grads(p, *inputs(1)), port_value_and_grads(u, *inputs(1))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    for name in want[3]:
        np.testing.assert_array_equal(got[3][name], want[3][name], err_msg=name)


@pytest.mark.parametrize('remat', [False, True])
def test_scan_groups_are_recomputed(remat):
    """Forward pre-hooks count a layer's runs in one forward and backward: every
    layer of a 'scan' segment runs twice (its recompute) whatever ``remat``
    says; the first and last layers and a 'single' segment once without
    remat and twice with it; without grad, every layer once."""
    p = Transformer(**dict(SCAN_CFG, depth=8, text_depth=3), scan_layers=True, remat=remat,
                    device='cpu')
    assert p.scan_plan == [('single', 1, 1, True), ('single', 2, 1, True),
                           ('single', 3, 1, True), ('scan', 4, 3, False)]
    counts = [0] * p.depth
    for ind, layer in enumerate(p.speech_layers):
        layer.register_forward_pre_hook(lambda *_, i=ind: counts.__setitem__(i, counts[i] + 1))
    x, te, times, mask, w = inputs(2)
    port_value_and_grads(p, x, te, times, mask, w)
    want = [2 if remat or ind in (4, 5, 6) else 1 for ind in range(8)]
    assert counts == want
    counts[:] = [0] * p.depth
    with torch.no_grad():
        p(*map(torch.from_numpy, (x,)), times=torch.from_numpy(times),
          text_embed=torch.from_numpy(te))
    assert counts == [1] * 8


def test_scan_plan_rule():
    """The plan's segments tile the middle layers, break at the half and at
    the text boundaries, and scan every run of two or more; depth < 4 and
    an odd depth raise."""
    for depth in range(4, 17, 2):
        for text_depth in range(1, depth + 1):
            plan = scan_plan(depth, text_depth)
            starts = [a for _, a, _, _ in plan]
            assert starts[0] == 1 and sum(c for _, _, c, _ in plan) == depth - 2
            assert all(a + c == b for (_, a, c, _), b in zip(plan, starts[1:] + [depth - 1]))
            for kind, a, count, push in plan:
                assert (kind == 'scan') == (count > 1)
                assert push == (a + count <= depth // 2)
                assert not {depth // 2, text_depth - 1, text_depth} & set(range(a + 1, a + count))
    with pytest.raises(ValueError, match='depth >= 4'):
        Transformer(**dict(SCAN_CFG, depth=2), scan_layers=True, device='cpu')
    with pytest.raises(ValueError, match='even'):
        Transformer(**dict(SCAN_CFG, depth=5), scan_layers=True, device='cpu')
