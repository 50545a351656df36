"""``Transformer(scan_layers=True)`` with a shallow text stream (``text_depth``
1, 2, 3 and 5 of depth 6, the JAX package's own cases in
tests/test_scan_layers.py): plans with 'single' segments at the last text
layer and the text / speech-only boundary, held against the JAX scan
backbone (forward, input grads, every parameter grad). Tolerances:
tests/_torch_scan_helpers.py.
"""

import pytest

from _torch_scan_helpers import build_pair, check_backbone, one_torch_thread

settings = pytest.fixture(scope='module', autouse=True)(one_torch_thread)

PLANS = {1: [('scan', 1, 2, True), ('scan', 3, 2, False)],
         2: [('single', 1, 1, True), ('single', 2, 1, True), ('scan', 3, 2, False)],
         3: [('single', 1, 1, True), ('single', 2, 1, True), ('scan', 3, 2, False)],
         5: [('scan', 1, 2, True), ('single', 3, 1, False), ('single', 4, 1, False)]}


@pytest.mark.parametrize('text_depth', sorted(PLANS))
def test_scan_shallow_text_matches_jax(text_depth):
    j, p = build_pair(6, text_depth, seed=10 + text_depth)
    assert p.scan_plan == PLANS[text_depth]
    assert len(p.text_layers) == text_depth
    check_backbone(j, p)
