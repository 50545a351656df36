"""Four gloo ranks of the port's data-parallel trainer against its single
device, with dropout, on the CPU (tests/_torch_parallel_worker.py, one
spawn for the file): the configuration and the check of
tests/test_torch_parallel_dropout.py, one row of the ragged batch a rank, so
that every rank's span count and batch offset are its own."""

import numpy as np
import pytest
import torch

from _torch_parallel_worker import Ranks, write_steps
from test_torch_parallel_dropout import CONFIG, TOL, TWO, mismatch, single

WORLD = 4
SHARDINGS = ('replicated', 'fsdp')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('parallel_four')
    torch.set_num_threads(1)
    steps = write_steps(str(tmp / 'two.npz'), TWO)
    ranks = Ranks(WORLD, [dict(kind='steps', sharding=sharding, config=CONFIG, steps=steps,
                               out=str(tmp / sharding)) for sharding in SHARDINGS], tmp)
    try:
        ref = single(TWO)              # while the ranks run
    finally:
        ranks.join()
    port = {s: dict(np.load(tmp / s / 'result.npz')) for s in SHARDINGS}
    ranks = {s: [dict(np.load(tmp / s / f'rank{r}.npz')) for r in range(WORLD)]
             for s in SHARDINGS}
    return dict(ref=ref, port=port, ranks=ranks)


@pytest.mark.parametrize('sharding', SHARDINGS)
def test_four_ranks_match_single_device(runs, sharding):
    """With text, then text dropped: losses and parameters within 1e-6 of
    the single device; the span counts of the four ranks are not all one."""
    counts = {tuple(r['counts']) for r in runs['ranks'][sharding]}
    assert len(counts) > 1
    assert mismatch(runs['port'][sharding], runs['ref']) <= TOL


def test_fsdp_bytes_are_a_quarter(runs):
    """Each of four FSDP ranks holds at most ``torch.chunk``'s piece of every
    sharded parameter, EMA weight and ADOPT moment (under 30% of each), and
    the ranks' pieces add up to the whole (plus the 0-d parameters FSDP2
    leaves whole on every rank)."""
    final = runs['port']['fsdp']
    shapes = [v.shape for k, v in final.items() if k.startswith('final.param.')]
    sharded = [s for s in shapes if len(s)]
    whole = (len(shapes) - len(sharded)) * 4
    total = sum(int(np.prod(s)) for s in sharded) * 4
    bound = sum(-(-s[0] // WORLD) * int(np.prod(s[1:])) for s in sharded) * 4 + whole
    assert bound <= 0.3 * total
    ranks = runs['ranks']['fsdp']
    for rank in ranks:
        assert rank['params'] <= bound and rank['ema'] <= bound and rank['adopt'] <= 2 * bound
    assert sum(r['params'] for r in ranks) == total + WORLD * whole
