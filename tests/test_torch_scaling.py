"""``tpusparse_torch.bench.scaling`` at world size 1, in this process (gloo
on the CPU): every kernel and partition runs one point, and the default
counts follow the partitions' divisibility. The sweeps at D = 1, 2 and 4
(tests/test_scaling.py's four) run in the spawned world of
``tests/test_torch_parallel.py``, the program at 2 ranks beside it."""

import pytest

from tpusparse_torch.bench.scaling import _counts, sweep_scaling


@pytest.fixture(scope="module")
def world1():
    import torch.distributed as dist

    from tpusparse_torch.parallel import initialize

    initialize(device="cpu")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("kernel", ["dense", "sell"])
@pytest.mark.parametrize("partition", ["n", "m", "ring"])
def test_world1_point(world1, kernel, partition):
    pts = sweep_scaling(mode="weak", kernel=kernel, partition=partition,
                        base_m=256, base_n=256, reps=2, verbose=False)
    assert [(p.devices, p.m, p.n) for p in pts] == [(1, 256, 256)]
    assert pts[0].seconds > 0 and pts[0].efficiency == 1.0


def test_counts_follow_divisibility():
    assert _counts("weak", "sell", "n", 256, 256, 8) == (1, 2, 4, 8)
    # strong: 256 columns are 2 SELL groups, so at most 2 ranks
    assert _counts("strong", "sell", "n", 256, 256, 8) == (1, 2)
    assert _counts("strong", "dense", "ring", 256, 6, 8) == (1, 2)
    assert _counts("strong", "dense", "m", 512, 256, 4) == (1, 2, 4)


def test_refusals(world1):
    with pytest.raises(ValueError, match="mode"):
        sweep_scaling(mode="diagonal", verbose=False)
    with pytest.raises(ValueError, match="exceed"):
        sweep_scaling(device_counts=(1, 2), base_m=256, base_n=256,
                      verbose=False)
