"""`forward_pyramid` under spatial sharding on the CPU, held against one
process in float64.

The tiny v1_0 model of tests/test_parallel.py:12-20, its weight mapper of one
level (R.PYRAMID_KW: the 32-row level's head feature is 1x1), with hflip on, over a
three-level `create_pyramid` of a (2, 3, 128, 128) image, each level this
rank's band (`shard_batch` with data_sharded(mesh, spatial_dim=2)), on a 1x2
mesh of gloo ranks spawned by `parallel.distributed.run_ranks`
(tests/torch_spatial_ranks.py `pyramid`): levels of 64 and 32 rows a band
run on the bands, their logits resized to level 0's band by K6's band form;
the third, of 16 rows a band, is not a multiple of 32 and runs whole on
every rank (gathered, run and resized to the whole first level, the band's
rows kept). Each gather ("mean", "max") within 1e-10 of one process's
forward_pyramid.
"""

import numpy as np
import pytest
import torch

from hyperseg_torch.parallel import distributed as D

import torch_spatial_ranks as R

FORWARD = 1e-10     # the model's forward, float64
GATHERS = ("mean", "max")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """This process on 2 threads, the module's fixtures included: run_ranks
    then gives each of two ranks one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    kw = dict(state=R.tiny_state("v1_0", kw=R.PYRAMID_KW),
              img=np.random.RandomState(3).rand(2, 3, 128, 128) * 2 - 1)
    return R.pyramid("cpu", **kw), D.run_ranks(R.pyramid, ["cpu"] * 2,
                                               kwargs=dict(kw, n_spatial=2))


def test_levels_on_bands_and_whole(runs):
    one, got = runs
    assert [s[2] for s in one["bands"]] == [128, 64, 32]
    assert [s[2] for s in got["bands"]] == [64, 32, 16]
    for gather in GATHERS:
        assert one[f"{gather} whole levels"] == {}
        assert got[f"{gather} whole levels"] == {2: 1}


@pytest.mark.parametrize("gather", GATHERS)
def test_forward_pyramid_equals_one_process(runs, gather):
    one, got = runs
    want, have = one[gather], got[gather]
    assert have.shape == want.shape == (2, 5, 128, 128)
    assert float(want.abs().max()) > 0.05
    err = float((have - want).abs().max())
    assert err <= FORWARD * float(want.abs().max()), err
