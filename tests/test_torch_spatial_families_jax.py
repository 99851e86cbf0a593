"""The port's spatially sharded forward of the unify and v0_1 families
against the JAX package's.

The tiny unify and v0_1 models (tests/torch_spatial_ranks.py UNIFY_KW and
V01_KW) at (4, 64, 128), the port on a 1x2 mesh (two gloo ranks, 32 rows
each, one spawn for both) against the unsharded JAX forward, jitted on the
CPU, where its Pallas kernels are not taken (the plain XLA path), float32,
at tests/test_parallel.py's limits (atol 2e-5, rtol 1e-5). Both sides start
from the port's seed-0 weights perturbed with numpy's RandomState(0)
(running variances |v| + 0.5), carried to JAX by core/convert.py. The v0_1
training step against JAX's: tests/test_torch_spatial_v01_jax.py.
"""

import importlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperseg_torch.core.convert import jax_to_torch_state_dict
from hyperseg_torch.parallel import distributed as D

import torch_spatial_ranks as R
from test_torch_spatial_jax import perturbed

ATOL, RTOL = 2e-5, 1e-5          # tests/test_parallel.py:44
FORWARD_FAMILIES = ("unify", "v0_1")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def models(family, kw, backbone="efficientnet-b0", train=False):
    """(the port's model, the JAX model) of `family` with `kw`."""
    module = R.FAMILIES[family][0]
    port = importlib.import_module(f"hyperseg_torch.models.{module}")
    jaxm = importlib.import_module(f"hyperseg_tpu.models.{module}")
    return (port.hyperseg_efficientnet(backbone, device="cpu", train=train, **kw),
            jaxm.hyperseg_efficientnet(backbone, **kw))


@pytest.fixture(scope="module")
def forward_runs():
    x = np.random.RandomState(0).rand(R.TINY_BATCH, *R.TINY_HW, 3).astype(np.float32)
    want, cases = {}, []
    for family in FORWARD_FAMILIES:
        kw = R.FAMILIES[family][1]
        tm, jm = models(family, kw)
        params = {k: (np.abs(v) + 0.5 if k.endswith("running_var") else v)
                  for k, v in perturbed(tm).items()}
        want[family] = np.asarray(jax.jit(lambda p, v, m=jm: m(p, v))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))).transpose(0, 3, 1, 2)
        cases.append(dict(state={k: v.numpy() for k, v in jax_to_torch_state_dict(params).items()},
                          img=x.transpose(0, 3, 1, 2), n_spatial=2, dtype="float32", kw=kw,
                          family=family))
    got = D.run_ranks(R.forwards, ["cpu"] * 2, kwargs=dict(cases=cases))
    return want, dict(zip(FORWARD_FAMILIES, got))


@pytest.mark.parametrize("family", FORWARD_FAMILIES)
def test_forward_on_two_bands_matches_jax(forward_runs, family):
    want, got = forward_runs[0][family], forward_runs[1][family].numpy()
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
