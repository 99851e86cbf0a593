"""The port's spatially sharded v0_1 training step against the JAX
package's.

The v0_1 family as tests/torch_train_parity.py trains it (V0_KW, B0) at
batch 4, 128x128, the port on a 2x2 mesh (four gloo ranks: two images'
64-row bands each) against `make_train_step` jitted on a 2x2 mesh of the
conftest's virtual CPU devices, the image `data_sharded(mesh,
spatial_dim=1)` and the label `data_sharded(mesh)`, the bootstrapped CE at
k=64 and thresh 0.3; drop connect and dropout at 0 (the packages draw their
masks from different generators). Both sides start from the port's seed-0
weights perturbed with numpy's RandomState(0), carried to JAX by
core/convert.py, and are held as tests/test_torch_spatial_jax.py holds the
v1_0 step: the loss within 1e-4 relative, the updated parameters and the
running statistics within rel L2 1e-3.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperseg_torch.core.convert import jax_to_torch_state_dict
from hyperseg_torch.parallel import distributed as D

import torch_parallel_ranks as RP
import torch_spatial_ranks as R
from test_torch_spatial_families_jax import models
from test_torch_spatial_jax import perturbed, rel_l2
from torch_train_parity import V0_KW

LOSS_RTOL = 1e-4
REL_L2 = 1e-3
LR = 1e-3
K = 64                           # tests/test_train.py:183


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def step_runs():
    from hyperseg_tpu.parallel import data_sharded, make_mesh, replicate_params
    from hyperseg_tpu.train import losses as JL
    from hyperseg_tpu.train import schedule as JS
    from hyperseg_tpu.train import step as JT

    tm, jm = models("v0_1", V0_KW, train=True)
    params = perturbed(tm)
    img, lbl = RP.step_batch(num_classes=V0_KW["num_classes"])
    jm.backbone.drop_connect_rate = jm.backbone.dropout_rate = 0.0
    mesh = make_mesh(n_data=2, n_spatial=2)
    optimizer = JT.make_optimizer(JS.poly_lr(LR, 100))
    step = jax.jit(JT.make_train_step(
        jm, JL.BootstrappedCrossEntropyLoss(k=K, thresh=0.3, ignore_index=255), optimizer,
        num_classes=V0_KW["num_classes"]))
    state = JT.init_train_state(replicate_params(mesh, {k: jnp.asarray(v)
                                                        for k, v in params.items()}),
                                optimizer)
    batch = {"image": jax.device_put(jnp.asarray(img.transpose(0, 2, 3, 1)),
                                     data_sharded(mesh, spatial_dim=1)),
             "label": jax.device_put(jnp.asarray(lbl, jnp.int32), data_sharded(mesh))}
    t0 = time.perf_counter()
    compiled = step.lower(state, batch, jax.random.PRNGKey(0)).compile()
    print(f"JAX v0_1 train step on a 2x2 mesh: compiled in {time.perf_counter() - t0:.1f} s")
    new_state, metrics = compiled(state, batch, jax.random.PRNGKey(0))
    jax_out = dict(loss=float(metrics["loss"]),
                   state={k: np.asarray(v) for k, v in
                          jax_to_torch_state_dict(new_state["params"]).items()})
    start = {k: v.numpy() for k, v in jax_to_torch_state_dict(params).items()}
    port = D.run_ranks(R.step, ["cpu"] * 4, kwargs=dict(
        state=start, img=img, lbl=lbl, n_data=2, n_spatial=2, dtype="float32", drop=False,
        lr=LR, kw=V0_KW, k=K, family="v0_1"))
    return jax_out, port, start


def test_v01_step_loss_on_a_2x2_mesh_matches_jax(step_runs):
    jx, port, _ = step_runs
    assert jx["loss"] > 0.1
    assert abs(port["loss"] - jx["loss"]) <= LOSS_RTOL * abs(jx["loss"]), (port["loss"], jx["loss"])


@pytest.mark.parametrize("group", ["params", "running_stats"])
def test_v01_step_state_on_a_2x2_mesh_matches_jax(step_runs, group):
    jx, port, start = step_runs
    stats = [k for k in jx["state"] if k.endswith(("running_mean", "running_var"))]
    keys = stats if group == "running_stats" else [k for k in jx["state"] if k not in stats]
    got = {k: port["state"][k].numpy() for k in keys}
    moved = rel_l2(jx["state"], start, keys)
    err = rel_l2(got, jx["state"], keys)
    print(f"{group}: rel L2 against JAX {err:.3e}, the step moved them by {moved:.3e}")
    assert moved > 10 * err and err <= REL_L2, (err, moved)
