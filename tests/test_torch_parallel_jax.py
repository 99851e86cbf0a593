"""The port's two-rank training step against the JAX package's train step
jitted over a two-device mesh: the parallel slice held as a whole.

The model is tests/torch_parallel_ranks.py's small HyperSeg-M (B1, narrow
decoder levels, two of them k=3) at batch 4, 128x128, float32, drop connect
and dropout at 0 (the two packages draw their masks from different
generators). Both sides start from the port's seed-0 weights, perturbed
with numpy's RandomState(0) so that the zero-initialized head does not make
the logits 0, and carried to JAX by core/convert.py. The JAX step is
`make_train_step` jitted on a `make_mesh(n_data=2)` of the conftest's
virtual CPU devices, the parameters replicated and the batch
`data_sharded`, so GSPMD reduces the BN statistics, the loss and the
gradients over the global batch; the port's step runs on two gloo ranks of
one image pair each. Held: the loss within 1e-4 relative, and the updated
parameters and the running statistics within rel L2 1e-3 (docs/PARITY.md's
conditioning: one Adam step from random weights turns float32 summation
order into sign flips of the smallest gradients' updates).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperseg_torch.core.convert import jax_to_torch_state_dict, torch_to_jax_params
from hyperseg_torch.parallel import distributed as D

import torch_parallel_ranks as R

LOSS_RTOL = 1e-4
REL_L2 = 1e-3
LR = 1e-3


def rel_l2(got, want, keys):
    num = sum(float(np.square(np.asarray(got[k], np.float64) - want[k]).sum()) for k in keys)
    return (num / sum(float(np.square(np.asarray(want[k], np.float64)).sum())
                      for k in keys)) ** 0.5


@pytest.fixture(scope="module")
def runs():
    from hyperseg_tpu.models import hyperseg_v1_0 as JV
    from hyperseg_tpu.parallel import data_sharded, make_mesh, replicate_params
    from hyperseg_tpu.train import losses as JL
    from hyperseg_tpu.train import schedule as JS
    from hyperseg_tpu.train import step as JT
    from hyperseg_torch.models import hyperseg_v1_0

    tm = hyperseg_v1_0.hyperseg_efficientnet("efficientnet-b1", device="cpu", seed=0, train=True,
                                             **R.STEP_KW)
    rs = np.random.RandomState(0)
    params = {k: v + (rs.randn(*v.shape) * 0.05).astype(np.float32)
              for k, v in torch_to_jax_params(tm.state_dict()).items()}
    img, lbl = R.step_batch()

    jm = JV.hyperseg_efficientnet("efficientnet-b1", **R.STEP_KW)
    jm.backbone.drop_connect_rate = jm.backbone.dropout_rate = 0.0
    mesh = make_mesh(n_data=2)
    optimizer = JT.make_optimizer(JS.poly_lr(LR, 100))
    step = jax.jit(JT.make_train_step(jm, JL.BootstrappedCrossEntropyLoss(ignore_index=255),
                                      optimizer, num_classes=R.STEP_KW["num_classes"]))
    state = JT.init_train_state(replicate_params(mesh, {k: jnp.asarray(v)
                                                        for k, v in params.items()}),
                                optimizer)
    batch = {"image": jax.device_put(jnp.asarray(img.transpose(0, 2, 3, 1)), data_sharded(mesh)),
             "label": jax.device_put(jnp.asarray(lbl, jnp.int32), data_sharded(mesh))}
    t0 = time.perf_counter()
    compiled = step.lower(state, batch, jax.random.PRNGKey(0)).compile()
    compile_s = time.perf_counter() - t0
    print(f"JAX train step on a 2-device mesh: compiled in {compile_s:.1f} s")
    new_state, metrics = compiled(state, batch, jax.random.PRNGKey(0))
    jax_out = dict(loss=float(metrics["loss"]),
                   state={k: np.asarray(v) for k, v in
                          jax_to_torch_state_dict(new_state["params"]).items()},
                   confmat=np.asarray(metrics["confmat"]))

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port = D.run_ranks(R.train_step, ["cpu", "cpu"], kwargs=dict(
            state={k: v.numpy() for k, v in jax_to_torch_state_dict(params).items()},
            img=img, lbl=lbl, dtype="float32", drop=False, lr=LR))
    finally:
        torch.set_num_threads(threads)
    start = {k: v.numpy() for k, v in jax_to_torch_state_dict(params).items()}
    return jax_out, port, start


def test_loss_matches_jax(runs):
    jx, port, _ = runs
    assert jx["loss"] > 0.1
    assert abs(port["loss"] - jx["loss"]) <= LOSS_RTOL * abs(jx["loss"]), (port["loss"], jx["loss"])


@pytest.mark.parametrize("group", ["params", "running_stats"])
def test_state_after_the_step_matches_jax(runs, group):
    jx, port, start = runs
    stats = [k for k in jx["state"] if k.endswith(("running_mean", "running_var"))]
    keys = stats if group == "running_stats" else [k for k in jx["state"] if k not in stats]
    got = {k: port["state"][k].numpy() for k in keys}
    moved = rel_l2(jx["state"], start, keys)
    err = rel_l2(got, jx["state"], keys)
    print(f"{group}: rel L2 against JAX {err:.3e}, the step moved them by {moved:.3e}")
    assert moved > 10 * err and err <= REL_L2, (err, moved)


def test_confusion_matrix_matches_jax(runs):
    """The step's matrix summed over the ranks counts the global batch and
    agrees with JAX's but at near-tied logits."""
    jx, port, _ = runs
    got = port["confmat"].numpy()
    n = int((R.step_batch()[1] != 255).sum())
    assert got.sum() == jx["confmat"].sum() == n
    assert np.abs(got - jx["confmat"]).sum() <= 2 * 1e-4 * n
