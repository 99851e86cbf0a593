"""What the ranks of tests/test_torch_parallel*.py run: module-level functions
that `hyperseg_torch.parallel.distributed.run_ranks` spawns, one process a
rank over gloo on the CPU, and that the tests also call in their own process
for the one-process reference. This module imports neither JAX nor the JAX
package, so a spawned rank stays light; it is not collected itself.

Each function takes `device` (run_ranks passes the rank's), computes on its
rank's rows of a global batch made from a seed, and returns numpy or torch
values that rank 0 hands back; a value spread over the ranks' rows comes
back whole through `gathered` (each rank writes its rows into zeros, and an
all-reduce sums them), so every collective is an all-reduce.
"""

import numpy as np
import torch
import torch.distributed as dist

from hyperseg_torch.nn import functional as F
from hyperseg_torch.parallel import distributed as D

# The step's model: HyperSeg-M's factory and B1 backbone with narrow decoder
# levels, two of them k=3 (on the full-map route their bn1 runs batch_norm_multi)
STEP_KW = dict(levels=2, kernel_sizes=[1, 1, 1, 3, 3], level_channels=[16, 8, 8, 8, 8],
               expand_ratio=2, weight_groups=[8, 8, 8, 8, 4], num_classes=4)
STEP_BATCH, STEP_RES = 4, 128
DROP_CONNECT = 0.3
DROPOUT = 0.3


def rows(t):
    """This rank's rows of a global batch."""
    b = t.shape[0] // D.get_world_size()
    return t[D.get_rank() * b:(D.get_rank() + 1) * b]


def gathered(t):
    """The global batch of which `t` holds this rank's rows."""
    if not dist.is_initialized():
        return t.detach().clone()
    b = t.shape[0]
    full = torch.zeros((b * D.get_world_size(), *t.shape[1:]), dtype=t.dtype)
    full[D.get_rank() * b:(D.get_rank() + 1) * b] = t.detach()
    dist.all_reduce(full)
    return full


def summed(t):
    """`t` summed over the ranks."""
    return D.all_reduce_(t.detach().clone())


def _group():
    return F.data_parallel(dist.group.WORLD) if dist.is_initialized() else _null()


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def bn_train(device, *, x, dy, weight, bias, mean, var, channel_dim, momentum=0.1):
    """batch_norm_train of the rank's rows of x under the group (plainly
    without one), and its backward on the rank's rows of dy: the output and
    grad x whole, grad weight and bias summed, the running statistics."""
    x = rows(torch.from_numpy(x)).requires_grad_()
    w = torch.from_numpy(weight).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    with _group():
        y = F.batch_norm_train(x, w, b, rm, rv, momentum=momentum, channel_dim=channel_dim)
        (y * rows(torch.from_numpy(dy))).sum().backward()
    return dict(y=gathered(y), dx=gathered(x.grad), dw=summed(w.grad), db=summed(b.grad),
                mean=rm, var=rv)


def bn_multi(device, *, parts, dys, weight, bias, mean, var, momentum=0.1):
    """batch_norm_multi of the rank's rows of each part, as bn_train."""
    xs = [rows(torch.from_numpy(p)).requires_grad_() for p in parts]
    w = torch.from_numpy(weight).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    with _group():
        ys = F.batch_norm_multi(xs, w, b, rm, rv, momentum=momentum)
        sum((y * rows(torch.from_numpy(d))).sum() for y, d in zip(ys, dys)).backward()
    return dict(y=[gathered(y) for y in ys], dx=[gathered(x.grad) for x in xs],
                dw=summed(w.grad), db=summed(b.grad), mean=rm, var=rv)


def ce_loss(device, *, logits, labels, weight=None):
    """cross_entropy_loss of the rank's rows in a data-parallel step: the
    ranks' mean loss and the gradient of that mean (what DDP's averaged
    gradient follows) with respect to the logits, whole."""
    from hyperseg_torch.train import losses as L
    x = rows(torch.from_numpy(logits)).requires_grad_()
    w = None if weight is None else torch.from_numpy(weight)
    with _group():
        loss = L.cross_entropy_loss(x, rows(torch.from_numpy(labels)), weight=w)
    (loss / D.get_world_size()).backward()
    return dict(loss=float(summed(loss)) / D.get_world_size(), dlogits=gathered(x.grad))


def confmat_sum(device, *, mats):
    """reduce_across_devices of this rank's matrix."""
    from hyperseg_torch.utils.seg_utils import ConfusionMatrix
    mat = torch.from_numpy(mats[D.get_rank()].copy())
    out = ConfusionMatrix.reduce_across_devices(mat)
    return dict(same_object=out is mat, mat=mat)


def step_batch(seed=0, b=STEP_BATCH, res=STEP_RES, num_classes=STEP_KW["num_classes"]):
    """The global batch: an image in [-1, 1) and labels with a band of 255."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(b, 3, res, res) * 2 - 1).astype(np.float32)
    lbl = rng.randint(0, num_classes, (b, res, res)).astype(np.int64)
    lbl[:, :8] = 255
    return img, lbl


def train_step(device, *, route="gather", **kw):
    """_train_step on a training route (ops/patch.py ROUTES: "fullmap" runs
    the k=3 units' bn1 as batch_norm_multi), the levers restored after."""
    from hyperseg_torch.ops import patch as P
    saved = {k: getattr(P, k) for k in P.ROUTES[route]}
    for k, v in P.ROUTES[route].items():
        setattr(P, k, v)
    try:
        return _train_step(device, **kw)
    finally:
        for k, v in saved.items():
            setattr(P, k, v)


def _train_step(device, *, state, img, lbl, dtype="float64", remat=False, drop=True,
                criterion="bootstrapped", lr=1e-3):
    """One training step of the STEP_KW model from `state` (a state dict,
    numpy) on the rank's rows of the global batch (img NCHW, lbl), in
    DistributedDataParallel under a group (the model as it is without one),
    the generator seeded 5 on every rank, Adam under PolyLR(lr, 100).
    Returns the global loss (the ranks' mean), the state dict after the
    step, the generator's state after it, the shapes of the dropout masks
    drawn and the step's confusion matrix summed over the ranks."""
    from hyperseg_torch.models import hyperseg_v1_0
    from hyperseg_torch.train import losses as L
    from hyperseg_torch.train import schedule as S
    from hyperseg_torch.train import step as T
    dtype = getattr(torch, dtype)
    model = hyperseg_v1_0.hyperseg_efficientnet("efficientnet-b1", device="cpu", train=True,
                                                decoder_remat=remat, **STEP_KW)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    model.to(dtype)
    model.backbone.drop_connect_rate = DROP_CONNECT if drop else 0.0
    model.backbone.dropout_rate = DROPOUT if drop else 0.0
    net = D.wrap_model(model, device) if dist.is_initialized() else model
    opt, sched = T.make_optimizer(model.parameters(), S.poly_lr(lr, 100))
    crit = (L.BootstrappedCrossEntropyLoss(ignore_index=255) if criterion == "bootstrapped"
            else lambda x, y: L.cross_entropy_loss(x, y, ignore_index=255))
    step = T.make_train_step(net, crit, opt, sched, num_classes=STEP_KW["num_classes"])
    masks, keep_mask = [], F._keep_mask

    def spy(shape, keep, generator, like):
        masks.append(tuple(shape))
        return keep_mask(shape, keep, generator, like)
    F._keep_mask = spy
    try:
        gen = torch.Generator().manual_seed(5)
        out = step(rows(torch.from_numpy(img)).to(dtype), rows(torch.from_numpy(lbl)), gen)
    finally:
        F._keep_mask = keep_mask
    return dict(loss=float(summed(out["loss"])) / D.get_world_size(),
                state={k: v.detach().clone() for k, v in model.state_dict().items()},
                generator=gen.get_state(), masks=masks,
                confmat=summed(out["confmat"]))


def numerics(device):
    """The rank's TF32 and cuDNN settings."""
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
