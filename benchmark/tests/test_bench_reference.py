"""The plain reference agrees with the port's CPU path at a small seeded
size: the eval logits (of each configuration, and of HyperSeg-L CamVid's
six decoder levels), and a training step's loss, gradients and BN running
statistics. Only this test imports both."""

import importlib
import statistics

import pytest
import torch

import run
from lib import frames as FR, weights as W
from reference import hyperseg as R
from reference import train as RT

HW = (128, 256)


# HyperSeg-L CamVid (the port's train/harness.py MODELS["L"]): a sixth
# decoder level at the image's own size
L_CAMVID = {
    "name": "hyperseg-l-camvid", "factory": "hyperseg_v1_0", "state_dict_elements": 10036096,
    "model": {"backbone": "efficientnet-b1", "levels": 2, "kernel_sizes": [1, 1, 1, 3, 3, 3],
              "level_channels": [64, 32, 16, 16, 16, 16], "expand_ratio": 2,
              "with_out_fc": False, "decoder_dropout": None,
              "weight_groups": [64, 32, 32, 16, 8, 8], "num_classes": 12}}


def config(name):
    if name == L_CAMVID["name"]:
        return L_CAMVID
    return run.load_json(run.HERE, "configs", name + ".json")


def port_model(cfg, P, train=False):
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg['factory']}")
    kw = {k: v for k, v in cfg["model"].items() if k != "backbone"}
    m = factory.hyperseg_efficientnet(cfg["model"]["backbone"], device="cpu", train=train, **kw)
    m.load_state_dict(P, strict=True)
    return m


@pytest.mark.parametrize("name", ["hyperseg-m-cityscapes", "hyperseg-s-cityscapes",
                                  L_CAMVID["name"]])
def test_eval_logits(name):
    torch.set_num_threads(2)
    cfg = config(name)
    assert cfg["factory"] in R.FACTORIES
    p = R.plan(cfg["model"])
    P = W.make_params(R, p, 7, "cpu")
    x = FR.structured_frames(2, HW, 8, "cpu")
    W.calibrate(R, P, p, x)
    with torch.no_grad():
        ref = R.forward(P, p, x)
        got = port_model(cfg, P)(x)
    assert sum(v.numel() for v in P.values()) == cfg["state_dict_elements"]
    assert ((got - ref).norm() / ref.norm()).item() < 1e-4
    assert (got.argmax(1) == ref.argmax(1)).float().mean().item() > 0.999


def test_train_step():
    torch.set_num_threads(2)
    cfg = run.load_json(run.HERE, "configs", "hyperseg-m-cityscapes.json")
    tc = cfg["train"]
    p = R.plan(cfg["model"])
    P = W.make_params(R, p, 9, "cpu")
    img, lbl = FR.training_batch(2, HW, 10, "cpu", 19)
    model = port_model(cfg, P, train=True)
    from hyperseg_torch.train import losses as L
    crit = L.BootstrappedCrossEntropyLoss(k=tc["k"], thresh=tc["thresh"],
                                          ignore_index=tc["ignore_index"])
    loss = crit(model(img, torch.Generator().manual_seed(3)), lbl)
    loss.backward()
    trainer = RT.Trainer(R, P, p, tc)
    ref_loss, grads = trainer.step(img, lbl, torch.Generator().manual_seed(3))
    assert abs(loss.item() - ref_loss.item()) < 1e-5 * abs(ref_loss.item())
    params = dict(model.named_parameters())
    # leaf by leaf, against the larger of the leaf's norm and the median
    # leaf's (some leaves' gradients are nought to rounding)
    med = statistics.median(g.norm().item() for g in grads.values())
    worst = max((params[k].grad - g).norm().item() / max(g.norm().item(), med)
                for k, g in grads.items())
    assert worst < 1e-3
    # the running statistics, which both sides update in the forward
    stats = {k: v for k, v in model.state_dict().items() if RT.is_stat(k)}
    assert stats.keys() == {k for k in trainer.P if RT.is_stat(k)}
    worst = max(((stats[k] - trainer.P[k]).norm() / (trainer.P[k] - P[k]).norm()).item()
                for k in stats)
    assert worst < 1e-3
