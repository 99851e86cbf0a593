"""The training pieces of the port against the JAX package, on the CPU.

Train-mode BN, the losses, the schedule, the metrics and the two backwards
that the card runs beside its kernels (the stem conv's and the upsample's)
are each held against their JAX counterparts on the same numpy inputs; the
dropouts, the autograd Functions' wiring and the train-mode routing are
checked in the port alone.
"""

import ast
import inspect
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_torch.nn import functional as F
from hyperseg_torch.nn.modules import BatchNorm2d
from hyperseg_torch.ops.kernels import resize as K6
from hyperseg_torch.ops.kernels import stem as K3
from hyperseg_torch.train import losses as L
from hyperseg_torch.train import metrics as M
from hyperseg_torch.train import schedule as S
from hyperseg_torch.train import step as T

from torch_parity import HYPERSEG_M_KW, nchw, nhwc, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grad(fn, *args):
    """fn(*args) and the gradients of sum(fn * cotangent) by torch autograd,
    for a fixed seeded cotangent."""
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    y = fn(*leaves)
    ct = torch.from_numpy(np.random.RandomState(9).randn(*y.shape).astype(np.float32))
    (y * ct).sum().backward()
    return y.detach(), ct, [v.grad for v in leaves]


@pytest.mark.parametrize("channel_dim", [1, 3])
def test_batch_norm_train_matches_jax(channel_dim):
    """Value, running statistics (momentum 0.01 and 0.1, unbiased variance)
    and the gradients of x, weight and bias, at channel axis 1 (NCHW maps)
    and 3 (the decoder's (B, fh, fw, C, ph, pw) patch tensors)."""
    from hyperseg_tpu.nn import functional as JF
    rng = np.random.RandomState(channel_dim)
    shape = (2, 6, 5, 7) if channel_dim == 1 else (2, 2, 3, 6, 5, 4)
    c = shape[channel_dim]
    x = (rng.randn(*shape) * 3 + 1.5).astype(np.float32)
    w, b = (rng.rand(c) + 0.5).astype(np.float32), rng.randn(c).astype(np.float32)
    mean0, var0 = rng.randn(c).astype(np.float32), (rng.rand(c) + 0.5).astype(np.float32)
    axes = tuple(d for d in range(len(shape)) if d != channel_dim)
    for momentum in (0.01, 0.1):
        rm, rv = t(mean0).clone(), t(var0).clone()
        y, ct, (gx, gw, gb) = _grad(
            lambda x_, w_, b_: F.batch_norm_train(x_, w_, b_, rm, rv, eps=1e-3,
                                                  momentum=momentum, channel_dim=channel_dim),
            t(x), t(w), t(b))

        def jfn(x_, w_, b_):
            xt = jnp.moveaxis(x_, channel_dim, -1)
            out = JF.batch_norm_train(xt, w_, b_, jnp.asarray(mean0), jnp.asarray(var0),
                                      eps=1e-3, momentum=momentum)
            return jnp.moveaxis(out[0], -1, channel_dim), out[1], out[2]
        (jy, jm, jv), vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        jgx, jgw, jgb = vjp((jnp.asarray(ct.numpy()), jnp.zeros(c), jnp.zeros(c)))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(rm.numpy(), np.asarray(jm), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(rv.numpy(), np.asarray(jv), atol=1e-6, rtol=1e-5)
        n = x.size // c
        want_v = (1 - momentum) * var0 + momentum * x.var(axis=axes) * n / (n - 1)
        np.testing.assert_allclose(rv.numpy(), want_v, rtol=1e-4)
        for got, want in ((gx, jgx), (gw, jgw), (gb, jgb)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_batch_norm_module_modes():
    """BatchNorm2d: training normalizes with the batch statistics and writes
    the running ones in place with its own momentum; eval reads them back;
    the state dict holds exactly the four reference tensors."""
    bn = BatchNorm2d(4, 1e-3, 0.01)
    assert list(bn.state_dict()) == ["weight", "bias", "running_mean", "running_var"]
    x = torch.randn(3, 4, 5, 6, generator=torch.Generator().manual_seed(0)) * 2 + 3
    y = bn.train()(x)
    np.testing.assert_allclose(y.mean((0, 2, 3)).detach().numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.01 * x.mean((0, 2, 3)).numpy(),
                               rtol=1e-5)
    assert not bn.running_mean.requires_grad and bn.running_mean.grad_fn is None
    before = bn.running_mean.clone()
    with torch.no_grad():
        bn.eval()(x)
    assert torch.equal(bn.running_mean, before)


def _ce_inputs():
    """Seeded logits (3, 5, 16, 16) and labels with ignored pixels. Image 0:
    confident logits, 36 mislabelled pixels (loss about 8) and 8 identical
    pixels of loss 0.18 at ranks 37-44, so with k = 40 the (k+1)-th largest
    loss is under thresh (the top-k branch) and the k-th is tied; image 1:
    flat logits, every loss above thresh (the mean-above branch); image 2
    random, with ignored rows."""
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 5, 16, 16).astype(np.float32)
    labels = rng.randint(0, 5, (3, 16, 16)).astype(np.int64)
    onehot = np.eye(5, dtype=np.float32)[labels[0]].transpose(2, 0, 1)
    logits[0] = 8 * onehot + 0.1 * logits[0]
    labels[0, 1:3] = (labels[0, 1:3] + 1) % 5
    labels[0, 3, :4] = (labels[0, 3, :4] + 1) % 5
    logits[0, :, 0, :8] = np.array([3, 0, 0, 0, 0], np.float32)[:, None]
    labels[0, 0, :8] = 0
    logits[1] *= 0.1
    labels[2, :2] = 255
    return logits, labels


@pytest.mark.parametrize("k", [40, 4096])
def test_bootstrapped_ce_matches_jax(k):
    """Value and logits gradient of the bootstrapped CE against the JAX
    "select" method; k = 40 takes the top-k branch on image 0 with a tie at
    the k-th value, k = 4096 >= n the whole-row mean."""
    from hyperseg_tpu.train import losses as JL
    logits, labels = _ce_inputs()
    flat = L.softmax_cross_entropy(t(logits), t(labels))[0][0].reshape(-1)
    srt = flat.sort(descending=True).values
    if k == 40:
        assert srt[35] > 0.3 > srt[40] and (flat == srt[39]).sum() == 8   # top-k, tie at k
    loss, _, (g,) = _grad(lambda l_: L.bootstrapped_cross_entropy(l_, t(labels), k=k)[None],
                          t(logits))

    def jfn(l_):
        return JL.bootstrapped_cross_entropy(jnp.moveaxis(l_, 1, -1), jnp.asarray(labels), k=k)
    jloss, vjp = jax.vjp(jfn, jnp.asarray(logits))
    (jg,) = vjp(jnp.float32(float(np.random.RandomState(9).randn(1)[0])))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-7, rtol=1e-4)


def test_bootstrapped_ce_branches():
    """Per image: the mean over losses above thresh when the (k+1)-th
    largest exceeds it, else the top-k mean (the reference's sorted[k])."""
    logits, labels = _ce_inputs()
    per_pixel = L.softmax_cross_entropy(t(logits), t(labels))[0].reshape(3, -1)
    for i in range(3):
        row = per_pixel[i].sort(descending=True).values
        want = row[row > 0.3].mean() if row[40] > 0.3 else row[:40].mean()
        got = L.bootstrapped_cross_entropy(t(logits[i:i + 1]), t(labels[i:i + 1]), k=40)
        np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)


def test_softmax_cross_entropy_matches_jax():
    """Per-pixel CE with ignore_index and a class weight, and the loss
    class's defaults (ignore_index -100, as the reference's)."""
    from hyperseg_tpu.train import losses as JL
    logits, labels = _ce_inputs()
    weight = np.linspace(0.5, 2.0, 5).astype(np.float32)
    got, valid = L.softmax_cross_entropy(t(logits), t(labels), weight=t(weight))
    want, jvalid = JL.softmax_cross_entropy(jnp.moveaxis(jnp.asarray(logits), 1, -1),
                                            jnp.asarray(labels), weight=jnp.asarray(weight))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert L.BootstrappedCrossEntropyLoss().ignore_index == -100


def test_poly_lr_matches_jax():
    from hyperseg_tpu.train import schedule as JS
    for base, steps in ((1e-3, 100), (0.01, 7)):
        got, want = S.poly_lr(base, steps), JS.poly_lr(base, steps)
        for step in (0, 1, 3, 50, steps, steps + 5):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    assert S.constant_lr(0.5)(10) == 0.5 and S.poly_lr(1.0, 10)(10) == 0.0


def test_optimizer_follows_the_schedule():
    """Update t uses schedule(t), the first the base rate (optax's order)."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = T.make_optimizer([p], S.poly_lr(1e-3, 4))
    assert opt.defaults["betas"] == (0.5, 0.999) and opt.defaults["eps"] == 1e-8
    seen = []
    for _ in range(3):
        seen.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    np.testing.assert_allclose(seen, [1e-3 * (1 - s / 4) ** 0.9 for s in range(3)], rtol=1e-12)


def test_split_params():
    bn = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 1), BatchNorm2d(3, 1e-5, 0.1))
    train, state = T.split_params(bn)
    assert sorted(state) == ["1.running_mean", "1.running_var"]
    assert sorted(train) == ["0.bias", "0.weight", "1.bias", "1.weight"]


def test_metrics_match_jax():
    """confusion_matrix (ignore_index and out-of-range labels), the scores
    and per_image_jaccard (quirk #8: void labels enter no union)."""
    from hyperseg_tpu.train import metrics as JM
    rng = np.random.RandomState(5)
    labels = rng.randint(0, 6, (2, 9, 11))
    labels[0, :2] = 255
    labels[1, 0, :3] = 7
    preds = rng.randint(0, 6, (2, 9, 11))
    got = M.confusion_matrix(t(labels), t(preds), 6).numpy()
    want = np.asarray(JM.confusion_matrix(jnp.asarray(labels), jnp.asarray(preds), 6))
    np.testing.assert_array_equal(got, want)
    for a, b in zip(M.scores_from_confmat(got).values(), JM.scores_from_confmat(want).values()):
        np.testing.assert_allclose(a, b)
    for a, b in zip(M.eval_scores_from_confmat(got), JM.eval_scores_from_confmat(want)):
        np.testing.assert_allclose(a, b)
    for ignore in (0, None, 255):
        assert M.per_image_jaccard(labels[0], preds[0], 6, ignore) == pytest.approx(
            JM.per_image_jaccard(labels[0], preds[0], 6, ignore))
    assert M.per_image_jaccard(np.full(4, 255), np.zeros(4, np.int64), 6) == 0.0


@pytest.mark.parametrize("hw", [(16, 32), (17, 33), (10, 7)])
def test_stem_conv_backward_matches_jax(hw):
    """stem_conv_backward against the JAX stem_conv's backward: jax.vjp of
    the custom VJP (forward in interpret mode) where its kernel takes the
    shape, its `_stem_conv_bwd` directly at odd H and W."""
    from hyperseg_tpu.ops.pallas import stem as JS
    rng = np.random.RandomState(hw[0])
    h, w = hw
    x = rng.randn(2, 3, h, w).astype(np.float32)
    wt = (rng.randn(32, 3, 3, 3) * 0.2).astype(np.float32)
    ho, wo = K3.stem_out_hw(h, w)
    g = rng.randn(2, 32, ho, wo).astype(np.float32)
    jx, jw = jnp.asarray(nhwc(x)), jnp.asarray(wt.transpose(2, 3, 1, 0))
    if JS.supported(h, w, 3):
        _, vjp = jax.vjp(lambda a, b: JS.stem_conv(a, b, True), jx, jw)
        want_x, want_w = vjp(jnp.asarray(nhwc(g)))
    else:
        want_x, want_w = JS._stem_conv_bwd(True, (jx, jw), jnp.asarray(nhwc(g)))
    dx, dw = K3.stem_conv_backward(t(x), t(wt), t(g))
    assert dx.shape == x.shape and dw.shape == wt.shape
    np.testing.assert_allclose(dx.numpy(), nchw(want_x), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_w).transpose(3, 2, 0, 1),
                               atol=1e-4, rtol=1e-5)
    assert K3.stem_conv_backward(t(x), t(wt), t(g), need_input=False)[0] is None


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_resize_backward_matches_jax(scale):
    from hyperseg_tpu.ops.pallas import resize as JR
    rng = np.random.RandomState(scale)
    b, c, h, w = 2, 3, 5, 7
    g = rng.randn(b, c, h * scale, w * scale).astype(np.float32)
    (want,) = JR._bwd((h * scale, w * scale), (b, h, w, c), jnp.asarray(nhwc(g)))
    got = K6.resize_bilinear_backward(t(g), (h, w))
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=1e-5, rtol=1e-5)
    # an all-ones cotangent: each input row and column receives the weight
    # of s outputs, the clamped edge taps' included, so every entry is s * s
    ones = K6.resize_bilinear_backward(torch.ones(1, 1, h * scale, w * scale), (h, w))
    np.testing.assert_allclose(ones[0, 0, [0, -1]].numpy(), scale * scale, rtol=1e-6)
    np.testing.assert_allclose(ones.numpy(), scale * scale, rtol=1e-6)


def test_autograd_functions_match_the_twins(monkeypatch):
    """StemConv and ResizeBilinear, their kernels replaced by the twins (the
    CPU has no card), give the twins' autograd gradients: the wiring of the
    Functions the card runs, odd sizes and an image without grad included."""
    monkeypatch.setattr(K3, "stem", K3.stem_plain)
    monkeypatch.setattr(K6, "_resize_kernel", K6.resize_bilinear_plain)
    rng = np.random.RandomState(0)
    x = t(rng.randn(2, 3, 17, 23).astype(np.float32))
    w = t((rng.randn(8, 3, 3, 3) * 0.3).astype(np.float32))
    y, _, (gx, gw) = _grad(K3.StemConv.apply, x, w)
    y0, _, (gx0, gw0) = _grad(K3.stem_conv_plain, x, w)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), gx0.numpy(), atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), gw0.numpy(), atol=1e-4, rtol=1e-5)
    wl = w.clone().requires_grad_(True)
    K3.StemConv.apply(x, wl).sum().backward()
    assert wl.grad is not None
    xs = t(rng.randn(2, 4, 5, 6).astype(np.float32))
    y, _, (g,) = _grad(lambda a: K6.ResizeBilinear.apply(a, (15, 18)), xs)
    y0, _, (g0,) = _grad(lambda a: K6.resize_bilinear_plain(a, (15, 18)), xs)
    np.testing.assert_allclose(g.numpy(), g0.numpy(), atol=1e-5)


def test_dropout2d_and_drop_connect():
    """dropout2d zeroes whole channels of a sample, drop_connect whole
    samples; survivors scaled by 1/keep; p = 0 the identity; the same
    generator seed the same mask; no generator an error."""
    x = torch.rand(8, 16, 4, 5) + 1.0
    keep = 0.75
    y = F.dropout2d(x, 0.25, torch.Generator().manual_seed(3))
    per_channel = (y == 0).reshape(8, 16, -1)
    assert torch.equal(per_channel.all(-1), per_channel.any(-1))       # whole channels
    kept = per_channel[..., 0].logical_not()
    assert 0 < kept.float().mean() < 1
    torch.testing.assert_close(y[kept[:, :, None, None].expand_as(y)],
                               (x / keep)[kept[:, :, None, None].expand_as(x)])
    assert torch.equal(y, F.dropout2d(x, 0.25, torch.Generator().manual_seed(3)))
    z = F.drop_connect(x, 0.5, torch.Generator().manual_seed(4))
    zero = (z == 0).reshape(8, -1)
    assert torch.equal(zero.all(1), zero.any(1)) and 0 < zero.all(1).sum() < 8
    torch.testing.assert_close(z[~zero.all(1)], (x / 0.5)[~zero.all(1)])
    assert torch.equal(z, F.drop_connect(x, 0.5, torch.Generator().manual_seed(4)))
    e = F.dropout(x, 0.5, torch.Generator().manual_seed(5))
    assert 0.3 < (e == 0).float().mean() < 0.7
    for fn in (F.dropout, F.dropout2d, F.drop_connect):
        assert fn(x, 0.0, None) is x
        with pytest.raises(ValueError, match="Generator"):
            fn(x, 0.5, None)


def test_model_dropouts_follow_mode_and_generator():
    """A HyperSeg-M backbone with drop connect and head dropout: in training
    the generator's seed decides the output; in eval they are the identity
    and the generator is not read."""
    from hyperseg_torch.models.backbones.efficientnet import EfficientNet
    bb = EfficientNet("efficientnet-b1", out_feat_scale=HYPERSEG_M_KW["out_feat_scale"],
                      device="cpu").requires_grad_(False)
    assert (bb.drop_connect_rate, bb.dropout_rate) == (0.2, 0.2)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))

    def head(seed):
        return bb(x, torch.Generator().manual_seed(seed))[-1]
    bb.train()
    a, b, c = head(1), head(1), head(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (a == 0).any()
    bb.eval()
    torch.testing.assert_close(bb(x)[-1], bb(x, torch.Generator().manual_seed(7))[-1])


EVAL_ONLY = ("stem", "mbconv_dw", "mbconv_project", "mbconv_expand_dw", "patch_invres_s2w",
             "patch_invres", "patch_invres_v01")


def _spy_kernels(monkeypatch, seen):
    """Replace every kernel wrapper by one that records its name and runs
    the twin (which runs on the meta device)."""
    from hyperseg_torch.ops.kernels import mbconv as K4
    from hyperseg_torch.ops.kernels import patch_invres as PI
    twins = {K3: {"stem": "stem_plain", "stem_conv": "stem_conv_plain"},
             K4: {"mbconv_dw": "mbconv_dw_plain", "mbconv_project": "mbconv_project_plain",
                  "mbconv_expand_dw": "mbconv_expand_dw_plain"},
             PI: {"patch_invres_s2w": "patch_invres_s2w_plain",
                  "s2w_generate": "s2w_generate_plain",
                  "patch_invres": "patch_invres_plain",
                  "patch_invres_v01": "patch_invres_v01_plain"},
             K6: {"resize_bilinear": "resize_bilinear_plain"}}
    for mod, names in twins.items():
        for name, twin in names.items():
            def spy(*a, _name=name, _twin=getattr(mod, twin), **kw):
                seen.append(_name)
                return _twin(*a, **kw)
            monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("family", ["v1_0", "v0_1", "v1_0_unify"])
def test_train_mode_routes_no_eval_only_kernel(monkeypatch, family):
    """On the meta device, a train-mode HyperSeg-M (v1_0), HyperSeg-L VOC
    (v0_1) or HyperSeg-S Cityscapes (v1_0_unify) at full width reaches K3's
    raw conv and K6 and no eval-only kernel; after model.eval() the same
    model reaches the eval kernels again, the stem's BN-folded K3 and not
    its raw conv (v1_0: K1's generation kernel for the 1x1 levels' maps,
    K1 at levels 3-4; unify: K1's generation kernel for the weight blocks,
    K2 at levels 3-4)."""
    from hyperseg_torch.models import hyperseg_v0_1 as V0
    from hyperseg_torch.models import hyperseg_v1_0 as V1
    from hyperseg_torch.models import hyperseg_v1_0_unify as VU
    from torch_parity import HYPERSEG_L_VOC_KW, HYPERSEG_S_KW
    if family == "v1_0_unify":
        model = VU.hyperseg_efficientnet("efficientnet-b1", device="meta", train=True,
                                         **HYPERSEG_S_KW)
        eval_want = {"stem", "mbconv_dw", "mbconv_project", "mbconv_expand_dw",
                     "s2w_generate", "patch_invres", "resize_bilinear"}
    elif family == "v1_0":
        model = V1.hyperseg_efficientnet("efficientnet-b1", device="meta", train=True,
                                         **HYPERSEG_M_KW)
        eval_want = {"stem", "mbconv_dw", "mbconv_project", "mbconv_expand_dw",
                     "s2w_generate", "patch_invres_s2w", "resize_bilinear"}
    else:
        model = V0.hyperseg_efficientnet("efficientnet-b3", device="meta", train=True,
                                         **HYPERSEG_L_VOC_KW)
        eval_want = {"stem", "mbconv_dw", "mbconv_project", "mbconv_expand_dw",
                     "patch_invres_v01", "resize_bilinear"}
    assert model.training and all(p.requires_grad for p in model.parameters())
    assert not any(b.requires_grad for b in model.buffers())
    model.backbone.drop_connect_rate = model.backbone.dropout_rate = 0.0
    seen = []
    _spy_kernels(monkeypatch, seen)
    x = torch.empty(2, 3, 256, 512, device="meta")
    model(x)
    assert set(seen) == {"stem_conv", "resize_bilinear"}, seen
    seen.clear()
    with torch.no_grad():
        model.eval()(x)
    assert set(seen) == eval_want, seen


def test_port_imports_no_jax_and_builds_on_the_card():
    """The repair pass: no module of hyperseg_torch, nor chip_smoke.py,
    imports jax or hyperseg_tpu; every factory defaults to "cuda"; no
    kernel wrapper module catches an exception."""
    from hyperseg_torch.models import hyperseg_v0_1 as V0
    from hyperseg_torch.models import hyperseg_v0_2 as V02
    from hyperseg_torch.models import hyperseg_v1_0 as V1
    from hyperseg_torch.models import hyperseg_v1_0_unify as VU
    files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(ROOT, "hyperseg_torch"))
             for f in fs if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "hyperseg_tpu"), (path, n)
            if "ops/kernels" in path and path.endswith(".py"):
                assert not isinstance(node, ast.Try), path
    for factory in (V0.hyperseg_efficientnet, V1.hyperseg_efficientnet,
                    V02.hyperseg_efficientnet, VU.hyperseg_efficientnet):
        params = inspect.signature(factory).parameters
        assert params["device"].default == "cuda" and params["train"].default is False


def test_saved_bytes_counts_each_storage_once():
    """The step's memory estimate sums the distinct storages autograd keeps:
    a Linear keeps its input and weight; x * x + x * x keeps x once."""
    from hyperseg_torch.train.saved_memory import saved_bytes
    x = torch.randn(5, 4, requires_grad=True)
    assert saved_bytes(torch.nn.Linear(4, 3), x, None, lambda y, _: y.sum()) == (20 + 12) * 4
    assert saved_bytes(lambda a: a * a + a * a, x, None, lambda y, _: y.sum()) == 20 * 4


@pytest.mark.parametrize("key", ["M", "L", "V"])
def test_recipes_match_the_shipped_configs(key):
    """train/recipes.py against configs/train/*.py's build_kwargs: batch,
    crop (RandomCrop, or VOC's ConstantPad to a square), Adam's lr and
    betas, PolyLR's power and length, per-batch or per-epoch stepping and
    the steps of an epoch; a per-epoch schedule holds its rate through an
    epoch."""
    import importlib.util
    from hyperseg_torch.train import schedule as S
    from hyperseg_torch.train.recipes import RECIPES
    from hyperseg_torch.train.step import make_optimizer

    r = RECIPES[key]
    path = os.path.join(ROOT, "configs", "train", r.config)
    spec = importlib.util.spec_from_file_location(f"recipe_{key}", path)
    cfg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cfg)
    kw = cfg.build_kwargs()
    crop = {t.target.rsplit(".", 1)[1]: t.args for t in kw["train_img_transforms"]}
    size = crop["RandomCrop"][0] if "RandomCrop" in crop else [crop["ConstantPad"][0]] * 2
    assert (r.batch, tuple(size)) == (kw["batch_size"], r.crop)
    assert r.lr == kw["optimizer"]["lr"]
    opt, _ = make_optimizer([torch.zeros(1, requires_grad=True)], r.schedule())
    assert opt.defaults["betas"] == tuple(kw["optimizer"]["betas"])
    assert (r.power, r.max_epoch) == (kw["scheduler"]["power"], kw["scheduler"]["max_epoch"])
    assert r.per_batch == kw["batch_scheduler"]
    assert r.steps_per_epoch == kw["train_iterations"] // kw["batch_size"]
    poly, sched = S.poly_lr(r.lr, r.max_epoch, r.power), r.schedule()
    if r.per_batch:
        assert [sched(t) for t in (0, 1, 7)] == [poly(t) for t in (0, 1, 7)]
    else:
        n = r.steps_per_epoch
        assert sched(0) == sched(n - 1) == poly(0) and sched(n) == poly(1) > sched(2 * n)


def test_step_runs_in_float64_on_the_cpu():
    """The training step of a model cast to float64 computes in float64
    throughout (BN statistics, the twins, the loss and its bootstrap
    weights), so it can stand as the reference against which a float32
    step is read (chip_smoke.py T2): no op makes a float32 tensor but the
    optimizer's step counters (0-d) and constants lifted from numpy (the
    coordinate grids, the upsample taps), which are exact or shared with
    the float32 run. Its loss equals the float32 step's to float32 accuracy."""
    import copy
    from torch.utils._python_dispatch import TorchDispatchMode
    from hyperseg_torch.models import hyperseg_v1_0 as V1

    class Float32Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in out if isinstance(out, (tuple, list)) else [out]:
                if (isinstance(o, torch.Tensor) and o.dim() and o.dtype != torch.float64
                        and o.is_floating_point()):
                    self.ops.add(str(func))
            return out

    model = V1.hyperseg_efficientnet(
        "efficientnet-b0", device="cpu", train=True, levels=2, kernel_sizes=[1, 3],
        level_channels=[16, 16], expand_ratio=2, weight_groups=[8, 8], num_classes=5)
    model.backbone.drop_connect_rate = model.backbone.dropout_rate = 0.0
    model64 = copy.deepcopy(model).double()
    g = torch.Generator().manual_seed(0)
    img = torch.randn(2, 3, 64, 128, generator=g)
    lbl = torch.randint(0, 5, (2, 64, 128), generator=g)
    lbl[:, :4] = 255

    def step(m, x):
        opt, sched = T.make_optimizer(m.parameters(), S.poly_lr(1e-3, 10))
        return T.make_train_step(m, L.BootstrappedCrossEntropyLoss(ignore_index=255), opt,
                                 sched, num_classes=5)(x, lbl)

    # one thread: float64 ops run ATen's own parallel loops, which crawl when
    # the test workers' thread pools oversubscribe the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss32 = step(model, img)["loss"].item()
        spy = Float32Ops()
        with spy:
            out = step(model64, img.double())
    finally:
        torch.set_num_threads(threads)
    assert spy.ops == {"aten.lift_fresh.default"}, spy.ops
    assert out["loss"].dtype == torch.float64
    grads = [p.grad for p in model64.parameters() if p.grad is not None]
    assert len(grads) > 100 and all(g.dtype == torch.float64 for g in grads)
    assert all(p.dtype == torch.float64 for p in model64.parameters())
    assert abs(out["loss"].item() - loss32) <= 1e-5 * abs(loss32)
