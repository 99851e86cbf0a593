"""The predictor, the confusion matrix and the FPS CLI against the JAX package's.

On the CPU, on the tiny arch of tests/test_cli.py (torch_parity.tiny_jax_params):
pad_to_multiple and the bucketed Predictor, the capture-safe confusion
matrix, test_fps.main and remove_bn. The graph replay itself runs only on a
card: its test is marked `cuda` and skips here (chip_smoke.py holds the
graphed forward of every model against its eager forward on the H100).
JAX is imported inside the tests that use it, so that the card's test runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fps.py
"""

import numpy as np
import pytest
import torch

from hyperseg_torch.cli import test_fps
from hyperseg_torch.core import registry
from hyperseg_torch.core.convert import jax_to_torch_state_dict
from hyperseg_torch.core.predictor import Predictor, graphed, pad_to_multiple
from hyperseg_torch.nn import functional as F
from hyperseg_torch.train import metrics as M

from torch_parity import TINY_ARCHS, TINY_CLASSES, assert_close_rel, nchw, tiny_jax_params

SHAPES = [(50, 70, 3), (64, 96, 3), (33, 129, 3)]   # tests/test_predictor.py's


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, perturbed params, the port's model on the CPU with them)."""
    jm, params = tiny_jax_params()
    tm = registry.build(TINY_ARCHS["reference"], num_classes=TINY_CLASSES, device="cpu")
    tm.load_state_dict(jax_to_torch_state_dict(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("shape", [(1, 50, 70, 3), (1, 64, 96, 3), (2, 33, 129, 3),
                                   (1, 20, 40, 3)])
@pytest.mark.parametrize("mode", ["reflect", "edge", "constant"])
def test_pad_to_multiple_matches_jax(shape, mode):
    from hyperseg_tpu.core.predictor import pad_to_multiple as jax_pad
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got, got_hw = pad_to_multiple(x, 32, mode)
    want, want_hw = jax_pad(x, 32, mode)
    assert got_hw == want_hw == shape[1:3] and got.shape[1] % 32 == got.shape[2] % 32 == 0
    np.testing.assert_array_equal(got, want)


def test_predictor_matches_jax(tiny):
    """Three shapes in two buckets (one per bucket, as the JAX predictor
    compiles one jit per bucket), logits of each shape as the JAX model's
    on the same padded input, and a divisible shape as the direct forward."""
    import jax
    import jax.numpy as jnp
    from hyperseg_tpu.core.predictor import Predictor as JaxPredictor
    jm, params, tm = tiny
    pred = Predictor(tm, dtype=torch.float32)
    jpred = JaxPredictor(jm, params, dtype=jnp.float32)
    assert pred.multiple == jpred.multiple == 64   # the mapper's two levels
    jfwd = jax.jit(lambda p, x: jm(p, x))
    rng = np.random.RandomState(0)
    for shape in SHAPES:
        img = rng.rand(*shape).astype(np.float32)
        got = pred(img)
        assert got.shape == shape[:2] + (TINY_CLASSES,) and got.dtype == np.float32
        padded, (h, w) = pad_to_multiple(img[None], jpred.multiple)
        want = np.asarray(jfwd(jpred.params, jnp.asarray(padded)))[0, :h, :w]
        assert_close_rel(got, want, 2e-3, f"Predictor {shape}")
    assert len(pred._cache) == 2
    x = rng.rand(1, 64, 128, 3).astype(np.float32)      # a whole bucket: no padding
    with torch.no_grad():
        direct = tm(torch.from_numpy(nchw(x).copy())).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(pred(x), direct, atol=1e-5)
    small = Predictor(tm, dtype=torch.float32, max_cache=1)
    for shape in SHAPES:
        small(rng.rand(*shape).astype(np.float32))
    assert list(small._cache) == [(1, 3, 64, 192)]


@pytest.mark.parametrize("num_classes", [6, 19])
def test_confusion_matrix_matches_jax(num_classes):
    """Bit-equal to the JAX confusion matrix (and to the bincount it
    replaces) with ignore labels 255, negative and out-of-range labels."""
    import jax.numpy as jnp
    from hyperseg_tpu.train import metrics as JM
    rng = np.random.RandomState(num_classes)
    labels = rng.randint(0, num_classes, (2, 33, 47)).astype(np.int32)
    labels.flat[rng.choice(labels.size, 300, replace=False)] = 255
    labels.flat[rng.choice(labels.size, 50, replace=False)] = -1
    labels.flat[rng.choice(labels.size, 50, replace=False)] = num_classes + 3
    preds = rng.randint(0, num_classes, labels.shape).astype(np.int32)
    for ignore in (255, None):
        got = M.confusion_matrix(torch.from_numpy(labels), torch.from_numpy(preds),
                                 num_classes, ignore_index=ignore).numpy()
        want = np.asarray(JM.confusion_matrix(jnp.asarray(labels), jnp.asarray(preds),
                                              num_classes, ignore_index=ignore))
        np.testing.assert_array_equal(got, want)
        valid = (labels >= 0) & (labels < num_classes) & (labels != 255)
        ref = np.bincount(labels[valid] * num_classes + preds[valid],
                          minlength=num_classes ** 2).reshape(num_classes, num_classes)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("source", ["arch", "checkpoint", "dataset"])
def test_fps_main_on_the_cpu(tiny, tmp_path, source):
    """test_fps.main(device="cpu") on the tiny arch, 2 iterations at 64x96,
    float32, from an arch string or a JAX checkpoint, writes scores.npz with
    a class_iou per class; a dataset raises until the data port exists."""
    from hyperseg_tpu.core import checkpoint as JC
    _, params, _ = tiny
    kw = dict(batch_size=1, iterations=2, res=(64, 96), num_classes=TINY_CLASSES,
              compute_dtype="float32", device="cpu")
    if source == "dataset":
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            test_fps.main(str(tmp_path), arch=TINY_ARCHS["reference"],
                          test_dataset="camvid.CamVidDataset('x')", **kw)
        assert F.BN_IDENTITY is False
        return
    if source == "arch":
        fps = test_fps.main(str(tmp_path), arch=TINY_ARCHS["reference"], **kw)
    else:
        arch = TINY_ARCHS["jax"][:-1] + f", num_classes={TINY_CLASSES})"
        JC.save_checkpoint(str(tmp_path), "model", JC.jnp_to_np(params), meta={"arch": arch})
        fps = test_fps.main(str(tmp_path), model="model_latest.npz", **kw)
    with np.load(tmp_path / "test_fps" / "scores.npz") as z:
        assert float(z["fps"]) == pytest.approx(fps) and fps > 0
        assert z["class_iou"].shape == (TINY_CLASSES,)
        assert np.isfinite(z["class_iou"]).all()


def test_remove_bn_matches_jax(tiny, tmp_path, monkeypatch):
    """The port's BN-free logits equal the JAX remove_bn + F.BN_IDENTITY
    logits on the same perturbed parameters, no BN runs (torch's batch_norm
    and the patch BN's fold are never called), and test_fps restores the
    flag, also after an error."""
    import jax
    import jax.numpy as jnp
    from hyperseg_tpu.cli import test_fps as jax_fps
    from hyperseg_tpu.nn import functional as JF
    jm, params, tm = tiny
    x = np.random.RandomState(0).rand(1, 64, 96, 3).astype(np.float32)
    JF.BN_IDENTITY = True      # read when tracing: a fresh function, so a fresh trace
    try:
        want = np.asarray(jax.jit(lambda p, xx: jm(p, xx))(jax_fps.remove_bn(params),
                                                          jnp.asarray(x)))
    finally:
        JF.BN_IDENTITY = False
    bn_calls = []
    real_bn, real_fold = torch.nn.functional.batch_norm, F.fold_bn
    monkeypatch.setattr(torch.nn.functional, "batch_norm",
                        lambda *a, **k: bn_calls.append("batch_norm") or real_bn(*a, **k))
    monkeypatch.setattr(F, "fold_bn", lambda *a, **k: bn_calls.append("fold") or real_fold(*a, **k))
    model = registry.build(TINY_ARCHS["reference"], num_classes=TINY_CLASSES, device="cpu")
    model.load_state_dict(tm.state_dict(), strict=True)
    xt = torch.from_numpy(nchw(x).copy())
    with torch.no_grad():
        with_bn = model(xt).numpy()
        assert "batch_norm" in bn_calls and "fold" in bn_calls   # the spies are live
        bn_calls.clear()
        test_fps.remove_bn(model)
        monkeypatch.setattr(F, "BN_IDENTITY", True)
        got = model(xt).permute(0, 2, 3, 1).numpy()
    assert bn_calls == []
    assert not np.allclose(got, with_bn.transpose(0, 2, 3, 1))
    # without BN the random-init activations shrink by each layer to ~1e-28,
    # still normal float32: held relative to their own scale
    scale = np.abs(want).max()
    assert 0 < scale and np.abs(got - want).max() <= 2e-3 * scale
    monkeypatch.setattr(F, "BN_IDENTITY", False)
    fps = test_fps.main(str(tmp_path), arch=TINY_ARCHS["reference"], batch_size=1,
                        iterations=2, res=(64, 96), num_classes=TINY_CLASSES,
                        compute_dtype="float32", with_remove_bn=True, device="cpu")
    assert fps > 0 and F.BN_IDENTITY is False
    with pytest.raises(AssertionError):
        test_fps.main(str(tmp_path), with_remove_bn=True, device="cpu")   # no arch
    assert F.BN_IDENTITY is False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_forward_matches_eager_on_card(dtype):
    """The captured forward replayed on the card against the eager forward
    of the same model, at two inputs: equal logits (the same kernels on the
    same data) and the replay's outputs overwritten in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from hyperseg_torch.nn.modules import cast_weights
    model = cast_weights(registry.build(TINY_ARCHS["reference"], num_classes=TINY_CLASSES,
                                        device="cuda"), dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    x1, x2 = (torch.randn(2, 3, 64, 96, generator=g, device="cuda", dtype=dtype)
              for _ in range(2))
    def fwd(x):
        with torch.no_grad():
            return model(x)
    replay = graphed(fwd, x1)
    for x in (x2, x1):
        got = replay(x).clone()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, fwd(x), rtol=0, atol=0)
    assert replay(x2) is replay(x1)


@pytest.mark.cuda
def test_predictor_graphs_each_bucket_on_card():
    """On the card the Predictor keeps one captured graph per shape bucket
    and returns the eager forward's logits, cropped, for each image."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    model = registry.build(TINY_ARCHS["reference"], num_classes=TINY_CLASSES, device="cuda")
    pred = Predictor(model, dtype=torch.float32)
    rng = np.random.RandomState(0)
    for shape in SHAPES:
        img = rng.rand(*shape).astype(np.float32)
        got = pred(img)
        padded, (h, w) = pad_to_multiple(img[None], pred.multiple)
        with torch.no_grad():
            want = model(torch.from_numpy(nchw(padded).copy()).cuda())[:, :, :h, :w]
        np.testing.assert_array_equal(got, want[0].permute(1, 2, 0).cpu().numpy())
    assert len(pred._cache) == 2
    assert all(hasattr(fn, "graph") for fn in pred._cache.values())
