"""The port's remaining utilities against the JAX package's, on the CPU.

`utils/misc.py` against hyperseg_tpu/utils/misc.py where it is
deterministic (the seeds, the pair draws, the parsers and the decaying
hyper-parameter), `init_weights` by its schemes' statistics and fan rules on
OIHW shapes (the JAX code reads HWIO); `utils/batch.py` against the JAX
runner on the same tree; `ops/meta.py` against hyperseg_tpu/ops/meta.py on
seeded numpy inputs, as tests/test_ops_meta.py checks JAX against the
reference (atol 2e-5, rtol 1e-5); `utils/profile.py`: HyperSeg-M's parameter
count of bench.py:92, model_profile's rows equal to JAX's for the tiny arch,
M, S Cityscapes (the unify decoder) and L VOC (the v0_1 decoder), and the
FLOP counts' rows summing to their total.
"""

import math
import os
import random

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_torch.core import registry
from hyperseg_torch.ops import meta
from hyperseg_torch.utils import batch as B
from hyperseg_torch.utils import misc
from hyperseg_torch.utils import profile as PR

from torch_parity import (HYPERSEG_L_VOC_KW, HYPERSEG_M_KW, HYPERSEG_S_KW, M_PARAM_COUNT,
                          TINY_ARCHS, nchw, nhwc)

ATOL, RTOL = 2e-5, 1e-5       # tests/test_ops_meta.py's


# ---------------------------------------------------------------- misc


def test_set_seed_seeds_like_jax():
    """The same seed gives the same Python and numpy streams as the JAX
    set_seed; the port returns a torch.Generator seeded with it and seeds
    torch's global generator."""
    from hyperseg_tpu.utils import misc as JM
    JM.set_seed(7)
    want = (random.random(), np.random.rand())
    g = misc.set_seed(7)
    assert (random.random(), np.random.rand()) == want
    assert isinstance(g, torch.Generator) and g.initial_seed() == 7
    assert torch.equal(torch.rand(3), torch.rand(3, generator=torch.Generator().manual_seed(7)))


@pytest.mark.parametrize("s", ["4K", "2.5m", "1g", "12", 7, 3.9, " 8k "])
def test_str2int_matches_jax(s):
    from hyperseg_tpu.utils import misc as JM
    assert misc.str2int(s) == JM.str2int(s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_pairs_match_jax(seed):
    """random_pair and random_pair_range draw JAX's pairs from the same
    Python stream, with and without a fixed first index."""
    from hyperseg_tpu.utils import misc as JM
    out = []
    for mod in (JM, misc):
        random.seed(seed)
        out.append([mod.random_pair(10, 3), mod.random_pair(10, 2, index1=4),
                    mod.random_pair_range(5, 20, 4), mod.random_pair_range(0, 9, 1, index1=3)])
    assert out[0] == out[1]
    (a, b), _, (lo, hi), _ = out[1]
    assert abs(a - b) >= 3 and lo <= hi and hi - lo >= 4


def test_exp_decaying_hyper_parameter_and_fraction_match_jax():
    from hyperseg_tpu.utils import misc as JM
    p, q = misc.ExpDecayingHyperParameter(1.0, 0.1, 10), JM.ExpDecayingHyperParameter(1.0, 0.1, 10)
    for n in (0, 1, 5, 20):
        p.update(n)
        q.update(n)
        assert p() == q()
    r = misc.ExpDecayingHyperParameter(1.0, 0.1, 10)
    r.load_state_dict(p.state_dict())
    assert r() == p() and r.step == 26
    for s in ("30000/1001", "25/1", "0/0", "24"):
        assert misc.eval_fraction(s) == JM.eval_fraction(s)


def test_get_media_info_needs_ffmpeg(tmp_path):
    """Without ffmpeg-python (not installed here) both packages raise the
    same RuntimeError."""
    from hyperseg_tpu.utils import misc as JM
    for mod in (misc, JM):
        with pytest.raises(RuntimeError, match="requires ffmpeg-python"):
            mod.get_media_info(str(tmp_path / "video.mp4"))


def _state():
    """A state dict with a conv (OIHW), a linear, a conv bias and a BN."""
    return {"conv.weight": torch.zeros(48, 96, 3, 3), "conv.bias": torch.ones(48),
            "fc.weight": torch.zeros(128, 512), "bn.weight": torch.zeros(96),
            "bn.bias": torch.ones(96), "bn.running_mean": torch.full((96,), 0.5),
            "bn.running_var": torch.full((96,), 2.0)}


@pytest.mark.parametrize("scheme,gain", [("normal", 0.02), ("xavier", 1.0), ("kaiming", 0.02),
                                         ("orthogonal", 0.5)])
def test_init_weights_schemes_and_fan_rules(scheme, gain):
    """Each scheme's std on OIHW by its fan rule (conv fan_in = in * kh * kw,
    fan_out = out * kh * kw; linear (out, in)), within 3% on >= 40k draws,
    equal to the JAX scheme's on the same conv laid out HWIO (within 3%);
    biases zeroed, BN weights N(1, gain), running statistics kept;
    orthogonal gives gain times orthonormal rows over (out, fan_in); the
    same generator seed gives the same tensors."""
    from hyperseg_tpu.utils import misc as JM
    sd = _state()
    out = misc.init_weights(sd, torch.Generator().manual_seed(0), scheme, gain)
    again = misc.init_weights(sd, torch.Generator().manual_seed(0), scheme, gain)
    assert all(torch.equal(out[k], again[k]) for k in sd)
    expect = {"conv.weight": (96 * 9, 48 * 9), "fc.weight": (512, 128)}
    jax_sd = {"conv.weight": jnp.zeros((3, 3, 96, 48)), "fc.weight": jnp.zeros((512, 128))}
    jax_out = JM.init_weights(jax_sd, jax.random.PRNGKey(0), scheme, gain)
    for k, (fan_in, fan_out) in expect.items():
        w = out[k]
        assert w.shape == sd[k].shape and w.dtype == torch.float32
        std = {"normal": gain, "xavier": gain * math.sqrt(2 / (fan_in + fan_out)),
               "kaiming": math.sqrt(2 / fan_in),
               "orthogonal": gain / math.sqrt(fan_in)}[scheme]
        assert abs(w.std().item() / std - 1) < 0.03, (k, w.std().item(), std)
        assert abs(float(jnp.std(jax_out[k])) / w.std().item() - 1) < 0.03, k
        if scheme == "orthogonal":
            rows = w.reshape(w.shape[0], -1)
            torch.testing.assert_close(rows @ rows.T, gain ** 2 * torch.eye(w.shape[0]),
                                       atol=1e-5, rtol=0)
    assert not out["conv.bias"].any() and not out["bn.bias"].any()
    assert abs(out["bn.weight"].mean().item() - 1) < 3 * gain
    assert out["bn.weight"].std().item() == pytest.approx(gain, rel=0.3)
    assert torch.equal(out["bn.running_mean"], sd["bn.running_mean"])
    assert torch.equal(out["bn.running_var"], sd["bn.running_var"])


def test_init_weights_xavier_is_the_trainers_scheme():
    g = torch.Generator().manual_seed(3)
    a = misc.init_weights_xavier(_state(), g)
    b = misc.init_weights(_state(), torch.Generator().manual_seed(3), "xavier", 1.0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(NotImplementedError):
        misc.init_weights(_state(), g, "uniform")


def test_set_device():
    """The CPU when asked for; the card by default, which raises here."""
    assert misc.set_device(cpu=True) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            misc.set_device()


# ---------------------------------------------------------------- batch


def _tree(tmp_path):
    d = tmp_path / "inputs"
    d.mkdir()
    for n in ("b.png", "a.png", "c.jpg"):
        (d / n).write_text(n)
    (tmp_path / "list.txt").write_text(f"{d / 'c.jpg'}\n\n{d / 'a.png'}\n")
    return d


def test_parse_paths_matches_jax(tmp_path):
    from hyperseg_tpu.utils import batch as JB
    d = _tree(tmp_path)
    for arg in (str(d), str(d / "*.png"), str(tmp_path / "list.txt"), str(d / "none.png")):
        assert B.parse_paths(arg) == JB.parse_paths(arg), arg
    assert B.parse_paths(str(d / "*.png")) == [str(d / "a.png"), str(d / "b.png")]


def calls_and_fails(*items, output=None, seen=None):
    """A batch function: records its items, fails on a .jpg."""
    seen.append((tuple(os.path.basename(i) for i in items), output))
    if items[0].endswith(".jpg"):
        raise ValueError("no jpg")


def test_batch_main_matches_jax(tmp_path, capsys):
    """Both runners cross the inputs positionally (the shorter padded), pass
    output and the keyword arguments on, count a raising item as failed and
    go on; a dotted function path resolves through the port's registry, and
    one naming the JAX package is refused."""
    from hyperseg_tpu.utils import batch as JB
    d = _tree(tmp_path)
    got, want = [], []
    assert B.main([str(d), str(tmp_path / "list.txt")], func=calls_and_fails, output="o",
                  seen=got) == (2, 1)
    assert JB.main([str(d), str(tmp_path / "list.txt")], func=calls_and_fails, output="o",
                   seen=want) == (2, 1)
    assert got == want == [(("a.png", "c.jpg"), "o"), (("b.png", "a.png"), "o"),
                           (("c.jpg",), "o")]
    assert B.main([str(d / "a.png")], func="hyperseg_torch.utils.batch.echo") == (1, 0)
    assert "('" in capsys.readouterr().out
    with pytest.raises(ValueError, match="hyperseg_tpu"):
        B.main([str(d)], func="hyperseg_tpu.utils.batch.echo")


# ---------------------------------------------------------------- ops/meta


@pytest.mark.parametrize("groups,k,pad,mode,dil,stride", [
    (1, 1, 0, "zeros", 1, 1), (1, 3, 1, "zeros", 1, 1), (2, 3, 1, "reflect", 1, 1),
    (4, 1, 0, "zeros", 1, 1), (1, 3, 2, "zeros", 2, 1), (2, 3, 2, "reflect", 2, 1),
    (2, 3, 1, "replicate", 1, 2), (1, 5, 2, "zeros", 1, 2),
])
def test_meta_conv2d_matches_jax(groups, k, pad, mode, dil, stride):
    """Per-sample dynamic conv (the batch folded into conv2d's groups),
    the flat weight unpacked C-ordered as (out, in/g, kh, kw)."""
    from hyperseg_tpu.ops import meta as JM
    rng = np.random.RandomState(k * 10 + groups + stride)
    b, cin, cout, h, w = 3, 8, 12, 16, 16
    x = rng.randn(b, cin, h, w).astype(np.float32)
    wt = rng.randn(b, meta.meta_conv2d_hyper_params(cout, cin, k, groups)).astype(np.float32)
    kw = dict(out_channels=cout, kernel_size=(k, k), stride=(stride, stride),
              padding=((pad, pad), (pad, pad)), dilation=(dil, dil), groups=groups,
              padding_mode=mode)
    got = meta.meta_conv2d(torch.from_numpy(x), torch.from_numpy(wt), **kw)
    want = JM.meta_conv2d(jnp.asarray(nhwc(x)), jnp.asarray(wt), **kw)
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=ATOL, rtol=RTOL)


def test_meta_linear_matches_jax():
    from hyperseg_tpu.ops import meta as JM
    rng = np.random.RandomState(0)
    x, wt = rng.randn(4, 6).astype(np.float32), rng.randn(4, 60).astype(np.float32)
    got = meta.meta_linear(torch.from_numpy(x), torch.from_numpy(wt), out_features=10,
                           in_features=6)
    want = JM.meta_linear(jnp.asarray(x), jnp.asarray(wt), out_features=10, in_features=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert meta.meta_conv2d_hyper_params(12, 8, 3, 2) == JM.meta_conv2d_hyper_params(12, 8, 3, 2)


@pytest.mark.parametrize("cin,cout,k,groups,pad,mode,stride", [
    (6, 5, 3, 1, None, "reflect", 1), (6, 6, 3, 6, None, "replicate", 1),
    (8, 4, 1, 2, None, "reflect", 1), (6, 5, 3, 1, 1, "constant", 2),
])
def test_meta_patch_conv2d_matches_jax(cin, cout, k, groups, pad, mode, stride):
    """The patch-wise dynamic conv: each patch of a 2x3 grid of 8x8 patches
    convolved with its own flat filter, the halo from the neighbours."""
    from hyperseg_tpu.ops import meta as JM
    rng = np.random.RandomState(cin + k + stride)
    b, fh, fw, ph, pw = 2, 2, 3, 8, 8
    x = rng.randn(b, cin, fh * ph, fw * pw).astype(np.float32)
    wt = rng.randn(b, fh, fw, meta.meta_conv2d_hyper_params(cout, cin, k, groups))
    wt = wt.astype(np.float32)
    kw = dict(out_channels=cout, kernel_size=k, groups=groups, padding=pad,
              padding_mode=mode, stride=(stride, stride))
    got = meta.meta_patch_conv2d(torch.from_numpy(x),
                                 torch.from_numpy(wt.transpose(0, 3, 1, 2).copy()), **kw)
    want = JM.meta_patch_conv2d(jnp.asarray(nhwc(x)), jnp.asarray(wt), **kw)
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=ATOL, rtol=RTOL)


class Child:
    """A MetaSequential child: fn(x, w), with its hyper_params."""

    def __init__(self, fn, hyper_params):
        self.fn, self.hyper_params = fn, hyper_params

    def __call__(self, x, w):
        return self.fn(x, w)


def test_meta_sequential_routes_like_jax():
    """Children with hyper_params take their slice of the flat weight's last
    axis, clamped as torch slices when the weight is short (the last child
    gets what is left), plain callables only x; a list routes one weight a
    child; the outputs of two meta_conv2d children equal JAX's."""
    from hyperseg_tpu.ops import meta as JM
    widths = {}
    for m, xp in ((meta, torch), (JM, jnp)):
        seen = widths.setdefault(m.__name__, [])
        rec = [Child(lambda x, w, t=t: seen.append((t, w.shape[-1])) or x, hp)
               for t, hp in (("a", 24), ("b", 18))]
        seq = m.MetaSequential(rec[0], lambda x: x, rec[1])
        assert seq.hyper_params == 42 and seq.ranges == [0, 24, 24, 42]
        seq(xp.zeros((1, 2)), xp.zeros((1, 40)))
        seq(xp.zeros((1, 2)), xp.zeros((1, 20)))
    assert widths["hyperseg_torch.ops.meta"] == widths["hyperseg_tpu.ops.meta"] == \
        [("a", 24), ("b", 16), ("a", 20), ("b", 0)]

    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)

    def seq(m, relu):
        return m.MetaSequential(
            Child(lambda t, w: m.meta_conv2d(t, w, out_channels=6), 24), relu,
            Child(lambda t, w: m.meta_conv2d(t, w, out_channels=3), 18))
    wt = rng.randn(2, 42).astype(np.float32)
    parts = [wt[:, :24], wt[:, 24:]]
    for w_port, w_jax in ((torch.from_numpy(wt), jnp.asarray(wt)),
                          ([torch.from_numpy(p.copy()) for p in parts],
                           [jnp.asarray(p) for p in parts])):
        got = seq(meta, torch.relu)(torch.from_numpy(x), w_port)
        want = seq(JM, lambda t: jnp.maximum(t, 0))(jnp.asarray(nhwc(x)), w_jax)
        np.testing.assert_allclose(got.numpy(), nchw(want), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------- profile


def test_count_params_of_hyperseg_m():
    """bench.py:92's (total, trainable) for HyperSeg-M."""
    model = registry.build("hyperseg_v1_0.hyperseg_efficientnet('efficientnet-b1')",
                           device="cpu", **HYPERSEG_M_KW)
    assert PR.count_params(model) == M_PARAM_COUNT
    assert PR.count_params(model.state_dict()) == M_PARAM_COUNT
    by = PR.params_by_scope(model, max_depth=1)
    assert set(by) == {"backbone", "weight_mapper", "decoder"}
    assert sum(by.values()) == M_PARAM_COUNT[0]


PROFILED = {
    "tiny": ("hyperseg_v1_0", "efficientnet-b0", dict(levels=2, kernel_sizes=[1, 3],
             level_channels=[16, 16], expand_ratio=2, weight_groups=[8, 8], num_classes=12),
             (64, 96)),
    "M": ("hyperseg_v1_0", "efficientnet-b1", HYPERSEG_M_KW, (512, 1024)),
    "SC": ("hyperseg_v1_0_unify", "efficientnet-b1", HYPERSEG_S_KW, (768, 1536)),
    "V": ("hyperseg_v0_1", "efficientnet-b3", HYPERSEG_L_VOC_KW, (512, 512)),
}


@pytest.mark.parametrize("key", sorted(PROFILED))
def test_model_profile_rows_equal_jax(key):
    """The analytic table (params, generated params per patch, MACs per
    block and unit, weight blocks of the unify decoder) equals the JAX
    package's for the same arch and input size."""
    import importlib
    from hyperseg_tpu.utils import profile as JP
    factory, backbone, kw, hw = PROFILED[key]
    jm = importlib.import_module(f"hyperseg_tpu.models.{factory}").hyperseg_efficientnet(
        backbone, **kw)
    tm = importlib.import_module(f"hyperseg_torch.models.{factory}").hyperseg_efficientnet(
        backbone, device="cpu", **kw)
    want, want_total = JP.model_profile(jm, hw, print_table=False)
    got, got_total = PR.model_profile(tm, hw, print_table=False)
    assert [(r.name, r.params, r.hyper_params, r.macs) for r in got] == \
        [(r.name, r.params, r.hyper_params, r.macs) for r in want]
    assert got_total == PR.Row(**vars(want_total))
    assert got_total.hyper_params > 0 and got_total.macs > 0


def test_flops_by_scope_rows_sum_to_the_total(capsys):
    """The per-module FLOPs (each row its module's own ops) sum to the
    forward's counted total (xla_cost's); the table prints every row and
    the model's parameter total; wall_clock times on the host clock here."""
    model = registry.build(TINY_ARCHS["short"], num_classes=12, device="cpu")
    x = torch.randn(1, 3, 64, 96)
    rows = PR.flops_by_scope(model, x, max_depth=2)
    total = PR.xla_cost(model, x)
    assert set(total) == {"flops"} and total["flops"] > 0
    assert sum(r[1] for r in rows) == total["flops"]
    names = [r[0] for r in rows]
    assert names[0] == "" and {"backbone", "weight_mapper", "decoder"} <= set(names)
    assert all(n.count(".") <= 1 for n in names)
    assert rows[0][2] == (1, 3, 64, 96) and rows[0][3] == (1, 12, 64, 96)
    PR.print_scope_table(rows, model)
    out = capsys.readouterr().out
    assert f"{PR.count_params(model)[0]:,}" in out and "weight_mapper" in out
    assert PR.wall_clock(model, x, iters=2, warmup=1) > 0
