"""HyperSeg-M's 1x1 decoder levels make their weight maps with K1's
generation kernel in eval.

In eval a v1_0 PatchConvUnit takes its (B, fh, fw, P) map from
ops/kernels/patch_invres.py `s2w_generate` in the activation dtype and
reads it in place (`apply_map`); in training, and in a remat region's
input, it keeps the grouped signal2weights conv (`apply_signal2weights`)
and `apply_weights`. On the CPU the generation is its twin. Here, at b2
128x256 with every BN bias in [1, 2] (the benchmark's weights, which keep
a random network's activations O(1)):

  * the eval forward against the grouped-conv route: bit-equal in
    float64; in float32 each map is bit-equal and each unit's output within
    a few float32 ulps (the one-pixel patches of level 0 meet a different
    BLAS kernel in apply_map's matmul than in apply_weights' einsum);
  * eval calls s2w_generate once a 1x1 unit, with the activation dtype,
    and never the grouped conv; training, with and without remat, the
    grouped conv and never s2w_generate;
  * under spatial sharding (two bands of one process, no collective: a 1x1
    unit is local to its patches) the bands make up the unsharded output,
    and the kernel is handed a channel slice of a contiguous signal.
"""

import pytest
import torch

from hyperseg_torch.models import decoder as D
from hyperseg_torch.models import hyperseg_v1_0 as V1
from hyperseg_torch.nn import functional as F
from hyperseg_torch.nn.modules import BatchNorm2d, cast_weights
from hyperseg_torch.ops.kernels import patch_invres as PI
from hyperseg_torch.parallel import spatial as SP

from torch_parity import HYPERSEG_M_KW

ULPS = 4 * torch.finfo(torch.float32).eps   # a float32 unit's output, relative to its largest


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _m_model(train=False, **kw):
    """HyperSeg-M from seed 0 on the CPU, every BN bias uniform in [1, 2]."""
    model = V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", seed=0, train=train,
                                     **HYPERSEG_M_KW, **kw)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.bias.copy_(torch.rand(m.bias.shape, generator=g) + 1)
    return model


@pytest.fixture(scope="module")
def model():
    return _m_model()


def _image(dtype=torch.float32):
    return torch.randn(2, 3, 128, 256, generator=torch.Generator().manual_seed(2)).to(dtype)


def grouped_conv_route(self, x, s):
    """PatchConvUnit's forward before its eval route: the grouped conv's
    map, then apply_weights."""
    return self.apply_weights(x, self.weights(s))


def test_eval_forward_bit_equal_to_the_grouped_conv_route_float64(model, monkeypatch):
    m = model.double()
    try:
        with torch.no_grad():
            got = m(_image(torch.float64))
            monkeypatch.setattr(D.PatchConvUnit, "forward", grouped_conv_route)
            want = m(_image(torch.float64))
    finally:
        model.float()
    assert float(want.abs().max()) > 1.0
    assert torch.equal(got, want)


def test_eval_units_match_the_grouped_conv_route_float32(model, monkeypatch):
    """Each 1x1 unit of a float32 eval forward, on its own inputs: the
    generated map equals the grouped conv's, the unit's output is within
    ULPS of its largest magnitude of the grouped-conv route's."""
    seen = []
    eval_route = D.PatchConvUnit.forward

    def both(self, x, s):
        out = eval_route(self, x, s)
        gen = D.generate_map(s, self.route, self.holder.signal2weights.weight, x.dtype)
        want = grouped_conv_route(self, x, s)
        seen.append((torch.equal(gen, self.weights(s).permute(0, 2, 3, 1)),
                     float((out - want).abs().max() / want.abs().max())))
        return out
    monkeypatch.setattr(D.PatchConvUnit, "forward", both)
    with torch.no_grad():
        model(_image())
    assert len(seen) == 3
    assert all(equal for equal, _ in seen), seen
    assert all(err <= ULPS for _, err in seen), seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_generates_each_1x1_map_once_in_the_activation_dtype(model, monkeypatch, dtype):
    """An eval forward calls s2w_generate three times with out_dtype the
    activation dtype (the 1x1 units) and twice with the float32 default
    (K1 at levels 3-4), and never the grouped conv."""
    gen, conv = [], []
    real_gen, real_conv = PI.s2w_generate, D.apply_signal2weights

    def spy_gen(*a, **kw):
        gen.append(kw.get("out_dtype"))
        return real_gen(*a, **kw)

    def spy_conv(*a, **kw):
        conv.append(1)
        return real_conv(*a, **kw)
    monkeypatch.setattr(PI, "s2w_generate", spy_gen)
    monkeypatch.setattr(D, "apply_signal2weights", spy_conv)
    cast_weights(model, dtype)    # as on the card: conv weights in dtype, BN float32
    try:
        with torch.no_grad():
            out = model(_image(dtype))
    finally:
        cast_weights(model, torch.float32)
    assert out.dtype == dtype
    assert gen == [dtype] * 3 + [None] * 2 and not conv


@pytest.mark.parametrize("remat", [False, True])
def test_training_keeps_the_grouped_conv(monkeypatch, remat):
    """A training forward, with and without decoder remat, makes every
    hyper unit's map with the grouped conv (the three 1x1 units and the two
    k=3 units) and never calls s2w_generate."""
    gen, conv = [], []
    real_conv = D.apply_signal2weights

    def spy_conv(*a, **kw):
        conv.append(1)
        return real_conv(*a, **kw)
    monkeypatch.setattr(PI, "s2w_generate", lambda *a, **kw: gen.append(1))
    monkeypatch.setattr(D, "apply_signal2weights", spy_conv)
    model = _m_model(train=True, decoder_remat=remat)
    out = model(_image(), torch.Generator().manual_seed(3))
    assert out.requires_grad and out.shape == (2, 19, 128, 256)
    assert len(conv) == 5 and not gen


def test_spatial_eval_bands_equal_the_unsharded_unit(model, monkeypatch):
    """Level 1's unit in float64 on each of two bands of one process, x the
    band's rows and s its rows of the whole signal (SP.own_rows, a view
    that is no channel slice of a contiguous tensor): the bands make up the
    unsharded output bit for bit, and the signal s2w_generate is given is
    a channel slice of a contiguous tensor, as the kernel reads it."""
    u = model.decoder.level_1[0].double()
    g = torch.Generator().manual_seed(4)
    fh, fw, ph = 4, 6, 2
    x = torch.randn(2, u.in_ch, fh * ph, fw * ph, generator=g, dtype=torch.float64)
    s = torch.randn(2, u.route.signal_index + u.route.signal_ch + 3, fh, fw, generator=g,
                    dtype=torch.float64)
    signals = []
    real_gen = PI.s2w_generate

    def spy_gen(sl, *a, **kw):
        signals.append(sl)
        return real_gen(sl, *a, **kw)
    monkeypatch.setattr(PI, "s2w_generate", spy_gen)
    try:
        with torch.no_grad():
            whole = u(x, s)
            bands = []
            for i in range(2):
                sg = SP.SpatialGroup(None, i, 2, None, 0, 1)
                with F.spatial(sg):
                    xb = x[:, :, i * fh // 2 * ph:(i + 1) * fh // 2 * ph]
                    bands.append(u(xb, SP.own_rows(s, sg)))
    finally:
        u.float()
    assert torch.equal(torch.cat(bands, 2), whole)
    assert len(signals) == 3
    for sl in signals:
        b, c, h, w = sl.shape
        assert sl.stride()[1:] == (h * w, w, 1)
