"""The full-map forms of the patch-wise ops, batch_norm_multi and the
full-map InvResUnit against the JAX package, on the CPU.

Every input is made with numpy from a seed and handed to both sides (NHWC
and (B, fh, fw, P) on the JAX side, NCHW and (B, P, fh, fw) on the port's).
The forms are held within 1e-5 of the reference's largest magnitude in
float32; gradients, each scaled by its largest magnitude, within 1e-4. The
grids have fh, fw >= 2 and ph != pw, so an off-by-one halo at the reflected
border or between patches shows.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_tpu.models import decoder as JD
from hyperseg_tpu.nn import functional as JF
from hyperseg_tpu.ops import patch as JP
from hyperseg_torch.models import decoder as D
from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops import patch as P

from torch_parity import nchw, t

TOL = 1e-5          # forms, of the largest reference magnitude
GRAD_TOL = 1e-4     # gradients, each scaled by its largest magnitude

# (batch, channels, fh, fw, ph, pw, kernel)
GRIDS = [(2, 5, 3, 2, 6, 8, 3), (1, 4, 2, 3, 10, 6, 5), (2, 3, 2, 2, 4, 4, 3)]


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, f"{what}: vacuous comparison"
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max error {err:.3e} of scale {scale:.3e}"


def _blocked_to_jax(a):
    """The port's (B, C, fh, h, fw, w) -> the JAX (B, fh, h, fw, w, C)."""
    return np.asarray(a).transpose(0, 2, 3, 4, 5, 1)


def _weights(rng, b, fh, fw, p):
    """A weight map: (JAX (B, fh, fw, P), port (B, P, fh, fw))."""
    w = rng.randn(b, fh, fw, p).astype(np.float32)
    return w, t(w.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("grid", GRIDS)
def test_fullmap_pointwise_matches_jax(grid, groups):
    b, _, fh, fw, ph, pw, _ = grid
    cin, cout = 4, 6
    rng = np.random.RandomState(0)
    x = rng.randn(b, fh * ph, fw * pw, cin).astype(np.float32)
    wj, wt = _weights(rng, b, fh, fw, cout * cin // groups)
    want = JP.fullmap_pointwise(jnp.asarray(x), jnp.asarray(wj), fh, fw, cout, groups)
    got = P.fullmap_pointwise(t(nchw(x)), wt, fh, fw, cout, groups)
    _close(got, nchw(want), what="fullmap_pointwise")
    # and the port's own 6-D form
    gather = P.unblock_patches(P.patch_pointwise(P.block_patches(t(nchw(x)), fh, fw), wt,
                                                 cout, groups))
    _close(got, gather, what="fullmap_pointwise vs patch_pointwise")


@pytest.mark.parametrize("grid", GRIDS)
def test_halo_bands_pointwise_matches_jax(grid):
    b, c, fh, fw, ph, pw, k = grid
    out, pad = 7, k // 2
    rng = np.random.RandomState(1)
    x = rng.randn(b, fh * ph, fw * pw, c).astype(np.float32)
    wj, wt = _weights(rng, b, fh, fw, out * c)
    want = JP.halo_bands_pointwise(jnp.asarray(x), jnp.asarray(wj), fh, fw, pad, out)
    got = P.halo_bands_pointwise(t(nchw(x)), wt, fh, fw, pad, out)
    assert [tuple(g.shape) for g in got] == [
        (b, out, fh, pad, fw, pw + 2 * pad)] * 2 + [(b, out, fh, ph, fw, pad)] * 2
    for name, g, w in zip(("top", "bottom", "left", "right"), got, want):
        _close(_blocked_to_jax(g), w, what=f"halo band {name}")


@pytest.mark.parametrize("grid", GRIDS)
def test_assemble_halo_blocked_matches_jax_and_the_gather(grid):
    """The bands of x itself around x's blocked view are exactly the halo'd
    patches of extract_patches_with_halo; on random parts, the JAX
    assembly."""
    b, c, fh, fw, ph, pw, k = grid
    pad = k // 2
    rng = np.random.RandomState(2)
    parts = [rng.randn(b, fh, h, fw, w, c).astype(np.float32) for h, w in
             ((ph, pw), (pad, pw + 2 * pad), (pad, pw + 2 * pad), (ph, pad), (ph, pad))]
    want = JP.assemble_halo_blocked(*map(jnp.asarray, parts))
    got = P.assemble_halo_blocked(*(t(p.transpose(0, 5, 1, 2, 3, 4)) for p in parts))
    np.testing.assert_array_equal(_blocked_to_jax(got), np.asarray(want))

    x = t(rng.randn(b, c, fh * ph, fw * pw).astype(np.float32))
    eye = torch.eye(c).reshape(1, c * c, 1, 1).expand(b, c * c, fh, fw)
    bands = P.halo_bands_pointwise(x, eye, fh, fw, pad, c)
    xb = P.assemble_halo_blocked(x.view(b, c, fh, ph, fw, pw), *bands)
    halo = P.extract_patches_with_halo(x, fh, fw, (pad, pad))     # (B, fh, fw, C, h, w)
    np.testing.assert_array_equal(xb.permute(0, 2, 4, 1, 3, 5).numpy(), halo.numpy())


@pytest.mark.parametrize("grid", GRIDS)
def test_blocked_depthwise_valid_matches_jax(grid):
    b, c, fh, fw, ph, pw, k = grid
    rng = np.random.RandomState(3)
    xb = rng.randn(b, fh, ph + k - 1, fw, pw + k - 1, c).astype(np.float32)
    wj, wt = _weights(rng, b, fh, fw, c * k * k)
    want = JP.blocked_depthwise_valid(jnp.asarray(xb), jnp.asarray(wj), (k, k))
    got = P.blocked_depthwise_valid(t(xb.transpose(0, 5, 1, 2, 3, 4)), wt, (k, k))
    assert got.is_contiguous()
    _close(_blocked_to_jax(got), want, what="blocked_depthwise_valid")


@pytest.mark.parametrize("grid", GRIDS)
def test_fullmap_depthwise_matches_jax_and_the_gather(grid):
    b, c, fh, fw, ph, pw, k = grid
    rng = np.random.RandomState(4)
    x = rng.randn(b, fh * ph, fw * pw, c).astype(np.float32)
    wj, wt = _weights(rng, b, fh, fw, c * k * k)
    want = JP.fullmap_depthwise(jnp.asarray(x), jnp.asarray(wj), fh, fw, k)
    got = P.fullmap_depthwise(t(nchw(x)), wt, fh, fw, k)
    _close(got, nchw(want), what="fullmap_depthwise")
    xp = P.extract_patches_with_halo(t(nchw(x)), fh, fw, (k // 2, k // 2))
    gather = P.unblock_patches(P.patch_depthwise_valid(xp, wt, (k, k)))
    _close(got, gather, what="fullmap_depthwise vs the 6-D gather")


def test_forms_refuse_other_pad_modes():
    x, w = torch.zeros(1, 2, 8, 8), torch.zeros(1, 18, 2, 2)
    with pytest.raises(ValueError, match="reflect"):
        P.fullmap_depthwise(x, w, 2, 2, 3, mode="replicate")
    with pytest.raises(ValueError, match="reflect"):
        P.halo_bands_pointwise(x, torch.zeros(1, 4, 2, 2), 2, 2, 1, 2, mode="constant")


def _bn_parts(rng, c):
    """A map and four bands of unequal sizes, channel axis 1 (port) / last
    (JAX), with a per-channel offset so the mean matters."""
    shapes = [(2, c, 3, 6, 2, 8), (2, c, 3, 1, 2, 10), (2, c, 3, 1, 2, 10),
              (2, c, 3, 6, 2, 1), (2, c, 3, 6, 2, 1)]
    off = rng.randn(1, c, 1, 1, 1, 1) * 2
    return [(rng.randn(*s) * 1.5 + off).astype(np.float32) for s in shapes]


def test_batch_norm_multi_matches_jax_apply_bn_multi():
    """Outputs, the running-statistic updates (n counts every element of
    every part; the variance unbiased over it) and the gradients of the
    parts and the affine against jax.grad of apply_bn_multi."""
    c = 5
    rng = np.random.RandomState(5)
    parts = _bn_parts(rng, c)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    mean0 = (rng.randn(c) * 0.1).astype(np.float32)
    var0 = (rng.rand(c) + 0.5).astype(np.float32)
    cots = [rng.randn(*p.shape).astype(np.float32) for p in parts]
    jparts = [jnp.asarray(np.moveaxis(p, 1, -1)) for p in parts]
    jcots = [jnp.asarray(np.moveaxis(g, 1, -1)) for g in cots]

    def jloss(ps, g, bt):
        params = {"n.weight": g, "n.bias": bt, "n.running_mean": jnp.asarray(mean0),
                  "n.running_var": jnp.asarray(var0)}
        ctx = JF.Ctx(train=True)
        outs = JF.apply_bn_multi(params, "n", tuple(ps), ctx, eps=1e-5, momentum=0.1)
        return sum(jnp.sum(o * ct) for o, ct in zip(outs, jcots)), (outs, ctx.updates)

    (_, (jouts, upd)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jparts, jnp.asarray(gamma), jnp.asarray(beta))

    tparts = [t(p).requires_grad_() for p in parts]
    tg, tb = t(gamma).requires_grad_(), t(beta).requires_grad_()
    rm, rv = t(mean0.copy()), t(var0.copy())
    outs = F.batch_norm_multi(tparts, tg, tb, rm, rv, eps=1e-5, momentum=0.1)
    sum((o * t(ct)).sum() for o, ct in zip(outs, cots)).backward()

    for i, (o, jo) in enumerate(zip(outs, jouts)):
        _close(np.moveaxis(o.detach().numpy(), 1, -1), jo, what=f"part {i}")
    _close(rm, upd["n.running_mean"], what="running_mean")
    _close(rv, upd["n.running_var"], what="running_var")
    for i, (p, g) in enumerate(zip(tparts, jgrads[0])):
        _close(np.moveaxis(p.grad.numpy(), 1, -1), g, GRAD_TOL, f"d part {i}")
    _close(tg.grad, jgrads[1], GRAD_TOL, "d weight")
    _close(tb.grad, jgrads[2], GRAD_TOL, "d bias")


def test_batch_norm_multi_is_bn_of_the_union():
    """Against torch's own train-mode BN of the parts flattened and joined
    (float64): each part's gradient depends on the sums over all the parts,
    which a per-part BN would miss."""
    c = 3
    rng = np.random.RandomState(6)
    parts = _bn_parts(rng, c)
    cots = [rng.randn(*p.shape) for p in parts]
    gamma, beta = rng.rand(c) + 0.5, rng.randn(c)

    def flat(ts):
        return torch.cat([x.transpose(0, 1).reshape(c, -1) for x in ts], 1)[None]

    ref = [torch.tensor(p, dtype=torch.float64, requires_grad=True) for p in parts]
    g64 = torch.tensor(gamma, requires_grad=True)
    b64 = torch.tensor(beta, requires_grad=True)
    y = torch.nn.functional.batch_norm(flat(ref), None, None, g64, b64, training=True, eps=1e-5)
    (y * flat([torch.tensor(g) for g in cots])).sum().backward()

    tparts = [t(p).requires_grad_() for p in parts]
    tg = torch.tensor(gamma, dtype=torch.float32, requires_grad=True)
    tb = torch.tensor(beta, dtype=torch.float32, requires_grad=True)
    n = sum(p.size // c for p in parts)
    rm, rv = torch.zeros(c), torch.ones(c)
    outs = F.batch_norm_multi(tparts, tg, tb, rm, rv, eps=1e-5, momentum=1.0)
    sum((o * torch.tensor(g, dtype=torch.float32)).sum() for o, g in zip(outs, cots)).backward()
    _close(flat([o.detach() for o in outs]), y.detach(), what="outputs")
    joined = flat([torch.tensor(p, dtype=torch.float64) for p in parts])[0]
    _close(rv, joined.var(1, unbiased=True), what="unbiased variance over n")
    assert n == joined.shape[1]
    for p, r in zip(tparts, ref):
        _close(p.grad, r.grad, GRAD_TOL, "d part")
    _close(tg.grad, g64.grad, GRAD_TOL, "d weight")
    _close(tb.grad, b64.grad, GRAD_TOL, "d bias")


# (in_ch, out_ch, hidden, fh, fw, ph, pw, kernel): with and without the residual
UNITS = [(6, 6, 12, 3, 2, 6, 8, 3), (5, 7, 10, 2, 3, 8, 6, 3), (4, 4, 8, 2, 2, 10, 6, 5)]


def _unit_case(spec, seed):
    """The JAX unit and params, the port unit with the same BN tensors, and
    x, w on both sides."""
    cin, cout, hid, fh, fw, ph, pw, k = spec
    rng = np.random.RandomState(seed)
    junit = JD.InvResUnit(prefix="u", in_ch=cin, out_ch=cout, hidden=hid, kernel=k)
    unit = D.InvResUnit(cin, cout, hid, kernel=k, device="cpu")
    params = {}
    for i, ch in ((1, hid), (2, hid), (3, cout)):
        bn = getattr(unit, f"bn{i}")
        vals = {"weight": rng.rand(ch) + 0.5, "bias": rng.randn(ch) * 0.5,
                "running_mean": rng.randn(ch) * 0.1, "running_var": rng.rand(ch) + 0.5}
        for name, v in vals.items():
            v = v.astype(np.float32)
            params[f"u.bn{i}.{name}"] = jnp.asarray(v)
            getattr(bn, name).data.copy_(t(v))
    b = 2
    x = rng.randn(b, fh * ph, fw * pw, cin).astype(np.float32)
    w = (rng.randn(b, fh, fw, unit.hyper_params) * 0.3).astype(np.float32)
    return junit, params, unit, x, w


def _port_unit(unit, x, w, fullmap, train, monkeypatch):
    """The port unit's training route (_apply_eager) on (x, w) NHWC numpy
    with FULLMAP_INVRES set; returns (output NHWC, running statistics)."""
    monkeypatch.setattr(P, "FULLMAP_INVRES", fullmap)
    unit.train(train)
    saved = {k: v.clone() for k, v in unit.state_dict().items()}
    out = unit._apply_eager(t(nchw(x)), t(w.transpose(0, 3, 1, 2)))
    stats = {k: v.clone() for k, v in unit.state_dict().items() if "running" in k}
    unit.load_state_dict(saved)
    return out.detach().numpy().transpose(0, 2, 3, 1), stats


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("spec", UNITS)
def test_fullmap_unit_matches_jax_and_the_gather(spec, train, monkeypatch):
    """The port's full-map unit against the JAX _apply_fullmap and against
    the port's own 6-D gather route, in eval and in train: outputs and, in
    train, the running statistics of bn1 (over the halo'd multiset), bn2
    and bn3."""
    junit, params, unit, x, w = _unit_case(spec, 7)
    ctx = JF.Ctx(train=True) if train else None
    want = np.asarray(junit._apply_fullmap(params, jnp.asarray(x), jnp.asarray(w), ctx))
    got, stats = _port_unit(unit, x, w, True, train, monkeypatch)
    gather, gstats = _port_unit(unit, x, w, False, train, monkeypatch)
    _close(got, want, what="full-map unit vs JAX")
    _close(got, gather, what="full-map unit vs the gather route")
    if train:
        for i in (1, 2, 3):
            for s in ("running_mean", "running_var"):
                key = f"bn{i}.{s}"
                _close(stats[key], ctx.updates[f"u.{key}"], what=f"{key} vs JAX")
                _close(stats[key], gstats[key], what=f"{key} vs the gather route")
                assert not torch.equal(stats[key], getattr(getattr(unit, f"bn{i}"), s))


@pytest.mark.parametrize("spec", UNITS)
def test_fullmap_unit_gradients(spec, monkeypatch):
    """Gradients of sum(unit(x, w) * g) in training, for x, w and every BN
    affine: the port's full-map route against its gather route and against
    jax.grad of the JAX full-map unit."""
    junit, params, unit, x, w = _unit_case(spec, 8)
    cin, cout = spec[0], spec[1]
    rng = np.random.RandomState(9)
    cot = rng.randn(x.shape[0], x.shape[1], x.shape[2], cout).astype(np.float32)
    names = [f"bn{i}.{p}" for i in (1, 2, 3) for p in ("weight", "bias")]

    def jloss(xx, ww, pp):
        y = junit._apply_fullmap({**params, **pp}, xx, ww, JF.Ctx(train=True))
        return jnp.sum(y * cot)

    affine = {f"u.{n}": params[f"u.{n}"] for n in names}
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(w), affine)
    want = {"x": nchw(jg[0]), "w": np.asarray(jg[1]).transpose(0, 3, 1, 2),
            **{n: np.asarray(jg[2][f"u.{n}"]) for n in names}}

    def port_grads(fullmap):
        monkeypatch.setattr(P, "FULLMAP_INVRES", fullmap)
        unit.train()
        unit.zero_grad()
        saved = {k: v.clone() for k, v in unit.state_dict().items()}
        xt = t(nchw(x)).requires_grad_()
        wt = t(w.transpose(0, 3, 1, 2)).requires_grad_()
        (unit._apply_eager(xt, wt) * t(nchw(cot))).sum().backward()
        unit.load_state_dict(saved)
        mods = dict(unit.named_parameters())
        return {"x": xt.grad.numpy(), "w": wt.grad.numpy(),
                **{n: mods[n].grad.numpy().copy() for n in names}}

    got, gather = port_grads(True), port_grads(False)
    for n in want:
        _close(got[n], want[n], GRAD_TOL, f"d {n} vs jax.grad")
        _close(got[n], gather[n], GRAD_TOL, f"d {n} vs the gather route")


def test_fullmap_route_builds_no_6d_tensor(monkeypatch):
    """With FULLMAP_INVRES the training unit never calls the gather."""
    _, _, unit, x, w = _unit_case(UNITS[0], 10)
    monkeypatch.setattr(P, "extract_patches_with_halo",
                        lambda *a, **k: pytest.fail("the 6-D gather ran"))
    _port_unit(unit, x, w, True, True, monkeypatch)


def test_patchconv_fullmap_gate_on_meta(monkeypatch):
    """PatchConvUnit's full-map forms run in training only (eval keeps the
    batched matmul and the kernels), from FULLMAP_MIN_BATCH on, the 1x1
    only with FULLMAP_POINTWISE, and only where the JAX gate allows it:
    pad kernel // 2 and a grid that divides the map."""
    hits = []
    for fn in ("fullmap_pointwise", "fullmap_depthwise"):
        real = getattr(P, fn)
        monkeypatch.setattr(P, fn, lambda *a, _r=real, _n=fn, **k: (hits.append(_n),
                                                                    _r(*a, **k))[1])

    def run(unit, b, train, hw=16):
        hits.clear()
        unit.train(train)
        x = torch.empty(b, unit.in_ch, hw, hw, device="meta")
        unit.apply_map(x, torch.empty(b, 2, 2, unit.hyper_params, device="meta"))
        return list(hits)

    pw = D.PatchConvUnit(4, 6, bn=True, act="relu", device="meta")
    dw = D.PatchConvUnit(4, 4, kernel=3, groups=4, pad=1, bn=True, act="relu6",
                         device="meta")
    assert not pw.training and not dw.training          # built in eval mode
    monkeypatch.setattr(P, "FULLMAP_MIN_BATCH", 2)
    monkeypatch.setattr(P, "FULLMAP_POINTWISE", True)
    assert run(pw, 4, False) == [] and run(dw, 4, False) == []    # eval: never
    assert run(pw, 1, True) == [] and run(dw, 1, True) == []      # below the batch
    assert run(pw, 2, True) == ["fullmap_pointwise"]
    assert run(dw, 2, True) == ["fullmap_depthwise"]
    assert run(dw, 2, True, hw=15) == []                          # the grid must divide
    monkeypatch.setattr(P, "FULLMAP_POINTWISE", False)
    assert run(pw, 2, True) == [] and run(dw, 2, True) == ["fullmap_depthwise"]
    grouped = D.PatchConvUnit(4, 4, kernel=3, groups=2, pad=1, device="meta")
    assert run(grouped, 2, True) == []                            # not a depthwise


@pytest.mark.parametrize("kernel", [1, 3])
def test_patchconv_routes_agree_in_training(kernel, monkeypatch):
    """The training PatchConvUnit gives the same output, BN statistics and
    gradients on its full-map and 6-D routes (v0_1's expand and
    depthwise), and the full-map run took its full-map form."""
    rng = np.random.RandomState(11)
    cin = 5
    cout = 7 if kernel == 1 else cin
    unit = D.PatchConvUnit(cin, cout, kernel=kernel, groups=1 if kernel == 1 else cin,
                           pad=kernel // 2, bn=True, act="relu6", device="cpu")
    unit[-1].weight.data.uniform_(0.5, 1.5)
    x = t(rng.randn(2, cin, 12, 16).astype(np.float32))
    w = t(rng.randn(2, 3, 2, unit.hyper_params).astype(np.float32))
    g = t(rng.randn(2, cout, 12, 16).astype(np.float32))
    unit.train()
    form = "fullmap_pointwise" if kernel == 1 else "fullmap_depthwise"
    hits = []
    real = getattr(P, form)
    monkeypatch.setattr(P, form, lambda *a, **k: (hits.append(form), real(*a, **k))[1])

    def run(fullmap):
        for lever, value in P.ROUTES["fullmap" if fullmap else "gather"].items():
            monkeypatch.setattr(P, lever, value)
        hits.clear()
        unit.zero_grad()
        saved = {k: v.clone() for k, v in unit.state_dict().items()}
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = unit.apply_map(xx, ww)
        (y * g).sum().backward()
        stats = unit[-1].running_var.clone()
        unit.load_state_dict(saved)
        assert hits == ([form] if fullmap else [])
        return y.detach(), stats, xx.grad, ww.grad, unit[-1].weight.grad.clone()

    for a, b in zip(run(True), run(False)):
        _close(a, b, GRAD_TOL, "full-map vs 6-D")
