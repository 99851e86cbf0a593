"""The port's span recorder (hyperseg_torch/utils/trace.py): off it is one
shared no-op; on it nests spans and stamps requests; its clock maps onto a
torch.profiler trace; and the program's spans (model.*, kernel.*,
train_step.*) come out of a CPU forward and training step of HyperSeg-M
and a forward of HyperSeg-L VOC, each kernel span with arguments enough to
count its bytes and operations."""

import json
import math
import os
import tempfile
from collections import Counter

import pytest
import torch

from hyperseg_torch.ops.kernels import mbconv as K4
from hyperseg_torch.ops.kernels import patch_invres as PI
from hyperseg_torch.ops.kernels import resize as K6
from hyperseg_torch.ops.kernels import stem as K3
from hyperseg_torch.utils import trace

M_ARGS = dict(levels=2, kernel_sizes=[1, 1, 1, 3, 3], level_channels=[64, 32, 16, 16, 16],
              expand_ratio=2, weight_groups=[32, 16, 8, 16, 4], num_classes=19)
# kernel launches of one HyperSeg-M eval forward on the card (K1's
# generation - the three 1x1 levels' maps and the two k=3 levels' K1 - and
# K2's unit, K3, K4a, K4b, K5, K6), by LAUNCHES key
M_LAUNCHES = {"patch_invres_s2w": 5, "patch_invres": 2, "stem": 1, "mbconv_dw": 2,
              "mbconv_project": 5, "mbconv_expand_dw": 21, "resize_bilinear": 5}


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty again afterwards."""
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


@pytest.fixture
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_off_is_one_shared_noop(monkeypatch):
    """Off: span and request return the shared no-op, whose target is None;
    no clock is read and no record_function is built, even under a
    profiler; nothing is recorded."""
    trace.disable()
    trace.reset()

    def forbidden(*a, **k):
        raise AssertionError("the recorder is off")

    monkeypatch.setattr(trace.time, "time_ns", forbidden)
    monkeypatch.setattr(trace, "record_function", forbidden)
    monkeypatch.setattr(trace._profiler, "_is_profiler_enabled", True)
    ctx = trace.span("model.backbone", nodes=3)
    assert ctx is trace.NOOP and trace.span("x") is ctx and trace.request(1) is ctx
    with ctx as attrs, trace.request(4):
        assert attrs is None
    assert trace.spans() == []


def test_nesting_and_requests(recorder):
    with trace.span("outer", a=1):
        with trace.request(7):
            with trace.span("inner") as attrs:
                attrs["bytes"] = 5
            with trace.span("second"):
                with trace.span("leaf"):
                    pass
        with trace.span("after"):
            pass
    with trace.span("top"):
        pass
    sp = trace.spans()
    assert [s["name"] for s in sp] == ["outer", "inner", "second", "leaf", "after", "top"]
    assert [s["parent"] for s in sp] == [-1, 0, 0, 2, 0, -1]
    assert [s["request"] for s in sp] == [None, 7, 7, 7, None, None]
    assert sp[0]["attrs"] == {"a": 1} and sp[1]["attrs"] == {"bytes": 5}
    for s in sp:
        assert 0 < s["start"] <= s["end"]
        if s["parent"] >= 0:
            p = sp[s["parent"]]
            assert p["start"] <= s["start"] and s["end"] <= p["end"]
    trace.reset()
    assert trace.spans() == []


def test_disable_keeps_open_spans_whole(recorder):
    with trace.span("open"):
        trace.disable()
        with trace.span("not recorded"):
            pass
    (s,) = trace.spans()
    assert s["name"] == "open" and s["end"] >= s["start"] > 0


def test_clock_maps_onto_the_profiler_trace(recorder):
    """200 spans, each around one small op under a CPU profiler: mapped by
    the trace's baseTimeNanoseconds, each span holds its op's cpu_op event
    to within 20 us, and each shows in the trace as a range of its name."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(200):
            with trace.span(f"op{i}"):
                x.add_(1)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    base = doc["baseTimeNanoseconds"]
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    ops = sorted((e for e in events if e["name"] == "aten::add_"), key=lambda e: e["ts"])
    ranges = {e["name"] for e in events if e["name"].startswith("op")}
    sp = trace.spans()
    assert len(ops) == len(sp) == 200 and ranges == {s["name"] for s in sp}
    for s, op in zip(sp, ops):
        lo, hi = (s["start"] - base) / 1e3, (s["end"] - base) / 1e3
        assert lo - 20 <= op["ts"] and op["ts"] + op["dur"] <= hi + 20, (s, op)


def _m_model(train=False):
    from hyperseg_torch.models import hyperseg_v1_0 as V1
    return V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", train=train, **M_ARGS)


def test_forward_records_model_and_kernel_spans(recorder, two_threads):
    """A CPU forward of HyperSeg-M: the factory's model.build span, the
    three layer spans in order, and one kernel.* span a wrapper call
    through the twins, as many of each as the card launches, each inside
    a layer span and with arguments that count its bytes and operations.
    Of K5's 21 spans (B1's blocks 2-22) the 12 of its 5x5 blocks carry a
    5x5 w_dw."""
    model = _m_model()
    (build,) = trace.spans()
    assert build["name"] == "model.build" and build["end"] > build["start"]
    trace.reset()
    with torch.no_grad():
        model(torch.randn(1, 3, 128, 256))
    sp = trace.spans()
    layers = [s for s in sp if s["name"].startswith("model.")]
    assert [s["name"] for s in layers] == ["model.backbone", "model.context_head",
                                           "model.decoder"]
    assert all(s["parent"] == -1 for s in layers)
    kernels = [s for s in sp if s["name"].startswith("kernel.")]
    assert Counter(s["name"][7:] for s in kernels) == M_LAUNCHES
    k5 = Counter(s["attrs"]["w_dw"][0] for s in kernels if s["name"] == "kernel.mbconv_expand_dw")
    assert sum(n for shape, n in k5.items() if shape[2:] == (5, 5)) == 12
    assert len(sp) == len(layers) + len(kernels)
    for s in kernels:
        assert sp[s["parent"]]["name"] in ("model.backbone", "model.decoder")
        nbytes, flops = counted(s["name"][7:], s["attrs"])
        assert nbytes > 0 and flops > 0


def test_v01_forward_records_one_k7_span_a_hyper_unit(recorder, two_threads):
    """A CPU forward of HyperSeg-L VOC at 128x192: the three layer spans,
    every kernel span inside the backbone's or the decoder's, and one
    kernel.patch_invres_v01 span for each of the four inverted-residual
    levels, inside model.decoder, whose arguments name the unit the
    benchmark's K7 roofline counts: the level's input, its (B, fh, fw, P)
    weight map, hidden and output widths, at the level's size."""
    from hyperseg_torch.models import hyperseg_v0_1 as V0
    model = V0.hyperseg_efficientnet("efficientnet-b3", device="cpu", levels=3,
                                     kernel_sizes=(1, 1, 3, 3, 3, 3), expand_ratio=2,
                                     weight_groups=16, num_classes=21)
    trace.reset()
    with torch.no_grad():
        model(torch.randn(1, 3, 128, 192))
    sp = trace.spans()
    assert [s["name"] for s in sp if s["name"].startswith("model.")] == [
        "model.backbone", "model.context_head", "model.decoder"]
    k7 = [s for s in sp if s["name"] == "kernel.patch_invres_v01"]
    units = [u for lv in range(6) for u in getattr(model.decoder, f"level_{lv}")
             if getattr(u, "uses_k7", False)]
    assert len(k7) == len(units) == 4
    for s, u, (h, w) in zip(k7, units, [(16, 24), (32, 48), (64, 96), (128, 192)]):
        assert sp[s["parent"]]["name"] == "model.decoder"
        a = s["attrs"]
        assert a["x"] == ((1, u.in_ch, h, w), "float32")
        assert a["w"] == ((1, 4, 6, u.hyper_params), "float32")
        assert a["bn1"][0][0] == (u.hidden,) and a["out"] == ((1, u.out_ch, h, w), "float32")
        nbytes, flops = counted("patch_invres_v01", a)
        assert nbytes > 0 and flops > 0
    assert {sp[s["parent"]]["name"] for s in sp if s["name"].startswith("kernel.")} == {
        "model.backbone", "model.decoder"}


def test_train_step_records_its_phases_in_order(recorder, two_threads):
    """A HyperSeg-M training step on the CPU: the four train_step.* spans,
    in order, at the top; the forward's layer and kernel spans inside
    train_step.forward."""
    from hyperseg_torch.train import losses as L, schedule as S, step as T
    model = _m_model(train=True)
    opt, sched = T.make_optimizer(model.parameters(), S.poly_lr(1e-3, 10))
    step = T.make_train_step(model, L.BootstrappedCrossEntropyLoss(ignore_index=255), opt,
                             sched, num_classes=19)
    g = torch.Generator().manual_seed(0)
    img = torch.randn(2, 3, 64, 128, generator=g)
    lbl = torch.randint(0, 19, (2, 64, 128), generator=g)
    trace.reset()
    step(img, lbl, torch.Generator().manual_seed(1))
    sp = trace.spans()
    top = [s for s in sp if s["parent"] == -1]
    assert [s["name"] for s in top] == ["train_step.forward", "train_step.backward",
                                        "train_step.optimizer", "train_step.metrics"]
    assert all(a["end"] <= b["start"] for a, b in zip(top, top[1:]))
    forward = sp.index(top[0])
    inside = {s["name"] for s in sp if s["parent"] == forward}
    assert {"model.backbone", "model.context_head", "model.decoder"} <= inside
    names = {s["name"] for s in sp}
    assert "kernel.stem_conv" in names and "kernel.resize_bilinear" in names


ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}


def _tensors(v):
    """The (shape, dtype name) pairs of one described argument."""
    if isinstance(v, tuple) and len(v) == 2 and isinstance(v[1], str):
        return [v]
    if isinstance(v, list):
        return [t for u in v for t in _tensors(u)]
    return []


def counted(name, a):
    """(bytes, flops) of a launch from its span's described arguments: each
    argument tensor read or written once (of K1's weight the p rows the map
    takes), 2 x the multiply-adds its shapes need."""
    out = math.prod(a["out"][0])
    if name == "patch_invres_s2w":
        (_, per_group, _, _), dt = a["w_s2w"]
        nbytes = sum(math.prod(sh) * ITEMSIZE[d] for sh, d in (a["s"], a["out"]))
        return nbytes + a["out"][0][3] * per_group * ITEMSIZE[dt], 2 * per_group * out
    nbytes = sum(math.prod(sh) * ITEMSIZE[d] for v in a.values() for sh, d in _tensors(v))
    if name in ("stem", "stem_conv"):
        flops = 54 * out
    elif name == "mbconv_dw":
        flops = 18 * out
    elif name == "mbconv_project":
        flops = 2 * a["h"][0][1] * out
    elif name == "mbconv_expand_dw":
        # the expand at every input pixel, the kxk depthwise at every output pixel
        b, cin, h, w = a["x"][0]
        k = a["w_dw"][0][-1]
        flops = 2 * cin * b * a["w_expand"][0][0] * h * w + 2 * k * k * out
    elif name in ("patch_invres", "patch_invres_v01"):
        # each patch's expand over the patch and its halo, kxk depthwise, projection
        b, cin, h, w = a["x"][0]
        _, fh, fw, _ = a["w"][0]
        hidden, out_ch, k = a["bn1"][0][0][0], a["out"][0][1], a.get("kernel", 3)
        ph, pw = h // fh, w // fw
        flops = 2 * b * fh * fw * ((ph + k - 1) * (pw + k - 1) * cin * hidden
                                   + ph * pw * hidden * (k * k + out_ch))
    else:
        assert name == "resize_bilinear", name
        flops = 8 * out   # four taps an output element
    return nbytes, flops


def _bn(c):
    return tuple(torch.rand(c) + 0.5 for _ in range(4))


def _cases():
    """(wrapper call, [(span name, its tensors, hand-counted flops)])."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    bf = torch.bfloat16
    x3, w3 = r(2, 3, 16, 32, dtype=bf), r(8, 3, 3, 3, dtype=bf)
    bn8 = _bn(8)
    x, wdw, bn16 = r(2, 16, 8, 12, dtype=bf), r(16, 1, 3, 3, dtype=bf), _bn(16)
    se, wp, bn24, res = r(2, 16), r(24, 16, 1, 1, dtype=bf), _bn(24), r(2, 24, 8, 12, dtype=bf)
    we, bn32 = r(32, 16, 1, 1, dtype=bf), _bn(32)
    wd32, wd32k5 = r(32, 1, 3, 3, dtype=bf), r(32, 1, 5, 5, dtype=bf)
    # a k=3 unit: 8 in, 12 hidden, 8 out, on 2x3 patches of 4x4
    xu, hid = r(2, 8, 8, 12, dtype=bf), 12
    p = PI.hyper_params(8, hid, 8, 3)
    wmap = r(2, 2, 3, p)
    bn12, bn8u = _bn(hid), _bn(8)
    sig, groups = r(2, 24, 2, 3, dtype=bf), 4
    n_out = -(-p // groups) * groups
    ws2w = r(n_out, 24 // groups, 1, 1, dtype=bf)
    v01map = r(2, 2, 3, p, dtype=bf)
    xr = r(2, 5, 6, 7, dtype=bf)
    unit = 2 * 2 * 2 * 3 * (6 * 6 * 8 * hid + 4 * 4 * hid * (9 + 8))
    out_unit = torch.empty(2, 8, 8, 12, dtype=bf)
    return {
        "stem": (lambda: K3.stem(x3, w3, bn8),
                 [("kernel.stem", [x3, w3, *bn8, torch.empty(2, 8, 8, 16, dtype=bf)],
                   2 * 27 * 8 * 8 * 16 * 2)]),
        "stem_conv": (lambda: K3.stem_conv(x3, w3),
                      [("kernel.stem_conv", [x3, w3, torch.empty(2, 8, 8, 16, dtype=bf)],
                        2 * 27 * 8 * 8 * 16 * 2)]),
        "mbconv_dw": (lambda: K4.mbconv_dw(x, wdw, bn16),
                      [("kernel.mbconv_dw", [x, wdw, *bn16, torch.empty_like(x)],
                        2 * 9 * x.numel())]),
        "mbconv_project": (lambda: K4.mbconv_project(x, se, wp, bn24, residual=res),
                           [("kernel.mbconv_project",
                             [x, se, wp, *bn24, res, torch.empty_like(res)],
                             2 * 16 * 24 * 2 * 8 * 12)]),
        "mbconv_expand_dw_s1": (
            lambda: K4.mbconv_expand_dw(x, we, bn32, wd32, bn32, 1, ((1, 1), (1, 1))),
            [("kernel.mbconv_expand_dw",
              [x, we, *bn32, wd32, *bn32, torch.empty(2, 32, 8, 12, dtype=bf)],
              2 * 2 * 32 * 16 * 8 * 12 + 2 * 9 * 2 * 32 * 8 * 12)]),
        "mbconv_expand_dw_s2": (
            lambda: K4.mbconv_expand_dw(x, we, bn32, wd32, bn32, 2, ((0, 1), (0, 1))),
            [("kernel.mbconv_expand_dw",
              [x, we, *bn32, wd32, *bn32, torch.empty(2, 32, 4, 6, dtype=bf)],
              2 * 2 * 32 * 16 * 8 * 12 + 2 * 9 * 2 * 32 * 4 * 6)]),
        "mbconv_expand_dw_k5_s1": (
            lambda: K4.mbconv_expand_dw(x, we, bn32, wd32k5, bn32, 1, ((2, 2), (2, 2))),
            [("kernel.mbconv_expand_dw",
              [x, we, *bn32, wd32k5, *bn32, torch.empty(2, 32, 8, 12, dtype=bf)],
              2 * 2 * 32 * 16 * 8 * 12 + 2 * 25 * 2 * 32 * 8 * 12)]),
        "mbconv_expand_dw_k5_s2": (
            lambda: K4.mbconv_expand_dw(x, we, bn32, wd32k5, bn32, 2, ((1, 2), (1, 2))),
            [("kernel.mbconv_expand_dw",
              [x, we, *bn32, wd32k5, *bn32, torch.empty(2, 32, 4, 6, dtype=bf)],
              2 * 2 * 32 * 16 * 8 * 12 + 2 * 25 * 2 * 32 * 4 * 6)]),
        "patch_invres": (
            lambda: PI.patch_invres(xu, wmap, hidden=hid, out_ch=8, bn1=bn12, bn2=bn12,
                                    bn3=bn8u),
            [("kernel.patch_invres", [xu, wmap, *bn12, *bn12, *bn8u, out_unit], unit)]),
        "patch_invres_s2w": (
            lambda: PI.patch_invres_s2w(xu, sig, ws2w, groups=groups, hidden=hid, out_ch=8,
                                        bn1=bn12, bn2=bn12, bn3=bn8u),
            [("kernel.patch_invres_s2w", [sig, ws2w[:p], torch.empty_like(wmap)],
              2 * (24 // groups) * 2 * 2 * 3 * p),
             ("kernel.patch_invres", [xu, wmap, *bn12, *bn12, *bn8u, out_unit], unit)]),
        "patch_invres_v01": (
            lambda: PI.patch_invres_v01(xu, v01map, hidden=hid, out_ch=8, bn1=bn12,
                                        bn2=bn12, bn3=bn8u),
            [("kernel.patch_invres_v01", [xu, v01map, *bn12, *bn12, *bn8u, out_unit], unit)]),
        "resize_bilinear": (lambda: K6.resize_bilinear(xr, (12, 14)),
                            [("kernel.resize_bilinear",
                              [xr, torch.empty(2, 5, 12, 14, dtype=bf)],
                              8 * 2 * 5 * 12 * 14)]),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_kernel_span_counts_bytes_and_flops(recorder, case):
    """A wrapper's span on the twin describes its arguments fully enough to
    count the launch: bytes from the described shapes and dtypes equal the
    nbytes of its input, weight and output tensors, one for each argument
    (of K1's weight the rows it reads), and flops the hand count of 2 x its
    multiply-adds."""
    call, want = _cases()[case]
    call()
    sp = trace.spans()
    assert [s["name"] for s in sp] == [n for n, _, _ in want]
    for s, (_, tensors, flops) in zip(sp, want):
        assert counted(s["name"][7:], s["attrs"]) == (sum(t.nbytes for t in tensors), flops)
