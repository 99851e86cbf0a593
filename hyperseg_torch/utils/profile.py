"""Profiling: analytic FLOPs/params tables, FLOPs by module, timing.

Counterpart of hyperseg_tpu/utils/profile.py (reference utils/profile.py,
MACs and params per module, and utils/meta_profile.py, which adds the
generated hyper-params column of the dynamic layers):

  * `model_profile`: the analytic walk over the static plans (the backbone's
    MBConv blocks, the decoder's hyper units and their signal2weights) -
    params, MACs, and generated params per patch, as a table; the same rows
    as the JAX package's for the same arch;
  * `flops_by_scope`: FLOPs per module, counted by
    `torch.utils.flop_counter.FlopCounterMode` over one forward. It counts
    ATen ops: on the CPU every kernel wrapper runs its plain twin and is
    counted; on the card the hand-written kernels' ops are not ATen ops and
    count 0, so count on the CPU;
  * `xla_cost`: the JAX package reads XLA's compiled cost analysis; here the
    FlopCounterMode total of one forward (no bytes accessed: nothing here
    models the memory traffic after fusion);
  * `wall_clock`: seconds per call, by CUDA events on the card.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, Mapping, Tuple

import numpy as np
import torch


@dataclass
class Row:
    name: str
    params: int = 0
    hyper_params: int = 0   # generated at runtime per patch (meta profiler column)
    macs: int = 0


def _state(params) -> Mapping[str, torch.Tensor]:
    return params.state_dict() if isinstance(params, torch.nn.Module) else params


def count_params(params) -> Tuple[int, int]:
    """(total, trainable) element counts of a model's state dict (or a state
    dict); the BN running statistics are not trainable."""
    sd = _state(params)
    total = sum(math.prod(v.shape) for v in sd.values())
    trainable = sum(math.prod(v.shape) for k, v in sd.items()
                    if not k.endswith((".running_mean", ".running_var")))
    return total, trainable


def _conv_macs(oh, ow, kh, kw, cin, cout, groups=1):
    return oh * ow * kh * kw * (cin // groups) * cout


def backbone_rows(backbone, in_hw) -> Tuple[List[Row], tuple]:
    """Per-block profile of the EfficientNet plan; returns the rows and the
    (h, w) of the last (stride-32) level."""
    rows = []
    stem_ch = backbone._conv_stem.weight.shape[0]
    plans = [blk.plan for blk in backbone._blocks]
    h, w = in_hw[0] // 2, in_hw[1] // 2
    rows.append(Row("_conv_stem", params=9 * backbone.in_channels * stem_ch,
                    macs=_conv_macs(h, w, 3, 3, backbone.in_channels, stem_ch)))
    for i, bp in enumerate(plans):
        mid = bp.in_ch * bp.expand
        p = m = 0
        if bp.expand != 1:
            p += bp.in_ch * mid
            m += _conv_macs(h, w, 1, 1, bp.in_ch, mid)
        oh, ow = -(-h // bp.stride), -(-w // bp.stride)
        p += bp.kernel * bp.kernel * mid
        m += _conv_macs(oh, ow, bp.kernel, bp.kernel, mid, mid, groups=mid)
        if bp.se_ch is not None:
            p += mid * bp.se_ch * 2 + bp.se_ch + mid
            m += mid * bp.se_ch * 2
        p += mid * bp.out_ch
        m += _conv_macs(oh, ow, 1, 1, mid, bp.out_ch)
        rows.append(Row(f"_blocks.{i}", params=p, macs=m))
        h, w = oh, ow
    rows.append(Row("_conv_head", params=plans[-1].out_ch * backbone.head_ch,
                    macs=_conv_macs(h, w, 1, 1, plans[-1].out_ch, backbone.head_ch)))
    return rows, (h, w)


def _levels(decoder):
    """The decoder's hyper units, one list per level, coarsest first."""
    if hasattr(decoder, "level_blocks"):       # the unify decoder
        return list(decoder.level_blocks)
    return [getattr(decoder, f"level_{lv}") for lv in range(decoder.levels)]


def decoder_rows(decoder, s_hw) -> List[Row]:
    """Per-unit profile of a decoder, with the meta column: each unit's
    `hyper_params` is its generated weight count per patch, and its
    signal2weights conv adds static params and MACs on the signal grid;
    the dynamic compute counts hyper_params MACs per pixel of the level."""
    rows = []
    sh, sw = s_hw
    for lv, units in enumerate(_levels(decoder)):
        h, w = sh * 2 ** lv, sw * 2 ** lv
        for u in units:
            p = m = 0
            route = getattr(u, "route", None)
            if route is not None:
                p += (route.signal_ch // route.groups) * route.out_ch
                m += sh * sw * (route.signal_ch // route.groups) * route.out_ch
            m += h * w * int(u.hyper_params)
            rows.append(Row(f"level_{lv}/{type(u).__name__}", params=p,
                            hyper_params=int(u.hyper_params), macs=m))
    for i, r in enumerate(getattr(decoder, "routes", None) or []):
        rows.append(Row(f"weight_blocks.{i}", params=(r.signal_ch // r.groups) * r.out_ch,
                        macs=sh * sw * (r.signal_ch // r.groups) * r.out_ch))
    return rows


def model_profile(model, input_hw=(512, 1024), print_table=True):
    """Analytic profile of a HyperGen model. Returns (rows, totals)."""
    rows, s_hw = backbone_rows(model.backbone, input_hw)
    rows += decoder_rows(model.decoder, s_hw)
    total = Row("TOTAL", params=sum(r.params for r in rows),
                hyper_params=sum(r.hyper_params for r in rows),
                macs=sum(r.macs for r in rows))
    if print_table:
        fmt = "{:<38}{:>14}{:>14}{:>16}"
        print(fmt.format("module", "params", "hyper-params", "MACs"))
        for r in rows + [total]:
            print(fmt.format(r.name, f"{r.params:,}", f"{r.hyper_params:,}", f"{r.macs:,}"))
    return rows, total


def _shape(obj):
    if isinstance(obj, torch.Tensor):
        return tuple(obj.shape)
    if isinstance(obj, (list, tuple)):
        return next((s for s in map(_shape, obj) if s), None)
    return None


def flops_by_scope(model, *args, max_depth=None):
    """FLOPs of model(*args) by module: [(scope, flops, in_shape, out_shape)]
    in the order the modules were entered, scope the dotted module name
    clipped to max_depth components ('' the model's own ops). Each row
    counts the ops of its module outside its listed submodules, so the rows
    sum to the total (FlopCounterMode: ATen ops only, see the module's
    docstring)."""
    from torch.utils.flop_counter import FlopCounterMode
    names = {m: n for n, m in model.named_modules()
             if max_depth is None or not n or len(n.split(".")) <= max_depth}
    shapes = {}

    def enter(mod, inputs):
        shapes.setdefault(names[mod], [_shape(inputs), None])

    def leave(mod, inputs, output):
        shapes[names[mod]][1] = _shape(output)
    handles = [h for m in names for h in (m.register_forward_pre_hook(enter),
                                          m.register_forward_hook(leave))]
    try:
        depth = 999 if max_depth is None else max_depth + 1
        with FlopCounterMode(display=False, depth=depth) as counter, torch.no_grad():
            model(*args)
    finally:
        for h in handles:
            h.remove()
    root = type(model).__name__
    inclusive = {k[len(root) + 1:]: sum(ops.values())
                 for k, ops in counter.get_flop_counts().items()
                 if k == root or k.startswith(root + ".")}

    def parent(k):
        return k.rsplit(".", 1)[0] if "." in k else ""
    return [(name, inclusive.get(name, 0) - sum(v for k, v in inclusive.items()
                                                if k and k != name and parent(k) == name),
             *shapes[name]) for name in shapes]


def params_by_scope(params, max_depth=None):
    """Element counts of a model's state dict (or a state dict) by dotted
    prefix clipped to max_depth components (count_parameters per module)."""
    out = {}
    for k, v in _state(params).items():
        parts = k.split(".")[:-1]
        if max_depth is not None:
            parts = parts[:max_depth]
        key = ".".join(parts)
        out[key] = out.get(key, 0) + math.prod(v.shape)
    return out


def assign_params_to_scopes(params, scopes):
    """Assign each state-dict key to the longest scope (a dotted module name)
    that prefixes it; keys matching none go to the '' (top) row if present.
    No double counting: the column sums to the model total."""
    counts = {s: 0 for s in scopes}
    for k, v in _state(params).items():
        best = max((s for s in scopes if s and (k == s or k.startswith(s + "."))),
                   key=len, default="" if "" in counts else None)
        if best is not None:
            counts[best] += math.prod(v.shape)
    return counts


def print_scope_table(rows, params=None):
    """The reference's print_summary table (profile.py:66-92): Layer | Shape
    Mapping | Params | FLOPs, over flops_by_scope rows; `params`, a model or
    state dict, is counted on the deepest matching row."""
    by_scope = assign_params_to_scopes(params, [r[0] for r in rows]) if params is not None else {}
    table = []
    for scope, fl, in_sh, out_sh in rows:
        shapes = f"{list(in_sh) if in_sh else '?'} -> {list(out_sh) if out_sh else '?'}"
        table.append((scope or "(top)", shapes, f"{by_scope.get(scope, 0):,}",
                      f"{fl / 1e9:.3f}B"))
    total_fl = sum(r[1] for r in rows)
    total_p = count_params(params)[0] if params is not None else 0
    table.append(("TOTAL", "", f"{total_p:,}" if params is not None else "",
                  f"{total_fl / 1e9:.3f}B"))
    titles = ("Scope", "Shape Mapping", "Params", "FLOPs")
    widths = [max(len(str(r[i])) for r in table + [titles]) for i in range(4)]
    line = "-" * (sum(widths) + 6)
    print(line)
    print("  ".join(f"{t:^{w}}" for t, w in zip(titles, widths)))
    print("=" * (sum(widths) + 6))
    for i, r in enumerate(table):
        if i == len(table) - 1:
            print("=" * (sum(widths) + 6))
        print("  ".join(f"{str(c):>{w}}" for c, w in zip(r, widths)))
    print(line)


def xla_cost(fn, *args):
    """{'flops': the FlopCounterMode total of fn(*args)}: the counterpart of
    the JAX package's compiled-cost analysis. It has no 'bytes accessed':
    eager PyTorch compiles no program whose traffic could be read, and
    FlopCounterMode counts ATen ops only (the hand-written kernels' ops on
    the card count 0)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return {"flops": counter.get_total_flops()}


def wall_clock(fn, *args, iters=20, warmup=3):
    """Median seconds per call of fn(*args): by CUDA events around each call
    when an argument is a CUDA tensor, else by the host clock."""
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    for _ in range(warmup):
        fn(*args)
    times = []
    if on_card:
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(*args)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) / 1e3 for s, e in pairs]
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def cli():
    """Profiler CLI, the profile.py / meta_profile.py entry point: the
    per-module params / generated-params / MACs table, the parameter count,
    and with --xla the counted FLOPs of one forward, or with --scopes the
    per-module FLOPs table.

        python -m hyperseg_torch.utils.profile -m "<arch>" [--scopes] [--device cpu]
    """
    import argparse
    from hyperseg_torch.core import registry

    p = argparse.ArgumentParser("hyperseg_torch profiler")
    p.add_argument("-m", "--model", required=True, help="model spec string")
    p.add_argument("-r", "--res", default=(512, 1024), type=int, nargs=2)
    p.add_argument("-b", "--batch", default=1, type=int)
    p.add_argument("--xla", action="store_true",
                   help="also count the FLOPs of one forward (FlopCounterMode)")
    p.add_argument("--scopes", action="store_true",
                   help="per-module FLOPs table (reference profile.py table format)")
    p.add_argument("--max_depth", type=int, default=2, help="module depth of --scopes")
    p.add_argument("--device", default="cuda",
                   help="where the forward runs; FLOPs are counted in full on the CPU only")
    a = p.parse_args()

    model = registry.build(a.model, device=a.device)
    x = torch.zeros(a.batch, 3, *a.res, device=a.device)
    if a.scopes:
        print_scope_table(flops_by_scope(model, x, max_depth=a.max_depth), model)
        return
    _, total = model_profile(model, tuple(a.res))
    tot, trn = count_params(model)
    print(f"parameters: {tot:,} total / {trn:,} trainable; "
          f"generated per patch: {total.hyper_params:,}")
    if a.xla:
        print(f"FLOPs (FlopCounterMode, ATen ops on {a.device}): "
              f"{xla_cost(model, x)['flops']:,}")


if __name__ == "__main__":
    cli()
