"""Tracing a window with torch.profiler and reading the trace (its
Chrome-trace JSON, written under TMPDIR and deleted once read). `Stretch`
profiles a steady part of a window.

Device activity is every kernel, copy and memset. Busy time is the union of
their intervals inside a stretch; a host range (a `record_function` of the
benchmark's own) owns the device time of the kernels whose launch it
encloses, matched by the launch's correlation id.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
@contextlib.contextmanager
def profiled(host=True):
    """Profile the block on the device, and with `host` on the host too;
    yields a dict that holds the parsed trace ('events') once the block has
    ended."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield out
    finally:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    out["events"] = parse(prof)


def parse(prof):
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f).get("traceEvents", [])
                    if e.get("ph") == "X" and "dur" in e]
    finally:
        os.remove(path)


def device_events(events):
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def span(events, name):
    """(start, end) in microseconds of the host range `name` (the first)."""
    for e in events:
        if e.get("name") == name and e.get("cat") == "user_annotation":
            return e["ts"], e["ts"] + e["dur"]
    return None


def union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_us(events, lo, hi):
    """Microseconds in [lo, hi] in which the device ran something."""
    iv = union(clip([(e["ts"], e["ts"] + e["dur"]) for e in device_events(events)], lo, hi))
    return sum(e - s for s, e in iv), iv


def top_ops(events, lo, hi, n=10):
    """The n device operations that took most time in [lo, hi]: [[name, s]]."""
    tot = defaultdict(float)
    for e in device_events(events):
        if lo <= e["ts"] < hi:
            tot[e["name"]] += e["dur"]
    return [[k, v * 1e-6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, iv, lo, hi, n=10):
    """The n longest stretches of [lo, hi] with nothing on the device, each
    named by the innermost host event under its middle: [[name, s]]."""
    gaps, t = [], lo
    for s, e in iv:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    host = [e for e in events if e.get("cat") in HOST_CATS]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = (s + e) / 2
        under = [h for h in host if h["ts"] <= mid < h["ts"] + h["dur"]]
        name = min(under, key=lambda h: h["dur"])["name"] if under else "host: outside any op"
        out.append([name, (e - s) * 1e-6])
    return out


def device_us_by_range(events, names):
    """{range name: device microseconds of the kernels launched inside it}."""
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid")) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in names]
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["ts"], e.get("tid"))
    out = defaultdict(float)
    for e in device_events(events):
        corr = e.get("args", {}).get("correlation")
        if corr not in launch:
            continue
        ts, tid = launch[corr]
        for s, t, name, rtid in ranges:
            if s <= ts <= t and rtid == tid:
                out[name] += e["dur"]
                break
    return dict(out)


class Stretch:
    """The traced part of a window: from 40% of the window on, two stretches
    one after the other, each min(1 s, a quarter of the window) long, or
    with `sync` a quarter of it, or until the window ends.

    1. The device's: a profiler of the device alone, started and stopped
       with the device drained (the eval loop drains it at every request;
       with `sync` the stretch synchronises at both ends), so that every
       device operation in its trace belongs to the stretch's requests or
       steps. Its length by the host's clock, from the first request or
       step to the end of the last, its busy time, its images, and the
       operations that took most time come from it. Tracing the device slows the host: CUPTI's
       record of each kernel of a graph replay cost about 5 us on an H100
       host (300 kernels: 0.72 ms a replay plain, 2.2-2.4 traced), so the
       stretch runs fewer images a second than the window around it.
    2. The host's: a profiler of host and device over a range
       `bench:stretch`, whose longest idle gaps are named by the host event
       under them (their lengths include the profiler's cost).

    The part of the window before the first, traced by nothing, is kept as
    its seconds and images: its seconds per image are the pace of the
    untraced program, against which the readers set the device's busy time
    per image."""

    def __init__(self, ctx, sync=False):
        self.on = ctx.trace and ctx.device.type == "cuda"
        self.length = ctx.seconds / 4 if sync else min(1.0, ctx.seconds / 4)
        self.start_at = 0.4 * ctx.seconds
        self.sync = sync
        self.phase = 0
        self.out = {}
        self.prof = self.rng = None
        if self.on:
            # the profiler's first start in a process initialises CUPTI, which
            # took seconds on an H100 host: do it, in both modes, in set-up
            for host in (False, True):
                with profiled(host):
                    torch.ones(1, device=ctx.device).add_(1)

    def tick(self, elapsed, done):
        """Before each request or step: `elapsed` seconds of the window and
        `done` images sent so far (all of them finished, where the loop
        drains the device or the stretch synchronises)."""
        if not self.on or self.phase == 3:
            return
        from torch.profiler import ProfilerActivity, profile
        now = time.perf_counter()
        if self.phase == 0 and elapsed >= self.start_at:
            if self.sync:
                torch.cuda.synchronize()
            self.out.update(untraced_s=elapsed + time.perf_counter() - now,
                            untraced_images=done)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t, self.done0, self.phase = time.perf_counter(), done, 1
        elif self.phase == 1 and now - self.t >= self.length:
            self._end_device(done)
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.rng = torch.profiler.record_function("bench:stretch")
            self.rng.__enter__()
            self.t, self.phase = time.perf_counter(), 2
        elif self.phase == 2 and now - self.t >= self.length:
            self._end_host()

    def _end_device(self, done):
        # each trace is read as soon as its profiler stops: the next start
        # clears the profiler's events
        torch.cuda.synchronize()
        self.out["window_s"] = time.perf_counter() - self.t
        self.prof.__exit__(None, None, None)
        self.out.update(images=done - self.done0, device_events=parse(self.prof))

    def _end_host(self):
        self.rng.__exit__(None, None, None)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.out["host_events"] = parse(self.prof)
        self.phase = 3

    def close(self, done):
        """At the window's end: close what is open; returns the traces."""
        if self.phase == 1:
            self._end_device(done)
        elif self.phase == 2:
            self._end_host()
        self.phase = 3
        return self.out


def stretch_readings(ctx, traced, flops_per_image):
    """The device stretch's length, busy time, images and top operations,
    the host stretch's idle gaps, and the untraced part's seconds per image."""
    ev = device_events(traced.get("device_events", []))
    if not ev or not traced.get("images"):
        return {}
    lo, hi = min(e["ts"] for e in ev), max(e["ts"] + e["dur"] for e in ev)
    busy, _ = busy_us(ev, lo, hi)
    r = {"kind": ctx.traffic["kind"], "window_s": traced["window_s"], "busy_s": busy * 1e-6,
         "images": traced["images"], "flops_per_image": flops_per_image,
         "breakdown": {"device_ops": top_ops(ev, lo, hi)}}
    if traced.get("untraced_images"):
        r["untraced_s_per_image"] = traced["untraced_s"] / traced["untraced_images"]
    hev = traced.get("host_events", [])
    if span(hev, "bench:stretch") is not None:
        hlo, hhi = span(hev, "bench:stretch")
        _, iv = busy_us(hev, hlo, hhi)
        r["breakdown"]["idle_gaps"] = idle_gaps(hev, iv, hlo, hhi)
    return r
