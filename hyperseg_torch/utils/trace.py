"""The port's span recorder: named intervals at its layer boundaries.

The program opens a span wherever a layer's work happens (the names below);
the recorder is off unless `enable()` is called, and then keeps each span in
memory until `spans()` is asked for. It writes no file and reads no
environment variable.

    from hyperseg_torch.utils import trace
    trace.enable()
    with trace.request(7):
        logits = model(x)          # model.*, kernel.* spans, request 7
    records = trace.spans()
    trace.disable(); trace.reset()

Off, `span(name, **attrs)` returns one shared no-op context, whose `with`
target is None: it reads no clock, opens no `record_function` and records
nothing (the only allocation is the keyword dict Python makes for `**attrs`).
On, a span records its name, its start and end, the index of the span that
encloses it on the same thread (-1 for none), the request id of the
enclosing `request(i)` (None outside one) and its attributes; its `with`
target is its attribute dict, which the code inside may extend (a kernel
span's arguments are added there, and only when on).

Clock: start and end are `time.time_ns()`, the clock of torch.profiler's
Chrome trace, whose event at `ts` microseconds lies at
`baseTimeNanoseconds + 1000 * ts` nanoseconds. So a span maps onto any
profiler trace, one of the device alone included, without an anchor. While
a torch profiler is running, each span also opens a `record_function` of its
own name inside its interval, so the program's spans appear in the trace
(under a profiler of the device alone the range records nothing).

Spans the program opens:
  model.build                    every HyperGen factory (models/hyperseg_v1_0.py
                                 `make_model`), weights drawn included
  kernels.load                   the kernels' build or load (ops/kernels/build.py),
                                 attribute `built`: whether the compiler ran
  graph.capture                  a CUDA graph's warm-ups and capture
                                 (core/predictor.py `graphed`)
  replay.copy_in, replay.launch  a graph replay's input copies and its launch
  model.backbone, model.context_head, model.decoder
                                 the layers of HyperGen.forward
  train_step.forward, .backward, .optimizer, .metrics
                                 the phases of train/step.py's step
  kernel.<name>                  each kernel wrapper's launch (or its twin on the
                                 CPU), named as its ops/kernels LAUNCHES key,
                                 attributes its arguments' shapes and dtypes
                                 (ops/kernels `describe`)
"""

from __future__ import annotations

import threading
import time

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_on = False
_records: list = []       # [name, start, end, parent, request, attrs]
_lock = threading.Lock()
_local = threading.local()  # .stack: indices of the spans open on this thread
_request = None


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("rec", "index", "range")

    def __init__(self, name, attrs):
        self.rec = [name, 0, 0, -1, _request, attrs]
        self.range = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.rec
        rec[3] = stack[-1] if stack else -1
        with _lock:
            self.index = len(_records)
            _records.append(rec)
        stack.append(self.index)
        rec[1] = time.time_ns()
        if _profiler._is_profiler_enabled:
            self.range = record_function(rec[0])
            self.range.__enter__()
        return rec[5]

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec[2] = time.time_ns()
        stack = _local.stack
        if stack and stack[-1] == self.index:
            stack.pop()
        return False


class _Request:
    __slots__ = ("id", "prev")

    def __init__(self, i):
        self.id = i

    def __enter__(self):
        global _request
        self.prev, _request = _request, self.id

    def __exit__(self, *exc):
        global _request
        _request = self.prev
        return False


def span(name, **attrs):
    """A context recording one span named `name` with `attrs` (see the
    module's docstring); the shared no-op while the recorder is off."""
    if not _on:
        return NOOP
    return _Span(name, attrs)


def request(i):
    """A context that stamps request id `i` on every span opened inside it;
    the shared no-op while the recorder is off."""
    if not _on:
        return NOOP
    return _Request(i)


def enable():
    global _on
    _on = True


def disable():
    """Stop recording; spans already open still record their end."""
    global _on
    _on = False


def reset():
    """Forget every span recorded (call it with no span open)."""
    with _lock:
        _records.clear()
    _local.stack = []


def spans():
    """The spans recorded since the last reset, in the order they opened:
    [{'name', 'start', 'end' (time.time_ns() nanoseconds; end 0 while
    open), 'parent' (index in this list, or -1), 'request', 'attrs'}]."""
    with _lock:
        recs = list(_records)
    return [{"name": n, "start": s, "end": e, "parent": p, "request": r, "attrs": dict(a)}
            for n, s, e, p, r, a in recs]
