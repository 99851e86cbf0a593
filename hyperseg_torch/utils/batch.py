"""Batch runner: apply a function spec over globs or list files of inputs.

Counterpart of hyperseg_tpu/utils/batch.py (reference
hyperseg/utils/batch.py): expands each path argument (glob pattern,
directory, .txt list file, or plain path), crosses them positionally, and
calls the function, resolved through this package's registry, per item; a
failing item's traceback is printed and the sweep goes on (batch.py:82-85).

    python -m hyperseg_torch.utils.batch 'frames/*.png' -fo mymodule.process -o out/
"""

from __future__ import annotations

import glob
import os
import traceback
from itertools import zip_longest
from typing import List, Sequence

from hyperseg_torch.core import registry

DEFAULT_FUNC = "hyperseg_torch.utils.batch.echo"


def parse_paths(arg: str) -> List[str]:
    """Expand one input argument into a path list (batch.py:88-127)."""
    if os.path.isfile(arg) and arg.endswith(".txt"):
        with open(arg) as f:
            return [line.strip() for line in f if line.strip()]
    if os.path.isdir(arg):
        return sorted(os.path.join(arg, f) for f in os.listdir(arg)
                      if os.path.isfile(os.path.join(arg, f)))
    matches = sorted(glob.glob(arg))
    return matches if matches else [arg]


def echo(*args, **kwargs):
    print(args, kwargs)


def main(paths: Sequence[str], func=DEFAULT_FUNC, output=None, **func_kwargs):
    """Call `func` (a dotted path or a callable) once per crossed item, with
    `output` and `func_kwargs` as keywords; returns (succeeded, failed)."""
    fn = registry.resolve_target(func) if isinstance(func, str) else func
    expanded = [parse_paths(p) for p in paths]
    n_ok = n_fail = 0
    for items in zip_longest(*expanded):
        kwargs = dict(func_kwargs)
        if output is not None:
            kwargs["output"] = output
        try:
            fn(*[i for i in items if i is not None], **kwargs)
        except Exception:   # a sweep goes on past a failing item, and reports it
            traceback.print_exc()
            n_fail += 1
        else:
            n_ok += 1
    print(f"batch: {n_ok} succeeded, {n_fail} failed")
    return n_ok, n_fail


def cli():
    import argparse
    p = argparse.ArgumentParser("hyperseg_torch batch runner")
    p.add_argument("paths", nargs="+",
                   help="globs / dirs / .txt list files, crossed positionally")
    p.add_argument("-fo", "--func", default=DEFAULT_FUNC,
                   help="function spec to invoke per item")
    p.add_argument("-o", "--output", help="output path forwarded to func")
    a = p.parse_args()
    main(a.paths, func=a.func, output=a.output)


if __name__ == "__main__":
    cli()
