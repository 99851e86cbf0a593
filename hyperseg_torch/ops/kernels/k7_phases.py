"""Where K7's time goes: K7 (patch_invres_v01) cut short after each of its
phases, at HyperSeg-L VOC's four v0_1 calls, on one GPU.

    python -m hyperseg_torch.ops.kernels.k7_phases [--batch 1]

The script copies the package to hyperseg_torch/ops/kernels/_build/k7_phases/,
adds to the copy's v01_unit_kernel a return after each phase's closing
barrier, chosen by the environment variable K7_STOP that the copy's launcher
reads at each launch, builds the copy in a child process and times each cut
kernel as invres_sweep times K7 (the same inputs and plan). The times are
cumulative: the block's tables and owner mask (stop 1), the staging of the
window, weights and halo (2), the placement of w3, w2 and the foreign pixels
(3), the expand (4), the depthwise (5), the project (6), then the whole
kernel with its store. A cut kernel leaves its output unwritten: only the
times mean anything.
"""

import argparse
import os
import shutil
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(os.path.dirname(_DIR))   # the hyperseg_torch package
COPY = os.path.join(_DIR, "_build", "k7_phases")
STOPS = ["tables", "staging", "placement", "expand", "depthwise", "project", "whole"]


def patched_source(src):
    """patch_invres.cu with a K7_STOP return after each phase of K7."""
    a = src.index("v01_unit_kernel(const T* __restrict__ x")
    b = src.index("cudaError_t launch_v01(")
    k = src[a:b]
    cuts = [("int band, int vec, int wvec, V01Smem lay) {",
             "int band, int vec, int wvec, V01Smem lay, int stop) {"),
            ("  if (nslot > lay.slots) __trap();  // the plan's room is too small\n",
             "  if (nslot > lay.slots) __trap();  // the plan's room is too small\n"
             "  if (stop == 1) return;\n"),
            ("  cp_async_wait<0>();\n  __syncthreads();\n\n  // 2.",
             "  cp_async_wait<0>();\n  __syncthreads();\n  if (stop == 2) return;\n\n  // 2.")]
    cuts += [(f"  __syncthreads();\n\n  // {n}.",
              f"  __syncthreads();\n  if (stop == {n}) return;\n\n  // {n}.") for n in (3, 4, 5, 6)]
    for old, new in cuts:
        if k.count(old) != 1:
            raise SystemExit(f"k7_phases: the kernel has changed; cannot place {old!r}")
        k = k.replace(old, new)
    launch = "band, vec, wvec, lay);"
    if src[b:].count(launch) != 1:
        raise SystemExit("k7_phases: the launcher has changed")
    tail = src[b:].replace(launch, 'band, vec, wvec, lay,\n      getenv("K7_STOP") ? '
                                   'atoi(getenv("K7_STOP")) : 0);')
    head = src[:a].replace("#include <cstdint>", "#include <cstdint>\n#include <cstdlib>")
    return head + k + tail


def measure(batch):
    """In the child: time the cut kernels of the copy at V's four calls."""
    import torch

    from hyperseg_torch.ops.kernels import build, invres_sweep as S, patch_invres as PI
    from hyperseg_torch.train.harness import cuda_ms
    assert os.path.join("_build", "k7_phases") in PI.__file__, PI.__file__   # the copy
    build.kernels()
    gen = torch.Generator().manual_seed(0)
    for _, _, a, _ in S.decoder_calls("V"):
        x, w, kw = S.k7_inputs("V", a, batch, gen)
        _, cin, h, wd = x.shape
        fh, fw = a["w"][0][1:3]
        band, layout = PI.v01_plan(cin, kw["hidden"], kw["out_ch"], h // fh, wd // fw, fh, fw,
                                   batch)
        out = torch.empty(batch, kw["out_ch"], h, wd, device="cuda", dtype=torch.bfloat16)
        row = PI.map_row_stride(w)
        cum = []
        for stop in (1, 2, 3, 4, 5, 6, 0):
            os.environ["K7_STOP"] = str(stop)
            cum.append(cuda_ms(lambda: build.kernels().patch_invres_v01(
                x, w, row, kw["hidden"], S.bns(kw), 1e-5, band, layout, out)))
        steps = [cum[0]] + [b - a for a, b in zip(cum, cum[1:])]
        print(f"k7_phases batch {batch} level {S.level('V', a)} x {tuple(x.shape)} band {band}: "
              "cumulative ms " + " ".join(f"{n} {c:.4f}" for n, c in zip(STOPS, cum))
              + " | per phase " + " ".join(f"{n} {s:.4f}" for n, s in zip(STOPS, steps)),
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        return measure(args.batch)
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(_PKG, os.path.join(COPY, "hyperseg_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = os.path.join(COPY, "hyperseg_torch", "ops", "kernels", "patch_invres.cu")
    with open(cu) as f:
        src = patched_source(f.read())
    with open(cu, "w") as f:
        f.write(src)
    env = dict(os.environ, PYTHONPATH=COPY)
    sys.exit(subprocess.run([sys.executable, "-m", "hyperseg_torch.ops.kernels.k7_phases",
                             "--measure", "--batch", str(args.batch)], cwd=COPY,
                            env=env).returncode)


if __name__ == "__main__":
    main()
