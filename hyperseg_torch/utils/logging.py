"""Training observability: averaged meters, TensorBoard logging, a progress meter.

Counterpart of hyperseg_tpu/utils/logging.py (reference
hyperseg/utils/tensorboard_logger.py): categorized scalar dict with
per-batch 'val' and running 'avg' scalars, image logging, and a progress-bar
string representation. Backed by tensorboardX when it is installed; a JSONL
file logger otherwise (still machine-readable). Images are CHW, as
tensorboard takes them."""

from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np


class AverageMeter:
    """Running average (tensorboard_logger.py:8-23)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class TensorBoardLogger:
    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self.meters: "OrderedDict[str, AverageMeter]" = OrderedDict()
        self.prefix = ""
        self.writer = None
        self._jsonl = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            else:
                self.writer = SummaryWriter(log_dir)

    def reset(self, prefix: str = ""):
        self.prefix = prefix
        self.meters.clear()

    def update(self, category: str, **kwargs):
        for k, v in kwargs.items():
            name = f"{category}/{k}"
            self.meters.setdefault(name, AverageMeter()).update(v)

    def log_scalars_val(self, main_tag: str, global_step: int, category=None):
        """Write current values under ``main_tag/<category>/<key>`` — the
        reference's add_scalars(main_tag + '/' + category, ...) semantics
        (tensorboard_logger.py:45-53). category=None writes all meters."""
        self._write({f"{main_tag}/{k}": m.val for k, m in self.meters.items()
                     if category is None or k.startswith(category + "/")},
                    global_step, suffix="val")

    def log_scalars_avg(self, main_tag: str, global_step: int, category=None):
        self._write({f"{main_tag}/{k}": m.avg for k, m in self.meters.items()
                     if category is None or k.startswith(category + "/")},
                    global_step, suffix="avg")

    def log_image(self, tag: str, img_chw, global_step: int):
        if self.writer is not None:
            self.writer.add_image(tag, np.asarray(img_chw), global_step)

    def log_heatmap(self, tag: str, matrix: np.ndarray, global_step: int,
                    labels=None):
        """Confusion-matrix heatmap (the reference's seaborn heatmaps,
        tensorboard_logger.py:70-86), rendered with matplotlib when present."""
        if self.writer is None:
            return
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        m = np.asarray(matrix, np.float64)
        norm = m / np.maximum(m.sum(axis=1, keepdims=True), 1)
        fig, ax = plt.subplots(figsize=(6, 5), dpi=100)
        im = ax.imshow(norm, cmap="viridis", vmin=0, vmax=1)
        fig.colorbar(im, ax=ax)
        if labels is not None:
            ax.set_xticks(range(len(labels)))
            ax.set_yticks(range(len(labels)))
            ax.set_xticklabels(labels, rotation=90, fontsize=6)
            ax.set_yticklabels(labels, fontsize=6)
        ax.set_xlabel("prediction")
        ax.set_ylabel("ground truth")
        fig.tight_layout()
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        plt.close(fig)
        self.writer.add_image(tag, buf.transpose(2, 0, 1), global_step)

    def _write(self, scalars: Dict[str, float], step: int, suffix: str):
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(f"{k}/{suffix}", v, step)
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"step": step, "suffix": suffix, "time": time.time(), **scalars}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()
        if self._jsonl is not None:
            self._jsonl.close()

    def __str__(self):
        """Reference progress-bar description format
        (tensorboard_logger.py:88-96): ``prefix losses: [total: v (avg); ]``,
        grouped by category."""
        desc = self.prefix or ""
        by_cat: "OrderedDict[str, list]" = OrderedDict()
        for k, m in self.meters.items():
            cat, _, key = k.partition("/")
            by_cat.setdefault(cat, []).append((key, m))
        for cat, items in by_cat.items():
            desc += f" {cat}: ["
            for key, m in items:
                desc += f"{key}: {m.val:.4f} ({m.avg:.4f}); "
            desc += "]"
        return desc


class ProgressMeter:
    """tqdm-style single-line progress meter (the reference wraps its loaders
    in tqdm and calls pbar.set_description(str(logger)), train.py:97,144).

    Dependency-free: rewrites the line in place on TTYs and falls back to
    plain prints on description changes otherwise (CI/pipe-friendly). The
    counter/rate update costs no device sync — callers refresh the
    description only at their existing metric sync points, preserving the
    asynchronous training loop (the reference syncs every batch; we
    deliberately don't)."""

    def __init__(self, total: int, unit: str = "batches", stream=None,
                 min_interval: float = 0.25):
        import sys
        self.total = max(int(total), 1)
        self.unit = unit
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval = min_interval
        self.desc = ""
        self.n = 0
        self._t0 = time.time()
        self._last_render = 0.0
        self._isatty = bool(getattr(self.stream, "isatty", lambda: False)())

    def set_description(self, desc: str):
        self.desc = desc
        if not self._isatty:
            el = time.time() - self._t0
            rate = self.n / el if el > 0 else 0.0
            print(f"{desc} | {self.n}/{self.total} "
                  f"[{rate:.1f} {self.unit}/s]", file=self.stream, flush=True)
        else:
            self._render(force=True)

    def update(self, n: int = 1):
        self.n += n
        if self._isatty:
            self._render()
        else:
            # tqdm still emits lines when piped; stay visible on long runs
            # even if the caller never refreshes the description, but at a
            # log-friendly cadence
            now = time.time()
            if now - self._last_render >= 30.0 or self.n >= self.total:
                self._last_render = now
                el = now - self._t0
                rate = self.n / el if el > 0 else 0.0
                print(f"{self.desc} | {self.n}/{self.total} "
                      f"[{rate:.1f} {self.unit}/s]".lstrip(" |"),
                      file=self.stream, flush=True)

    def _render(self, force: bool = False):
        now = time.time()
        if not force and now - self._last_render < self.min_interval:
            return
        self._last_render = now
        el = now - self._t0
        rate = self.n / el if el > 0 else 0.0
        rem = (self.total - self.n) / rate if rate > 0 else 0.0
        frac = min(self.n / self.total, 1.0)
        bar = ("#" * int(frac * 20)).ljust(20)
        mm = lambda s: f"{int(s) // 60:02d}:{int(s) % 60:02d}"
        line = (f"{self.desc} {100 * frac:3.0f}%|{bar}| "
                f"{self.n}/{self.total} [{mm(el)}<{mm(rem)}, "
                f"{rate:.2f}{self.unit}/s]")
        self.stream.write("\r" + line[:200].ljust(120))
        self.stream.flush()

    def close(self):
        if self._isatty:
            self._render(force=True)
            self.stream.write("\n")
            self.stream.flush()
