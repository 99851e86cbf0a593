"""Shape-bucketed predictor, and the CUDA-graph replay it and test_fps share.

Counterpart of hyperseg_tpu/core/predictor.py. Inputs are padded right and
bottom to the next shape bucket (a multiple of the model's stride-32 patch
grid, deeper where the weight mapper downsamples further), run once per
bucket through a cached executable, and the logits are cropped back to the
input's size. Where the JAX package keeps one `jax.jit` per bucket, this
package keeps one captured CUDA graph per bucket (`graphed`): the forward's
several hundred launches are recorded once and replayed by one call, on
static input and output buffers. On the CPU, which the caller asks for by
building the model there, the predictor runs the forward eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from hyperseg_torch.nn import functional as F
from hyperseg_torch.nn.modules import cast_weights
from hyperseg_torch.utils import trace

GRAPH_WARMUP = 3   # eager runs on a side stream before the capture


def graphed(fn: Callable, *example_inputs: torch.Tensor):
    """Capture fn(*inputs) as a CUDA graph; returns replay(*inputs), which
    copies the inputs into static buffers of the example inputs' shapes and
    dtypes, replays the graph, and returns fn's static outputs (overwritten
    by the next replay).

    GRAPH_WARMUP eager runs on a side stream first build everything fn
    caches on the host side (kernel plans, coordinate grids, cuBLAS
    handles), so the capture records device work only. The capture runs on
    that same stream: cuBLAS keeps a workspace per stream, so the capture
    uses the one the warm-up allocated, outside any graph's memory pool, and
    the kernels cuBLAS picked with it. (On torch's shared capture stream a
    float32 capture after earlier bfloat16 captures failed on an H100 with
    CUBLAS_STATUS_EXECUTION_FAILED, though it passed alone.) The capture
    forbids unsafe CUDA calls in this thread alone ("thread_local"): other
    threads run on beside it and touch no captured stream - the loader's
    pin-memory thread, which may allocate pinned memory for the next batch
    (under "global" that invalidated a capture of cli/test.py's step on an
    H100), and a process group's watchdog, which polls its collectives'
    events (the captured step holds no collective). A capture that fails
    raises; there is no eager fallback. Under spatial sharding it raises
    ValueError: such a forward runs eager.

    The warm-ups and the capture are the recorder's span "graph.capture"
    (utils/trace.py), a replay's input copies and its launch the spans
    "replay.copy_in" and "replay.launch"."""
    if F.spatial_group() is not None:
        raise ValueError("graphed: a spatially sharded forward runs eager (its gloo halo "
                         "exchanges cannot be captured); ROADMAP Queue 2 H3")
    static = [x.clone() for x in example_inputs]
    if any(x.device.type != "cuda" for x in static):
        raise ValueError("graphed: the inputs must be CUDA tensors")
    with trace.span("graph.capture"):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                fn(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            out = fn(*static)

    def replay(*inputs):
        for buf, x in zip(static, inputs, strict=True):
            if x.shape != buf.shape or x.dtype != buf.dtype:
                raise ValueError(f"graphed: input {tuple(x.shape)} {x.dtype}, captured "
                                 f"for {tuple(buf.shape)} {buf.dtype}")
        with trace.span("replay.copy_in"):
            for buf, x in zip(static, inputs):
                buf.copy_(x)
        with trace.span("replay.launch"):
            graph.replay()
        return out

    replay.graph, replay.static_inputs = graph, static
    return replay


def pad_to_multiple(x: np.ndarray, multiple: int = 32, mode: str = "reflect"):
    """Pad (B, H, W, C) right/bottom to the next multiple. Returns
    (padded, (H, W)). (A copy of the JAX package's.)"""
    b, h, w, c = x.shape
    hp = -(-h // multiple) * multiple
    wp = -(-w // multiple) * multiple
    if (hp, wp) == (h, w):
        return x, (h, w)
    if mode == "reflect" and (hp - h >= h or wp - w >= w):
        # np.pad reflect requires pad < dim; tiny inputs fall back to edge
        mode = "edge"
    return np.pad(x, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)), mode=mode), (h, w)


class Predictor:
    """Segmentation predictor over shape buckets, one CUDA graph each.

    >>> pred = Predictor(model)       # an eval model, on the card or the CPU
    >>> logits = pred(image_bhwc)     # any H, W; logits at (H, W)

    The model's conv weights are cast to `dtype` in place (BN statistics
    and 1-D parameters stay float32, as the JAX predictor's params).
    `max_cache` buckets are kept; the oldest is evicted with its graph and
    buffers."""

    def __init__(self, model, *, dtype=torch.bfloat16, multiple: int = 32,
                 max_cache: int = 16):
        self.model = cast_weights(model, dtype)
        self.dtype = dtype
        self.device = next(model.parameters()).device
        # the weight mapper downsamples its stride-32 input levels-1 more
        # times; pad far enough that every pyramid level stays >= 1 px
        wm_levels = getattr(getattr(model, "weight_mapper", None), "levels", 1)
        self.multiple = max(multiple, 32 * 2 ** max(wm_levels - 1, 0))
        self.max_cache = max_cache
        self._cache: Dict[Tuple[int, ...], Callable] = {}

    @torch.no_grad()
    def _forward(self, x):
        return self.model(x)

    def _fn_for(self, x):
        key = tuple(x.shape)
        if key not in self._cache:
            if len(self._cache) >= self.max_cache:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = (graphed(self._forward, x) if self.device.type == "cuda"
                                else self._forward)
        return self._cache[key]

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """image: (H, W, C) or (B, H, W, C) float array -> float32 numpy
        logits (..., H, W, num_classes) at the input's resolution."""
        squeeze = image.ndim == 3
        if squeeze:
            image = image[None]
        padded, (h, w) = pad_to_multiple(np.asarray(image, np.float32), self.multiple)
        x = torch.from_numpy(np.ascontiguousarray(padded.transpose(0, 3, 1, 2)))
        x = x.to(self.device, self.dtype)
        out = self._fn_for(x)(x)
        logits = out[:, :, :h, :w].float().permute(0, 2, 3, 1).cpu().numpy()
        return logits[0] if squeeze else logits

    def predict_classes(self, image: np.ndarray) -> np.ndarray:
        return np.argmax(self(image), axis=-1)
