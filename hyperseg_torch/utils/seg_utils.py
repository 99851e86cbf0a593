"""Segmentation metric accumulators (class API) on torch tensors.

Counterpart of hyperseg_tpu/utils/seg_utils.py (reference
hyperseg/utils/seg_utils.py): ConfusionMatrix with eps-guarded acc/IoU
(:5-56) and the IOUBenchmark wrapper (:59-79). The matrix accumulates on
the device of the tensors it is given (train/metrics.py confusion_matrix),
moving there at the first update;
the scores are derived on the host. `reduce_across_devices` sums a matrix
over the ranks of a data-parallel group, the working form of the
reference's dormant torch.distributed all_reduce (:38-44). Visualization
helpers live in
hyperseg_torch.utils.img_utils (blend_seg).
"""

from __future__ import annotations

import numpy as np
import torch

from hyperseg_torch.train import metrics as M


class ConfusionMatrix:
    def __init__(self, num_classes: int, ignore_index=None):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.mat = torch.zeros(num_classes, num_classes, dtype=torch.int64)

    def update(self, target, pred):
        target, pred = torch.as_tensor(target), torch.as_tensor(pred)
        if self.mat.device != target.device:
            self.mat = self.mat.to(target.device)
        self.mat += M.confusion_matrix(target, pred, self.num_classes,
                                       ignore_index=self.ignore_index)

    def reset(self):
        self.mat.zero_()

    def compute(self, eps=1e-6):
        """(global_acc, class_acc, class_iou) with epsilon guards
        (seg_utils.py:22-36)."""
        return M.eval_scores_from_confmat(self.mat.cpu().numpy(), eps=eps)

    @staticmethod
    def reduce_across_devices(mat, group=None):
        """`mat` summed in place over the ranks of `group` (the default group
        when one is initialized; the identity without one), as the JAX
        package's psum over the mesh's data axis (over a spatially sharded
        mesh the default group holds every band of every image, and the sum
        is the world's). Returns it."""
        import torch.distributed as dist
        if group is not None or dist.is_initialized():
            dist.all_reduce(mat, group=group)
        return mat


class IOUBenchmark:
    """mIoU-from-confusion-matrix benchmark object (seg_utils.py:59-79)."""

    def __init__(self, num_classes: int):
        self.confmat = ConfusionMatrix(num_classes)

    def __call__(self, pred, target):
        self.confmat.update(target, pred)
        _, _, class_iou = self.confmat.compute()
        return {"iou": float(np.mean(class_iou))}

    def reset(self):
        self.confmat.reset()
