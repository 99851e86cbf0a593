"""Segmentation metrics (hyperseg_tpu/train/metrics.py).

The confusion matrix is accumulated on the tensors' device, one scatter-add
per batch into a buffer of fixed size (no host read: the eval step replays
from a CUDA graph); the scores are derived on the host from the accumulated
matrix. The eval CLI ranks its images by per_image_jaccard, made on the
host from each image's matrix (per_image_confmat, jaccard_from_confmat),
so it copies (B, C, C) counts off the card, not the predictions.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(labels, preds, num_classes: int, ignore_index=255):
    """(num_classes, num_classes) int64 matrix, rows the ground truth,
    columns the prediction. labels/preds: integer tensors of one shape;
    labels outside [0, num_classes) or equal to ignore_index are skipped:
    they count into a last, trash bin that is dropped. The counts are added
    into a preallocated num_classes**2 + 1 buffer (`index_add_`), where
    `torch.bincount` would read the largest index back to the host to size
    its output, which a CUDA graph cannot do."""
    labels, preds = labels.reshape(-1).long(), preds.reshape(-1).long()
    valid = (labels >= 0) & (labels < num_classes)
    if ignore_index is not None:
        valid &= labels != ignore_index
    idx = torch.where(valid, labels * num_classes + preds,
                      torch.full_like(labels, num_classes * num_classes))
    hist = torch.zeros(num_classes * num_classes + 1, dtype=torch.int64, device=idx.device)
    hist.index_add_(0, idx, torch.ones_like(idx))
    return hist[:-1].reshape(num_classes, num_classes)


def per_image_confmat(labels, preds, num_classes: int, ignore_index=255):
    """(B, num_classes, num_classes) int64 confusion matrix of each image,
    labels/preds (B, ...) integer tensors; the same counts as
    confusion_matrix's, image by image, into one preallocated
    B * num_classes**2 + 1 buffer (the trash bin last), so it too runs
    inside a CUDA graph. Its sum over the batch is the batch's
    confusion_matrix."""
    b = labels.shape[0]
    labels, preds = labels.reshape(b, -1).long(), preds.reshape(b, -1).long()
    valid = (labels >= 0) & (labels < num_classes)
    if ignore_index is not None:
        valid &= labels != ignore_index
    cells = num_classes * num_classes
    image = torch.arange(b, device=labels.device).view(b, 1) * cells
    idx = torch.where(valid, image + labels * num_classes + preds,
                      torch.full_like(labels, b * cells)).reshape(-1)
    hist = torch.zeros(b * cells + 1, dtype=torch.int64, device=idx.device)
    hist.index_add_(0, idx, torch.ones_like(idx))
    return hist[:-1].reshape(b, num_classes, num_classes)


def jaccard_from_confmat(confmat, ignore_index=0, eps=1e-6):
    """per_image_jaccard of one image from its (C, C) confusion matrix (one
    slice of per_image_confmat): the pixels labelled ignore_index leave the
    matrix (its row is zeroed) when it names a class, and the score follows
    per_image_jaccard's arithmetic, so the two agree exactly."""
    confmat = np.array(confmat, dtype=np.int64)
    num_classes = confmat.shape[0]
    ignored = ignore_index is not None and 0 <= ignore_index < num_classes
    if ignored:
        confmat[ignore_index] = 0
    inter = np.diag(confmat)
    union = confmat.sum(1) + confmat.sum(0) - inter
    if ignored:
        union[ignore_index] = 0
    sel = (inter / (union + eps))[union > 0]
    return float(sel.mean()) if sel.size else 0.0


def scores_from_confmat(hist):
    """The reference runningScore quantities (train.py:311-334) from an
    accumulated matrix: overall acc, mean class acc, frequency-weighted acc,
    mean IoU, per-class IoU."""
    hist = np.asarray(hist, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.diag(hist) / hist.sum(axis=1)
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
        freq = hist.sum(axis=1) / hist.sum()
    return {
        "overall_acc": float(acc),
        "mean_acc": float(np.nanmean(acc_cls)),
        "fwavacc": float((freq[freq > 0] * iu[freq > 0]).sum()),
        "mean_iou": float(np.nanmean(iu)),
        "class_iou": iu,
    }


def eval_scores_from_confmat(hist, eps=1e-6):
    """test.py-style (global acc, per-class acc, per-class IoU) with epsilon
    guards (seg_utils.py:22-36)."""
    hist = np.asarray(hist, dtype=np.float64)
    diag = np.diag(hist)
    global_acc = diag.sum() / (hist.sum() + eps)
    class_acc = diag / (hist.sum(axis=1) + eps)
    class_iou = diag / (hist.sum(axis=1) + hist.sum(axis=0) - diag + eps)
    return global_acc, class_acc, class_iou


def per_image_jaccard(labels, preds, num_classes: int, ignore_index=0, eps=1e-6):
    """Mean IoU of one image as the reference ranks eval images (test.py:
    210-227, quirk #8): only pixels whose label is a valid class (and not
    ignore_index) count, so predictions at void pixels enter no union; the
    ignore_index class's union is zeroed; classes with an empty union drop
    out of the mean, and an image with none scores 0.0."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    mask = (labels >= 0) & (labels < num_classes)
    ignored = ignore_index is not None and 0 <= ignore_index < num_classes
    if ignored:
        mask &= labels != ignore_index
    inds = num_classes * labels[mask].astype(np.int64) + preds[mask]
    confmat = np.bincount(inds, minlength=num_classes ** 2).reshape(num_classes, num_classes)
    inter = np.diag(confmat)
    union = confmat.sum(1) + confmat.sum(0) - inter
    if ignored:
        union[ignore_index] = 0
    sel = (inter / (union + eps))[union > 0]
    return float(sel.mean()) if sel.size else 0.0
