"""The comparisons that decide `correct`.

Eval: for each checked frame, the reference's float32 logits; at every
pixel the gap by which the logit of the class the program served lies
below the reference's best, in units of the standard deviation of the
reference's logits over the checked frames. The number compared is the
widest gap (`gap_max`).

Training: each of the first three steps' loss, the first gradient as the
optimizer got it, the parameters' change after three steps, and the change
of every BN's running statistics over the three steps (`stats_gap`; the
program writes them in each training step, outside the gradient), against
the reference's. A norm is compared leaf by leaf: the gap between the
program's norm and the reference's over the larger of the reference's norm
of that leaf and of the median leaf; the number is the worst leaf. Leaves
whose reference gradient is below a thousandth of the median leaf's move
under Adam by round-off alone and are left out of the change. Beside these
the steadier median leaf's gradient gap (`grad_median_gap`): Adam's first
steps move every element by about the learning rate whatever its
gradient's size, so round-off in the smallest gradients moves the later
losses, and the worst leaves of sound runs swing from seed to seed, by as
much as TF32 does.
"""

from __future__ import annotations

import statistics

import torch


@torch.no_grad()
def eval_gaps(R, P, p, frames, served, block=2):
    """R the reference module, P its parameters, p its plan; frames
    (n, 3, H, W) as the program read them; served (n, H, W) class indices.
    Returns {'gap_max': widest gap / std of the reference logits}."""
    worst, sq, s, count = 0.0, 0.0, 0.0, 0
    for i in range(0, frames.shape[0], block):
        ref = R.forward(P, p, frames[i:i + block].float())
        top = ref.max(1).values
        got = ref.gather(1, served[i:i + block].to(ref.device).long()[:, None])[:, 0]
        worst = max(worst, (top - got).max().item())
        sq += ref.double().square().sum().item()
        s += ref.double().sum().item()
        count += ref.numel()
        del ref, top, got
    std = (sq / count - (s / count) ** 2) ** 0.5
    return {"gap_max": worst / std}


def leaf_gaps(prog, ref, keys):
    """Per leaf |‖prog‖ - ‖ref‖| / max(‖ref leaf‖, median ‖ref leaf‖)."""
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]


def kept_leaves(ref_grad_norms):
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= 1e-3 * med]


def train_numbers(prog, ref):
    """prog, ref: {'losses': [3], 'grad': {key: norm}, 'change': {key: norm},
    'stats': {key: norm of the running statistic's change}}."""
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    keys = list(ref["grad"])
    kept = kept_leaves(ref["grad"])
    grad = leaf_gaps(prog["grad"], ref["grad"], keys)
    return {"loss_gap": max(loss),
            "grad_gap": max(grad), "grad_median_gap": statistics.median(grad),
            "change_gap": max(leaf_gaps(prog["change"], ref["change"], kept)),
            "stats_gap": max(leaf_gaps(prog["stats"], ref["stats"], list(ref["stats"]))),
            "leaves_left_out": len(keys) - len(kept)}
