"""Inference-time BN folding of a state dict.

Counterpart of hyperseg_tpu/core/folding.py. `fold_bn` finds the same
conv -> BN pairs by the same naming rules (EfficientNet stem, expand,
depthwise, project, feature compressors and head; the weight mapper's and
the decoder's '<prefix>.0' conv + '<prefix>.1' BN sequentials) and moves
each BN's scale into its conv's OIHW weight along dim 0, and its shift into
the BN's bias. The patch-space BNs of the inverted residuals are not
conv-adjacent in the state dict and stay as they are. The model code does
not change.

One difference from the JAX function: the folded BN keeps running_var =
1 - eps, where JAX's keeps 1. Eval BN divides by sqrt(running_var + eps),
so JAX's folded BN still scales by rsqrt(1 + eps), 0.9995 at the backbone's
eps of 1e-3, and its folded model's logits drift from the unfolded ones;
here the folded BN scales by exactly 1 (up to float32 rounding), and every
other folded tensor equals JAX's.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from hyperseg_torch.nn import functional as F


def _fold_pair(sd, conv_key, bn_prefix, eps):
    w = sd.get(conv_key)
    if w is None or f"{bn_prefix}.running_mean" not in sd:
        return
    mult, shift = F.fold_bn(*(sd[f"{bn_prefix}.{k}"] for k in
                              ("weight", "bias", "running_mean", "running_var")), eps)
    sd[conv_key] = (w.float() * mult.view(-1, 1, 1, 1)).to(w.dtype)
    sd[f"{bn_prefix}.weight"] = torch.ones_like(mult)
    sd[f"{bn_prefix}.bias"] = shift
    sd[f"{bn_prefix}.running_mean"] = torch.zeros_like(mult)
    sd[f"{bn_prefix}.running_var"] = torch.full_like(mult, 1.0 - eps)


def fold_bn(state_dict: Mapping[str, torch.Tensor], *, backbone_eps=1e-3,
            eps=1e-5) -> Dict[str, torch.Tensor]:
    """A new state dict with the conv-adjacent BNs folded (eval only)."""
    sd = dict(state_dict)
    pairs = []
    for k, v in sd.items():
        if not k.endswith(".weight") or v.dim() != 4:
            continue
        name = k[:-len(".weight")]
        # EfficientNet pairs
        for conv, bn in (("_conv_stem", "_bn0"), ("_conv_head", "_bn1"),
                         ("_expand_conv", "_bn0"), ("_depthwise_conv", "_bn1"),
                         ("_project_conv", "_bn2")):
            if name.endswith(conv):
                pairs.append((k, name[:-len(conv)] + bn, backbone_eps))
        if "_feat_fc_" in name and name.endswith(".0"):
            pairs.append((k, name[:-2] + ".1", backbone_eps))
        # weight mapper / k=1 decoder blocks: '<prefix>.0.weight' + '<prefix>.1.*'
        if name.endswith(".0") and any(s in name for s in ("weight_mapper", "level_",
                                                             "flat_", "down_")):
            pairs.append((k, name[:-2] + ".1", eps))
    for conv_key, bn_prefix, e in pairs:
        _fold_pair(sd, conv_key, bn_prefix, e)
    return sd
