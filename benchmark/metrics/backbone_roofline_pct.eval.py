"""The backbone's share of its roofline: the least time of its units (the
stem, each MBConv block, the feature compressors, the head; lib/counts.py)
over the device time of the kernels launched inside `model.backbone` in
eager forwards of the cell's batch."""


def read(r):
    if not r.get("backbone_device_s"):
        return None
    return 100.0 * r["backbone_least_s"] / r["backbone_device_s"]
