"""The context head's and decoder's share of their roofline: the least time
of their units (the context head, each decoder level, each resize;
lib/counts.py) over the device time of the kernels launched inside
`model.weight_mapper` and `model.decoder` in eager forwards."""


def read(r):
    if not r.get("decoder_device_s"):
        return None
    return 100.0 * r["decoder_least_s"] / r["decoder_device_s"]
