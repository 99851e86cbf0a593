"""K7's share of its roofline: the least time of the v0_1 decoder's
inverted-residual levels, which K7 computes whole (their bytes and
operations at the run's dtype, reference/hyperseg_v0_1.py `units`), over
the device time of the kernels launched inside the port's
`kernel.patch_invres_v01` spans in eager forwards (lib/serve_kernels.py)."""


def read(r):
    if not r.get("patch_invres_v01_device_s"):
        return None
    return 100.0 * r["patch_invres_v01_least_s"] / r["patch_invres_v01_device_s"]
