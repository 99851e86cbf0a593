"""The host's part of a frame: the median over the window's frames of the
frame's latency less the device time of its graph replay (CUDA events):
the gather into the static input, the launch, the class map's copy out and
the synchronise."""


def read(r):
    return r.get("replay_host_ms")
