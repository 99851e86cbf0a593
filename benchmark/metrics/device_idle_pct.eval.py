"""Share of the untraced program's time in which nothing ran on the device:
100 x (1 - the device's busy seconds per image / the seconds per image of
the window's untraced part). The busy seconds are the union of every
kernel, copy and memset interval in the traced device stretch, over the
images it ran (lib/trace.py `Stretch`); they are set against the untraced
pace because tracing slows the host's launches, most of all a graph
replay's, which stretches the traced stretch's own idle time."""


def read(r):
    if not r.get("images") or not r.get("untraced_s_per_image") or "busy_s" not in r:
        return None
    idle = 100.0 * (1.0 - r["busy_s"] / r["images"] / r["untraced_s_per_image"])
    return idle if 0.0 <= idle <= 100.0 else None
