"""Device ms per forward of the port's kernels (`f8::` in the name:
ops/*.py over csrc/*.cu), from the profiled stretch."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "images_per_s"
PATHS = ('offline',)


def read(r):
    s = r.get("stretch")
    if s is None or not s.device_ops:
        return None
    return s.device_s(port=True) / s.units * 1e3
