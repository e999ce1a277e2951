"""Device ms per forward of every device operation whose name lacks `f8::`
(the glue of engine/int_engine.py: packs, widening, residual adds, ReLU,
the average pool), from the profiled stretch."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "glue"
MOVES = "images_per_s"
PATHS = ('offline',)


def read(r):
    s = r.get("stretch")
    if s is None or not s.device_ops:
        return None
    return s.device_s(port=False) / s.units * 1e3
