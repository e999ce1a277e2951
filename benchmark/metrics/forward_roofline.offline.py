"""The forward's share of its roofline: the least device time of the
configuration's convs and GEMMs (harness/counts.py `bound_s`: per layer
max(2 MACs / 1979 TOP/s, bytes / 3.35 TB/s), int8 input and weights read
once, int8 output written once) over the device-busy ms per forward of the
profiled stretch.  The same work whatever kernel, route or fusion computes
it, so folding glue into a kernel cannot raise it but by saving time."""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "images_per_s"
PATHS = ('offline',)


def read(r):
    s = r.get("stretch")
    if s is None or s.busy_s <= 0:
        return None
    return 100.0 * r["bound_s_per_forward"] / (s.busy_s / s.units)
