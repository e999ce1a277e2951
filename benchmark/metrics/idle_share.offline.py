"""Share of the profiled stretch's wall time in which no operation ran on
the device: 1 - (union of device-operation intervals) / wall."""

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "images_per_s"
PATHS = ('offline',)


def read(r):
    s = r.get("stretch")
    if s is None or not s.device_ops:
        return None
    return 100.0 * (1.0 - s.busy_s / s.wall_s)
