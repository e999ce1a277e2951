"""Share of the profiled stretch of served traffic in which no operation ran
on the device: 1 - (union of device-operation intervals) / wall, the wall
running from the stretch's first due request to its last answer."""

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "latency_p95_ms"
PATHS = ('serve',)


def read(r):
    s = r.get("stretch")
    if s is None or not s.device_ops:
        return None
    return 100.0 * (1.0 - s.busy_s / s.wall_s)
