"""Images per device batch in the window: ServingEngine's counters,
stats["images"] / stats["batches"]."""

UNIT = "images"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "serving"
MOVES = "latency_p95_ms"
PATHS = ('serve',)


def read(r):
    s = r["stats"]
    return s["images"] / s["batches"] if s["batches"] else None
