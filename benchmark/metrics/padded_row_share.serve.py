"""Share of device rows that were padding in the window: ServingEngine's
counters, stats["padded"] / (stats["images"] + stats["padded"])."""

UNIT = "%"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "serving"
MOVES = "latency_p95_ms"
PATHS = ('serve',)


def read(r):
    s = r["stats"]
    rows = s["images"] + s["padded"]
    return 100.0 * s["padded"] / rows if rows else None
