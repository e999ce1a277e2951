"""Host ms from a call of `IntEngine.__call__` to its return, the card idle
before each call (paths/offline.py `enqueue_ms`): what the host pays to
launch one forward."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "entry"
MOVES = "images_per_s"
PATHS = ('offline',)


def read(r):
    return r.get("enqueue_ms")
