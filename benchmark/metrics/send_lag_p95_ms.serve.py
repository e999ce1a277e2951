"""95th percentile of how late the load generator sent each request of the
window (send time minus due time): above a few ms the generator, not the
server, sets the tail."""

import math

import numpy as np

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "load generator"
MOVES = "latency_p95_ms"
PATHS = ('serve',)


def read(r):
    v = np.sort(np.asarray(r["send_lag_ms"], dtype=np.float64))
    if not len(v) or np.isnan(v).any():
        return None
    return float(v[max(math.ceil(0.95 * len(v)) - 1, 0)])
