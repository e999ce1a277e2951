"""The whole forward's share of the H100's int8 dense peak: 2 MACs per image
(harness/counts.py) times the unprofiled window's images/s over
1979e12 operations/s.  Bounds every kernel's gain: a kernel taken off the
path leaves its own reading silent, this one not."""

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "model step"
MOVES = "images_per_s"
PATHS = ('offline',)


PEAK_INT8 = 1979e12


def read(r):
    if not r.get("on_card"):
        return None
    return 100.0 * 2.0 * r["macs_per_image"] * r["images_per_s"] / PEAK_INT8
