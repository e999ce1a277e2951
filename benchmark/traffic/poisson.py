"""Open-loop serving traffic of independent clients: requests of
`images_min`..`images_max` images at `rate_rps` requests per second, with
exponential gaps between arrivals.

Every seed offers the same work: a window of T seconds holds
N = round(rate x T) requests, whose gaps are the N quantiles
-ln(1 - (k + 1/2) / N) / rate of the exponential law scaled to sum to T,
and whose sizes cycle through images_min..images_max; the seed shuffles
both, and picks each request's images as a run of consecutive images of a
pool of `pool_images` distinct uint8 images made on the device from the
seed.  So two seeds differ in order, not in load."""

from __future__ import annotations

import numpy as np
import torch

from ..harness.weights import generator, sub_seed
from . import Schedule


def pool(mix: dict, image_size: int, seed: int, device) -> torch.Tensor:
    g = generator(seed, "images", device)
    return torch.randint(0, 256, (int(mix["pool_images"]), image_size, image_size, 3),
                         generator=g, device=device, dtype=torch.uint8)


def schedule(mix: dict, seed: int, seconds: float, what: str = "window") -> Schedule:
    rate = float(mix["rate_rps"])
    n = max(int(round(rate * seconds)), 1)
    rng = np.random.default_rng(sub_seed(seed, f"arrivals:{what}"))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = rng.permutation(gaps * (seconds / gaps.sum()))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    lo, hi = int(mix["images_min"]), int(mix["images_max"])
    size = rng.permutation(np.resize(np.arange(lo, hi + 1), n))
    start = rng.integers(0, int(mix["pool_images"]) - size + 1)
    return Schedule(due, start, size, float(seconds))
