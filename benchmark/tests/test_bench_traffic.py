"""The traffic generators: the same seed gives the same inputs, and every
seed offers the same work."""

import numpy as np
import torch

from benchmark.traffic import batches, poisson

MIX = {"generator": "poisson", "rate_rps": 300.0, "images_min": 1, "images_max": 4,
       "pool_images": 256}


def test_schedule_repeats_from_the_seed():
    a, b = poisson.schedule(MIX, 2**40 + 3, 10.0), poisson.schedule(MIX, 2**40 + 3, 10.0)
    for f in ("due", "start", "size"):
        assert np.array_equal(getattr(a, f), getattr(b, f))


def test_every_seed_offers_the_same_work_in_another_order():
    a, b = poisson.schedule(MIX, 1, 10.0), poisson.schedule(MIX, 2**33 + 5, 10.0)
    assert len(a.due) == len(b.due) == 3000
    assert np.array_equal(np.sort(a.size), np.sort(b.size))
    ga, gb = np.round(np.diff(a.due), 12), np.round(np.diff(b.due), 12)
    assert len(np.intersect1d(ga, gb)) >= len(ga) - 1  # each window leaves its last gap out
    assert not np.array_equal(a.size, b.size)
    for s in (a, b):
        assert s.due[0] == 0.0 and s.due[-1] < 10.0 and np.all(np.diff(s.due) > 0)
        assert np.all(s.start >= 0) and np.all(s.start + s.size <= MIX["pool_images"])
        assert set(s.size.tolist()) == {1, 2, 3, 4}


def test_images_repeat_from_the_seed():
    mix = {"batch": 3, "distinct_batches": 2}
    x, y = batches.make(mix, 8, 2**35, "cpu"), batches.make(mix, 8, 2**35, "cpu")
    assert len(x) == 2 and all(torch.equal(p, q) for p, q in zip(x, y))
    assert x[0].dtype == torch.uint8 and x[0].shape == (3, 8, 8, 3)
    assert not torch.equal(x[0], batches.make(mix, 8, 2**35 + 1, "cpu")[0])
    p = poisson.pool(MIX, 8, 5, "cpu")
    assert p.shape == (256, 8, 8, 3) and torch.equal(p, poisson.pool(MIX, 8, 5, "cpu"))
