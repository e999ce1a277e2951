"""Offline scoring traffic: `distinct_batches` batches of `batch` uniform
uint8 images (NHWC), made on the device from the seed in one call; the
window dispatches them in turn, back to back."""

from __future__ import annotations

import torch

from ..harness.weights import generator


def make(mix: dict, image_size: int, seed: int, device) -> list:
    n, b = int(mix["distinct_batches"]), int(mix["batch"])
    g = generator(seed, "images", device)
    x = torch.randint(0, 256, (n * b, image_size, image_size, 3), generator=g, device=device,
                      dtype=torch.uint8)
    return list(x.split(b))
