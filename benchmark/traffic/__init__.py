"""Traffic: a mix is a data file (`<mix>.json`) whose `generator` names
the general generator beside it (`<generator>.py`) that reads it.  A
generator offers what its path asks for:

  offline  make(mix, image_size, seed, device) -> [uint8 NHWC batch, ...]
  serve    pool(mix, image_size, seed, device) -> uint8 NHWC images
           schedule(mix, seed, seconds, what) -> Schedule

The same seed gives the same inputs.  A later PR adds a mix as a data file,
or a generator as a file of its own."""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


@dataclasses.dataclass
class Schedule:
    due: np.ndarray  # seconds after the window's start
    start: np.ndarray  # first pool image of each request
    size: np.ndarray  # images in each request
    seconds: float


def load(mix: dict):
    """The generator module that `mix` names."""
    return importlib.import_module(f"{__name__}.{mix['generator']}")
