"""Model container: the static layer graph and its block metadata
(the graph half of `f8net_tpu/models/base.py:Model`).

The port has no float `init` or `forward` yet: those come with QAT
(ROADMAP item 10).  The integer engine needs only the graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from ..nn.spec import LayerGraph


@dataclasses.dataclass
class Model:
    """A built model: immutable graph plus the walk order the engine uses."""

    name: str
    graph: LayerGraph
    cfg: Any
    block_setting: Any
    conv_order: List[str]  # layer names in the reference's named_modules order
    num_classes: int = 1000
    blocks: Any = None  # per-block metadata (body conv names; shortcut or residual flag)
    pool_fuse_layer: Optional[str] = None  # conv that absorbs 2^s/k^2 at int conversion
    pool_kernel: int = 7  # global-avgpool extent (image_size // 32)
