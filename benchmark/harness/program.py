"""The measured program, f8net_tpu_torch, through its public entry:
`models.get_model`, `utils.QuantConfig`, `quant.QuantPlan`,
`engine.IntEngine` and `engine.ServingEngine`.  This is the one file of the
harness that imports the program; it hands the program the weights and
plan the harness made, and takes back only the engine and the server."""

from __future__ import annotations

import numpy as np
import torch

from .graph import check_graph

QUANT_KEYS = ("format_from_metric", "metric", "quant_bias", "quant_avgpool", "pool_fusing",
              "normalize")


def model(cfg):
    from f8net_tpu_torch.models import get_model
    from f8net_tpu_torch.utils import QuantConfig

    qcfg = QuantConfig(**{k: cfg["quant"][k] for k in QUANT_KEYS})
    return get_model(cfg["name"], qcfg, num_classes=cfg["num_classes"],
                     image_size=cfg["image_size"])


def engine(cfg, records, params, options: dict, device):
    """The port's IntEngine with the keyword `options` of the cell's rung
    (the workload file's `engine`, such as {"int8_boundary": true}) on
    copies of the harness's weights and plan (the reference keeps the
    originals), after its graph is held against the configuration's
    table."""
    from f8net_tpu_torch.engine import IntEngine
    from f8net_tpu_torch.quant import LayerPlan, QuantPlan

    m = model(cfg)
    check_graph(cfg, m)
    plan = QuantPlan(tuple(LayerPlan(*r) for r in records))
    own = {name: {k: v.clone() for k, v in p.items()} for name, p in params.items()}
    return IntEngine(m, plan, own, device=device, **options)


def build_kernels(device) -> None:
    """Compiles the port's CUDA kernels that are not built yet, all at once
    (the program's own build cache, inside the checkout)."""
    if torch.device(device).type == "cuda":
        from f8net_tpu_torch.ops import _build

        _build.build_all()


def server(eng, settings: dict, image_size: int):
    from f8net_tpu_torch.engine import ServingEngine

    return ServingEngine(
        eng, buckets=tuple(settings["buckets"]), max_wait_ms=float(settings["max_wait_ms"]),
        ring_capacity=int(settings["ring_capacity"]), image_shape=(image_size, image_size, 3),
        image_dtype=np.uint8,
    ).start()
