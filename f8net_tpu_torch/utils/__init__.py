from .config import QuantConfig, TrainConfig
from .device import float32_exact, resolve_device
from .meters import ScalarMeter, flush_scalar_meters

__all__ = [
    "QuantConfig", "ScalarMeter", "TrainConfig", "float32_exact", "flush_scalar_meters",
    "resolve_device",
]
