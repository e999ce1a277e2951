from .config import QuantConfig
from .device import float32_exact, resolve_device

__all__ = ["QuantConfig", "float32_exact", "resolve_device"]
