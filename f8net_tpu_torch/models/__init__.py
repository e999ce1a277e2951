from .base import Model
from .mobilenet_v1 import build_mobilenet_v1
from .mobilenet_v2 import build_mobilenet_v2
from .resnet import build_resnet


def get_model(name: str, cfg, num_classes: int = 1000, image_size: int = 224) -> Model:
    """Model registry keyed by the reference's vocabulary
    (`f8net_tpu/models/__init__.py:get_model`).

    All three families reduce spatially by 32x, so the global-avgpool
    extent is image_size // 32."""
    pool_kernel = max(image_size // 32, 1)
    name = name.split(".")[-1]
    if name in ("fix_resnet", "resnet"):
        raise ValueError("resnet needs an explicit depth, e.g. 'resnet18'")
    if name.startswith(("fix_resnet", "resnet")):
        depth = int(name.replace("fix_resnet", "").replace("resnet", ""))
        return build_resnet(
            cfg, depth=depth, num_classes=num_classes, pool_kernel=pool_kernel
        )
    if name in ("fix_mobilenet_v2", "mobilenet_v2", "mobilenetv2"):
        return build_mobilenet_v2(cfg, num_classes=num_classes, pool_kernel=pool_kernel)
    if name in ("fix_mobilenet_v1", "mobilenet_v1", "mobilenetv1"):
        return build_mobilenet_v1(cfg, num_classes=num_classes, pool_kernel=pool_kernel)
    raise ValueError(f"unknown model {name!r}")


__all__ = ["Model", "build_mobilenet_v1", "build_mobilenet_v2", "build_resnet", "get_model"]
