from .bundle import (
    load_deploy_bundle, model_from_topology, params_from_numpy, qat_from_numpy, qat_to_numpy,
    save_deploy_bundle,
)

__all__ = [
    "load_deploy_bundle", "model_from_topology", "params_from_numpy", "qat_from_numpy",
    "qat_to_numpy", "save_deploy_bundle",
]
