from .bundle import (
    load_deploy_bundle, model_from_topology, params_from_numpy, qat_from_numpy, qat_to_numpy,
    save_deploy_bundle, tensors_from_numpy,
)
from .native_bundle import load_native_bundle, save_native_bundle
from .torch_export import build_torch_int_model, condition_input_torch, export_torchscript

__all__ = [
    "build_torch_int_model", "condition_input_torch", "export_torchscript", "load_deploy_bundle",
    "load_native_bundle", "model_from_topology", "params_from_numpy", "qat_from_numpy",
    "qat_to_numpy", "save_deploy_bundle", "save_native_bundle", "tensors_from_numpy",
]
