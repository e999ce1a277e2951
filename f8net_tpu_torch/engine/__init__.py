from .baseline import plain_forward, plain_params
from .int_engine import IntEngine, add_zero_point_bias
from .pp_engine import PPEngine, build_units, make_pipe_mesh, stage_bounds
from .serve import CrossHostServingEngine, ServingEngine
from .tp_engine import TPEngine, int_forward_tp, tp_local_params, tp_modes, tp_param_specs

__all__ = [
    "CrossHostServingEngine", "IntEngine", "PPEngine", "ServingEngine", "TPEngine", "add_zero_point_bias", "build_units",
    "int_forward_tp", "make_pipe_mesh", "plain_forward", "plain_params", "stage_bounds",
    "tp_local_params", "tp_modes", "tp_param_specs",
]
