from .baseline import plain_forward, plain_params
from .int_engine import IntEngine, add_zero_point_bias
from .serve import ServingEngine

__all__ = ["IntEngine", "ServingEngine", "add_zero_point_bias", "plain_forward", "plain_params"]
