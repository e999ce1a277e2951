from .baseline import plain_forward, plain_params
from .int_engine import IntEngine, add_zero_point_bias

__all__ = ["IntEngine", "add_zero_point_bias", "plain_forward", "plain_params"]
