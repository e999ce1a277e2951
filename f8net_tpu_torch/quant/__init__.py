from .calibrate import reset_bn_for_calib
from .plan import LayerPlan, QuantPlan, bake_plan, folded_weight_bias

__all__ = ["LayerPlan", "QuantPlan", "bake_plan", "folded_weight_bias", "reset_bn_for_calib"]
