from .calibrate import reset_bn_for_calib
from .pad_channels import pad_channels
from .plan import LayerPlan, QuantPlan, bake_plan, folded_weight_bias

__all__ = ["LayerPlan", "QuantPlan", "bake_plan", "folded_weight_bias", "pad_channels",
           "reset_bn_for_calib"]
