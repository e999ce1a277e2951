from .torch_ckpt import (
    load_hawq_checkpoint,
    load_ordered_conv_bn_fc,
    load_reference_checkpoint,
    load_torch_file,
    parse_nvidia_state_dict,
    parse_plain_cnn_state_dict,
)

__all__ = [
    "load_hawq_checkpoint", "load_ordered_conv_bn_fc", "load_reference_checkpoint",
    "load_torch_file", "parse_nvidia_state_dict", "parse_plain_cnn_state_dict",
]
