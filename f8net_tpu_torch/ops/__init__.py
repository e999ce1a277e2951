from .conv import PackedConvWeight, conv_int8, conv_int8_plain, pack_conv_weight, plan_conv
from .conv_flat import conv_flat_int8, conv_flat_int8_plain, pack_flat, plan_flat, unpack_flat
from .dw import dw_int8, dw_int8_plain, plan_dw
from .fxp import fix_quant, pack_real, requant_net, shift_requant, to_real_bf16, wrap_i32
from .gemm import PackedK1Weight, int8_gemm, int8_gemm_plain, pack_k1_weight, plan_k1
from .gemm_v2 import int8_gemm_v2
from .ir_block import fused_ir_block, fused_ir_block_plain
from .stem import pack_stem_weight, stem_pool, stem_pool_plain

__all__ = [
    "PackedConvWeight", "PackedK1Weight", "conv_flat_int8", "conv_flat_int8_plain", "conv_int8",
    "conv_int8_plain", "dw_int8", "dw_int8_plain", "fix_quant", "int8_gemm", "int8_gemm_plain", "int8_gemm_v2",
    "fused_ir_block", "fused_ir_block_plain", "pack_conv_weight", "pack_flat",
    "pack_k1_weight", "pack_real", "pack_stem_weight", "plan_conv", "plan_dw", "plan_flat", "plan_k1", "requant_net", "shift_requant",
    "stem_pool", "stem_pool_plain", "to_real_bf16", "unpack_flat", "wrap_i32",
]
