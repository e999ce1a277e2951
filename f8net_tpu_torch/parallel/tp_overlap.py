"""Explicit tensor-parallel int8 matmuls over a mesh's model axis (the port
of `f8net_tpu/parallel/tp_overlap.py`).

* `tp_paired_matmul_int8` (`:51-96`) -- the Megatron pairing: layer 1
  column-parallel (each rank its N columns of w1, the requant fused into
  the product's epilogue), layer 2 row-parallel (the same N rows of w2),
  one all-reduce of the int32 partials per pair, then the requant of the
  total.  b2 is added once, in rank 0's partial.
* `tp_ring_matmul_int8` (`:99-147`) -- all-gather overlapped with the
  products: each rank holds a K-shard of x and its N columns of w; at ring
  step q it multiplies the shard in hand by the matching K rows of its w
  while the shard travels one step around the ring (batch_isend_irecv),
  p - 1 sends in all.

Each product runs in K7 (ops.gemm_v2) where `ops.gemm_v2.takes` holds and
in K1 (ops.gemm) otherwise, on the tensors' device.  int32 sums wrap, and
the requant runs once on the total, so both are bitwise the unsharded
composition.
"""

from __future__ import annotations

import torch

from ..ops import gemm as _gemm
from ..ops import gemm_v2 as _gemm_v2
from ..ops.fxp import shift_requant, wrap_i32
from .mesh import Mesh


def requant8(acc: torch.Tensor, net: int, signed: bool) -> torch.Tensor:
    """int32 accumulator -> packed int8 operand (unsigned stored as u - 128)."""
    v = shift_requant(acc, 8, 0, net, signed)
    return (v if signed else v - 128).to(torch.int8)


def matmul_int8(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, **epi) -> torch.Tensor:
    """x @ w + bias (int8 operands, (K, N) weights) in K7 where it takes the
    shape, else in K1, with the epilogue `epi` (ops.gemm's)."""
    k, n = w.shape
    if _gemm_v2.takes(k, n):
        return _gemm_v2.int8_gemm_v2(x, _gemm_v2.pack_gemm_weight(w), bias, **epi)
    return _gemm.int8_gemm(x, _gemm.pack_k1_weight(w), bias, **epi)


def tp_paired_matmul_int8(
    mesh: Mesh, x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
    b2: torch.Tensor, *, net1: int, net2: int, signed1: bool = False, signed2: bool = True,
    axis: str = "model",
) -> torch.Tensor:
    """requant2(requant1(x @ w1 + b1) @ w2 + b2), Megatron-paired over `axis`.

    x: (M, K) int8, the same on every rank.  w1: (K, N/p) int8, this rank's
    columns; b1: (N/p,) int32, their biases.  w2: (N/p, O) int8, the same
    rows of w2; b2: (O,) int32, the same on every rank.  Returns (M, O) int8
    on every rank.  One all-reduce."""
    h8 = matmul_int8(x, w1, b1, epilogue="requant8", net=net1, out_signed=signed1)
    share = b2 if mesh.index(axis) == 0 else torch.zeros_like(b2)
    part = matmul_int8(h8, w2, share, epilogue="int32")
    return requant8(mesh.all_reduce(part, axis), net2, signed2)


def tp_ring_matmul_int8(
    mesh: Mesh, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, net: int,
    signed: bool = True, axis: str = "model",
) -> torch.Tensor:
    """requant(x @ w + b) with x K-sharded and the output N-sharded, through
    a ring that overlaps each step's transfer with its product.

    x: (M, K/p) int8, this rank's K-shard (rank i holds rows i*K/p...).
    w: (K, N/p) int8, all K rows of this rank's columns; b: (N/p,) int32.
    Returns (M, N/p) int8, this rank's columns."""
    p, idx = mesh.size(axis), mesh.index(axis)
    k = w.shape[0]
    if k % p:
        raise ValueError(f"K = {k} does not split over {p} ranks")
    kb = k // p
    acc, cur = None, x.contiguous()
    zero = torch.zeros(w.shape[1], dtype=torch.int32, device=x.device)
    for q in range(p):
        # the shard in hand after q steps started at ring index idx - q
        src = (idx - q) % p
        nxt = mesh.ring(cur, axis) if q != p - 1 else None
        part = matmul_int8(cur, w[src * kb:(src + 1) * kb].contiguous(),
                           b if q == 0 else zero, epilogue="int32")
        acc = part if acc is None else wrap_i32(acc.to(torch.int64) + part)
        if nxt is not None:
            cur = nxt()
    return requant8(acc, net, signed)
