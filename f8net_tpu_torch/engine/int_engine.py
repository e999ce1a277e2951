"""Integer-only inference engine -- the port of
`f8net_tpu/engine/int_engine.py` (`IntEngine` `:1456`) for ResNets,
MobileNetV2 and MobileNetV1, in its three boundary rungs:
  * strict (the default): block boundaries carry exact int32 accumulators;
  * int8-boundary (`int8_boundary=True`, `:1459-1490`): every block output
    is requantized once onto the next block's first conv's 8-bit grid and
    crosses memory packed, 1 byte per element; a residual add widens the
    packed carry back to int32 (`_widen`), and a second consumer on another
    grid (a ResNet shortcut) gets a widened-and-requantized copy;
  * bf16-boundary (`bf16_boundary=True`): every conv output with no unique
    consumer conv is emitted as its real value in bf16 (`_emit`
    `:813-825`, ops.fxp.to_real_bf16), residual adds are bf16 adds, and a
    conv reading a bf16 value quantizes it onto its 8-bit grid
    (ops.fxp.pack_real).
Every product runs in the port's kernels in all three rungs (the JAX engine
kept its Pallas kernels off the relaxed rungs, `:1483-1489`, except K5); the
conversions between int32, packed int8 and bf16 are glue.

ResNet, BasicBlock (18, 34) and Bottleneck (50, 101, 152) alike
(`_forward`'s ResNet branch `:1283-1361`, `_block_resnet_int` `:1054-1073`
and average pool/classifier `:1383-1415`, as the JAX engine runs it with
`stem_kernel=True` and the Pallas route of `conv_int` `:693-759`):
  * the head (7x7/s2 conv + bias + ReLU + 3x3/s2 maxpool) in K3 (ops.stem);
  * every 3x3 conv (stride 1 and 2) and the 1x1/s2 shortcuts in K2
    (ops.conv);
  * every 1x1/s1 conv whose GEMM K7 takes (ops.gemm_v2.takes: its domain,
    and at least 32 output channels) in K7, the persistent GEMM the JAX
    engine takes for 1x1/s1 convs under F8NET_PALLAS_GEMM=v2 (`:712-721`),
    on weights packed once, at construction: in a Bottleneck block body.0,
    body.2 and the 1x1/s1 shortcut of stage 0's first block, 33 launches
    per ResNet-50 forward beside 19 of K2; the other 1x1/s1 convs in K1;
  * intra-block convs end in the requant8 epilogue, packed for their unique
    consumer; the last body conv and the shortcut end in int32 for the
    residual add (converted to bf16 in the bf16 rung);
  * the stem stays whole in K3 in every rung: its pooled int32 is packed
    for stage 0's first conv (int8 rung) or converted to bf16 (bf16 rung)
    after the pool.  The reference packs or converts before an XLA maxpool
    (`:1338-1356`, int8 init -128); the two agree exactly, because the
    requant with its u - 128 map and int32 -> float32 -> bf16 are monotone
    non-decreasing, so max commutes with them, and every 3x3/s2/p1 window
    holds a real pixel, so no pad value is ever the max.

MobileNetV2 (`_forward`'s MobileNetV2 branch `:1367-1381`,
`_block_mbv2_int` `:1112-1136`, `try_fused_ir` `:862-1031` in its strict
form):
  * the head (3x3/s2 over C = 3) in K2, requant8 packed for the first
    block: its weights are padded once with zero input channels to 16, the
    wire input's channels likewise (any value meets a zero weight, and zero
    rows add nothing to the zero-point colsum);
  * every block whose body is a 1x1/s1 expand, a kxk/s1 depthwise with pad
    (k-1)/2 and a 1x1/s1 project in K5 (ops.ir_block), 12 at the published
    block setting -- decided from the graph's structure alone -- with its
    expand and project weights packed once, at construction; a residual
    block takes its carry as int32 (strict) or packed 1-byte (int8 rung,
    widened in K5's epilogue) and ends in int32 (strict), requant8 for the
    next block (int8 rung), or bf16 followed by the bf16 add outside K5
    (bf16 rung);
  * the other blocks layer by layer: depthwise convs (stride 1 and 2) in K4
    (ops.dw), 1x1/s1 convs as GEMMs over N*H*W rows, in K7 where it takes
    them (6 per forward) and in K1 otherwise (the 24 -> 144 expand, K = 24,
    and the 32 -> 16 and 96 -> 24 projects), on weights packed once, at
    construction (ops.gemm.pack_k1_weight);
  * the tail (1x1 to 1280, int32 + ReLU) in K7; in the bf16 rung its ReLU
    stays fused before the conversion to bf16, with which it commutes.

MobileNetV1 (`_forward`'s MobileNetV1 branch `:1362-1366`, `_block_mbv1_int`
`:1092-1100`): a straight chain in which every conv packs its output for its
unique consumer -- the head in K2 as MobileNetV2's (input channels padded
to 16), each block's depthwise conv in K4 and its pointwise conv in K7 (or
K1 where K7 does not take the GEMM) -- but for the last block's pointwise
conv, which keeps int32 with its ReLU fused for the pool.  The reference's
MobileNetV1 branch has no pack target, so its int8 rung is the strict
forward, and its bf16 rung differs only in that last output, emitted in
bf16 (its ReLU commutes with the conversion).

All: the classifier in K1 (ops.gemm) on weights packed at construction,
int32 epilogue, logits float32.  The glue -- the input pack, the pack of a
carry for the next conv, the conversions of the relaxed rungs, the aligned
wrapping residual add (or the bf16 add), ReLU and the average pool
(shift-sum; an f32 sum of bf16 values in the bf16 rung) -- is plain torch on
the same device.

Each rung's results are the JAX engine's `IntEngine(int_only=True)` with the
same rung's flag, bit for bit, whichever route that engine takes -- in the
bf16 rung up to the average pool, whose f32 sum may take its terms in
another order than XLA's, and with every bf16 value rounded where the
reference's code rounds it (XLA may otherwise keep a fused bf16 value in
float32: its `xla_allow_excess_precision`).

`IntEngine(int_only=False)` is the reference's float-dtype cross-check
("integize", `float_sim_forward` `:1214`, `:1417-1452`): the same integer
values carried in float32 through F.conv2d and a float32 matmul (full
float32 on the card, `utils.float32_exact`), with no kernel and no packing.
It equals the integer engine while every float32 partial sum stays below
2^24, and its logits stay on the 2^out_fl integer grid.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..nn.pool import avgpool_shift_for
from ..nn.quant_layers import conv2d_nhwc, matmul_f32, maxpool
from ..nn.spec import ConvBNSpec, LinearSpec
from ..ops import conv as _conv
from ..ops import dw as _dw
from ..ops import gemm as _gemm
from ..ops import gemm_v2 as _gemm_v2
from ..ops import ir_block as _ir
from ..ops import stem as _stem
from ..ops.fxp import INT32_MAX, fix_quant, pack_real, shift_requant, to_real_bf16, wrap_i32
from ..quant.pad_channels import pad_channels
from ..utils.device import resolve_device


class IAct(NamedTuple):
    """Activation at fraclen `fl`: int32, an int8 operand already packed
    (requantized, unsigned stored as u - 128) for conv `packed_for`, or
    (`scaled`, bf16 rung) its real value in bf16."""

    x: torch.Tensor
    fl: int
    packed_for: Optional[str] = None
    scaled: bool = False


def add_zero_point_bias(graph, plan, int_params):
    """Fold the unsigned-activation compensation 128 * colsum(w) into a
    'b_zp' entry for every layer with an unsigned input
    (`int_engine.py:1219-1233`)."""
    out = {}
    for name, entry in int_params.items():
        e = dict(entry)
        if not plan[name].input_symmetric:
            dims = (0,) if isinstance(graph[name], LinearSpec) else (0, 1, 2)
            comp = 128 * entry["w"].to(torch.int64).sum(dims)
            b = entry["b"].to(torch.int64) if "b" in entry else 0
            e["b_zp"] = wrap_i32(b + comp)
        out[name] = e
    return out


def is_pointwise(spec) -> bool:
    """A 1x1/s1 conv without padding or groups: a GEMM over N*H*W rows."""
    return (
        spec.kernel == (1, 1) and spec.stride == (1, 1) and spec.padding == (0, 0)
        and spec.groups == 1
    )


def is_bottleneck(graph, meta) -> bool:
    """A ResNet Bottleneck block: a body of three convs whose middle one is
    a full (not depthwise) conv -- which sets it apart from MobileNetV2's
    expand / depthwise / project body."""
    return len(meta.body) == 3 and not graph[meta.body[1]].is_depthwise


def fuses_ir(graph, meta) -> bool:
    """Whether an inverted-residual block runs whole in K5: a body of three,
    1x1/s1 expand, square kxk depthwise at stride 1 with pad (k-1)/2, 1x1/s1
    project (`try_fused_ir`'s structural test, `int_engine.py:872-890`, with
    the pad guard that test lacked).  The TPU's VMEM limits are not ported:
    every such block fuses, the 960-channel 7x7 ones included."""
    if len(meta.body) != 3:
        return False
    se, sd, sp = (graph[n] for n in meta.body)
    k = sd.kernel[0]
    return (
        is_pointwise(se) and is_pointwise(sp) and sd.is_depthwise
        and sd.kernel == (k, k) and k % 2 == 1 and sd.stride == (1, 1)
        and sd.padding == ((k - 1) // 2,) * 2
    )


class IntEngine:
    """Integer inference engine bound to a plan and its int params.

    device: where the engine runs; "cuda" (the default) raises when there is
    no card.  int8_boundary / bf16_boundary: the relaxed rung (at most one);
    neither is the strict rung.  int_only=False: the float-dtype
    cross-check (module docstring), strict rung only.  pad_channels_to=N
    (integer engine only, as the reference's `int_engine.py:1495-1504`):
    every channel count below N padded with zero weights to a multiple of
    N before packing (quant.pad_channels), bit-exact; `model` and `graph`
    are then the padded ones, and the routing follows the padded shapes."""

    def __init__(self, model, plan, int_params, cfg=None, device="cuda",
                 int8_boundary: bool = False, bf16_boundary: bool = False,
                 int_only: bool = True, pad_channels_to: int = 0):
        if int8_boundary and bf16_boundary:
            raise ValueError("int8_boundary and bf16_boundary exclude each other")
        if not int_only and (int8_boundary or bf16_boundary):
            raise ValueError("the boundary rungs need the integer engine (int_only=True)")
        if int_only and pad_channels_to:
            model, int_params = pad_channels(model, int_params, multiple=pad_channels_to,
                                             threshold=pad_channels_to)
        self.int8_boundary, self.bf16_boundary = int8_boundary, bf16_boundary
        self.int_only = int_only
        self.device = resolve_device(device)
        if not (model.name.startswith("resnet") or model.name in ("mobilenet_v2", "mobilenet_v1")):
            raise NotImplementedError(f"{model.name}: no engine path for this family")
        self.model = model
        self.graph = model.graph
        self.plan = plan
        self.cfg = cfg or model.cfg
        params = {
            name: {k: v.to(self.device) for k, v in entry.items()}
            for name, entry in int_params.items()
        }
        if not int_only:
            self.params = params
            return
        self.params = add_zero_point_bias(self.graph, plan, params)
        # the layers of MobileNetV2 blocks that run whole in K5
        self._in_k5 = {
            name for m in model.blocks if fuses_ir(self.graph, m) for name in m.body
        } if model.name == "mobilenet_v2" else set()
        self._gemm, self._convk, self._stemk = _gemm.int8_gemm, _conv.conv_int8, _stem.stem_pool
        self._dwk, self._irk = _dw.dw_int8, _ir.fused_ir_block
        self._gemm2 = _gemm_v2.int8_gemm_v2
        # weights in the kernels' own layouts, packed once: every K2 and K7
        # layer's (K-major 16-byte chunks), every K1 layer's and the
        # classifier's (columns k-contiguous) and, for ResNets, the stem's
        # (K3); K5's expand and project weights are packed in _fused
        # only the layers `int_params` holds: a pipeline stage's engine
        # (engine.pp_engine) gets its stage's layers alone
        names = [name for name in self.graph.names() if name in self.params]
        self._packed = {
            name: _conv.pack_conv_weight(self.params[name]["w"])
            for name in names
            if isinstance(self.graph[name], ConvBNSpec) and name != "head"
            and not is_pointwise(self.graph[name]) and not self.graph[name].is_depthwise
        }
        for name in names:
            spec = self.graph[name]
            if not (isinstance(spec, ConvBNSpec) and is_pointwise(spec)) or name in self._in_k5:
                continue
            w = self.params[name]["w"]
            w = w.reshape(-1, w.shape[-1])
            pack = _gemm_v2.pack_gemm_weight if self.on_k7(name) else _gemm.pack_k1_weight
            self._packed[name] = pack(w)
        if "classifier" in self.params:
            self._packed["classifier"] = _gemm.pack_k1_weight(self.params["classifier"]["w"])
        if model.name.startswith("mobilenet"):
            if "head" in self.params:
                w = self.params["head"]["w"]
                cpad = -w.shape[2] % 16
                self._packed["head"] = _conv.pack_conv_weight(F.pad(w, (0, 0, 0, cpad)))
            self._fused = {
                m.body[0]: self._ir_operands(m) for m in model.blocks
                if fuses_ir(self.graph, m) and m.body[0] in self.params
            }
        elif "head" in self.params:
            self._stem_w = _stem.pack_stem_weight(self.params["head"]["w"])

    def launch_table(self) -> dict:
        """Kernel launches one forward makes, by kernel function name, from
        the graph's structure and the routing (on_k7, fuses_ir): the head
        in K3 (ResNets) or K2, each K5 block once, every other conv by its
        kind, the classifier in K1.  Only the layers this engine holds."""
        out = {}

        def add(kernel):
            out[kernel] = out.get(kernel, 0) + 1

        for name in self.graph.names():
            spec = self.graph[name]
            if name not in self.params or (name in self._in_k5 and name not in self._fused):
                continue
            if name in self._in_k5:
                add("ir_block")
            elif isinstance(spec, LinearSpec):
                add("int8_gemm")
            elif name == "head":
                add("conv_int8" if self.model.name.startswith("mobilenet") else "stem_pool")
            elif is_pointwise(spec):
                add("int8_gemm_v2" if self.on_k7(name) else "int8_gemm")
            else:
                add("dw_int8" if spec.is_depthwise else "conv_int8")
        return out

    def on_k7(self, name: str) -> bool:
        """Whether layer `name` runs in K7: a 1x1/s1 conv outside a K5 block
        whose GEMM K7 takes (ops.gemm_v2.takes)."""
        spec = self.graph[name]
        return (isinstance(spec, ConvBNSpec) and is_pointwise(spec) and name not in self._in_k5
                and _gemm_v2.takes(spec.in_ch, spec.out_ch))

    # -- input -------------------------------------------------------------

    def condition_input(self, images) -> torch.Tensor:
        """Reference input conditioning (`int_engine.py:1563-1579`): images
        in [0, 1], NHWC float -> the engine's wire input on its device:
        round(255 * image) as uint8 (unnormalized pipeline), or the head's
        8-bit signed grid as int8 (normalized pipeline).  The float-dtype
        engine takes float32: round(255 * image) / 256, or the normalized
        image itself (quantized inside the forward)."""
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        head = self.plan["head"]
        if not self.int_only:
            return images if self.cfg.normalize else torch.round(255.0 * images) / 256.0
        if self.cfg.normalize:
            q, _ = fix_quant(images, 8, float(head.input_fl), 3, head.input_symmetric)
            return torch.round(q * 2.0**head.input_fl).to(torch.int8)
        return torch.round(255.0 * images).to(torch.uint8)

    # -- glue --------------------------------------------------------------

    def pack_for(self, act: IAct, name: str) -> IAct:
        """Requantize an activation to `name`'s 8-bit input format and pack
        it (s8 = u8 - 128 for unsigned inputs); `int_engine.py:440-502`.  An
        operand packed for another conv (int8 rung: a carry feeding body.0
        and a shortcut) is reused when the two grids coincide, else widened
        and requantized; a bf16 value is quantized straight onto the grid."""
        if act.packed_for is not None:
            if act.packed_for == name:
                return act
            if not self.int8_boundary:
                raise ValueError(f"operand packed for {act.packed_for}, not {name}")
            src, pl = self.plan[act.packed_for], self.plan[name]
            if (src.input_fl, src.input_symmetric) == (pl.input_fl, pl.input_symmetric):
                return IAct(act.x, act.fl, packed_for=name)
            return self.pack_for(self._widen(act), name)
        pl = self.plan[name]
        if act.scaled:
            return IAct(pack_real(act.x, pl.input_fl, pl.input_symmetric), pl.input_fl,
                        packed_for=name)
        v = shift_requant(act.x, 8, pl.input_fl, act.fl, pl.input_symmetric)
        v8 = (v if pl.input_symmetric else v - 128).to(torch.int8)
        return IAct(v8, pl.input_fl, packed_for=name)

    def _widen(self, act: IAct) -> IAct:
        """A packed operand -> its int32 grid value, exactly (u - 128 + 128
        on an unsigned grid); `int_engine.py:504-514`."""
        v = act.x.to(torch.int32)
        if not self.plan[act.packed_for].input_symmetric:
            v = v + 128
        return IAct(v, act.fl)

    def add_int(self, res: IAct, x: IAct) -> IAct:
        """Residual add (`int_engine.py:833-860`).  int32: packed carries
        widened first, the lower-fraclen operand shifted onto the common
        grid, the add wrapping in int32, a clip to +-INT32_MAX.  bf16 rung:
        both real values, added in float32 and rounded once to bf16 (what
        XLA's and torch's bf16 adds compute)."""
        if res.scaled or x.scaled:
            if not (res.scaled and x.scaled):
                raise ValueError("a bf16 value added to an integer one")
            s = (res.x.to(torch.float32) + x.x.to(torch.float32)).to(torch.bfloat16)
            return IAct(s, max(res.fl, x.fl), scaled=True)
        if res.packed_for is not None:
            res = self._widen(res)
        if x.packed_for is not None:
            x = self._widen(x)
        r, v = res.x.to(torch.int64), x.x.to(torch.int64)
        if res.fl >= x.fl:
            v = wrap_i32(v << (res.fl - x.fl)).to(torch.int64)
            out_fl = res.fl
        else:
            r = wrap_i32(r << (x.fl - res.fl)).to(torch.int64)
            out_fl = x.fl
        return IAct(wrap_i32(r + v).clamp(-INT32_MAX, INT32_MAX), out_fl)

    @staticmethod
    def relu_i32(act: IAct) -> IAct:
        return IAct(act.x.clamp_min(0), act.fl, scaled=act.scaled)

    # -- layers ------------------------------------------------------------

    def _bias_pad(self, name: str):
        """(bias, pad value): zero-point bias and -128 pads for an unsigned
        input, the plain bias and 0 pads for a signed one."""
        p = self.params[name]
        if self.plan[name].input_symmetric:
            return p["b"], 0
        return p["b_zp"], -128

    def _wire_operand(self, x: torch.Tensor) -> torch.Tensor:
        """The wire input requantized onto the head's 8-bit grid and packed
        (`int_engine.py:1312-1317`)."""
        pl = self.plan["head"]
        v = shift_requant(x.to(torch.int32), 8, pl.input_fl, pl.input_fl, pl.input_symmetric)
        zp = 0 if pl.input_symmetric else 128
        return (v - zp).to(torch.int8)

    def head(self, x: torch.Tensor) -> IAct:
        """Wire input -> pooled stem activation through K3
        (`int_engine.py:1290-1356`): int32, or after the pool packed for
        stage 0's first conv (int8 rung) or converted to bf16 (bf16 rung);
        see the module docstring for why that equals the reference's
        conversion before the pool."""
        b, pad = self._bias_pad("head")
        pooled = self._stemk(self._wire_operand(x), self._stem_w, b, pad_value=pad)
        a = IAct(pooled, self.plan["head"].out_fl)
        if self.int8_boundary:
            return self.pack_for(a, self.model.blocks[0].body[0])
        return self._emit(a)

    def head_conv(self, x: torch.Tensor, pack_output_for: Optional[str]) -> IAct:
        """Wire input -> MobileNetV2 head through K2 with its input channels
        padded to the padded weights' (`int_engine.py:1373-1377`)."""
        v8 = self._wire_operand(x)
        w = self._packed["head"]
        v8 = F.pad(v8, (0, w.c - v8.shape[3]))
        return self._product("head", v8, w, pack_output_for)

    def conv_int(
        self, name: str, act: IAct, pack_output_for: Optional[str] = None, relu: bool = False
    ) -> IAct:
        """int8 conv; requant8 epilogue packed for a unique consumer conv,
        int32 otherwise (`int_engine.py:549-803`)."""
        act = self.pack_for(act, name)
        w = self._packed.get(name, self.params[name]["w"])
        return self._product(name, act.x, w, pack_output_for, relu)

    def _product(self, name, x8, w, pack_output_for, relu=False) -> IAct:
        """Layer `name` on its packed operand `x8`, routed by the layer's
        structure: depthwise -> K4, 1x1/s1 -> K7 where it takes the GEMM and
        K1 otherwise, as GEMMs over N*H*W rows, any other conv -> K2 (with
        its weights packed at construction)."""
        pl = self.plan[name]
        if pack_output_for is None:
            return self._emit(IAct(self._run(name, x8, w, relu, epilogue="int32"), pl.out_fl))
        cons = self.plan[pack_output_for]
        y = self._run(name, x8, w, relu, epilogue="requant8", net=pl.out_fl - cons.input_fl,
                      out_signed=cons.input_symmetric)
        return IAct(y, cons.input_fl, packed_for=pack_output_for)

    def _run(self, name, x8, w, relu=False, **epi) -> torch.Tensor:
        """The kernel call of layer `name` with the epilogue `epi` (ops.gemm's
        keywords) and the layer's bias and pad value.  launch_table() restates
        this routing: a change here changes it there."""
        spec = self.graph[name]
        b, pad = self._bias_pad(name)
        if is_pointwise(spec):
            n, h, wd, c = x8.shape
            k = self._gemm2 if self.on_k7(name) else self._gemm  # packed at construction
            return k(x8.reshape(-1, c), w, b, relu=relu, **epi).reshape(n, h, wd, -1)
        kw = dict(stride=spec.stride[0], padding=spec.padding[0], pad_value=pad, relu=relu)
        k = self._dwk if spec.is_depthwise else self._convk
        return k(x8, w, b, **kw, **epi)

    def _emit(self, a: IAct) -> IAct:
        """An int32 output with no unique consumer conv: kept (strict and
        int8 rungs) or converted to its bf16 real value (bf16 rung;
        `_emit`, `int_engine.py:813-825`)."""
        if self.bf16_boundary:
            return IAct(to_real_bf16(a.x, a.fl), a.fl, scaled=True)
        return a

    def block(self, meta, a: IAct, pack_target: Optional[str] = None) -> IAct:
        """ResNet BasicBlock or Bottleneck (`_block_resnet_int`,
        `int_engine.py:1054-1073`); in the int8 rung the output is packed
        for `pack_target`, the next block's first conv (the last block's
        stays int32 for the pool)."""
        v = a
        for prev, nxt in zip(meta.body[:-1], meta.body[1:]):
            v = self.conv_int(prev, v, pack_output_for=nxt)
        res = self.conv_int(meta.body[-1], v)
        s = a if meta.shortcut is None else self.conv_int(meta.shortcut, a)
        out = self.relu_i32(self.add_int(res, s))
        if self.int8_boundary and pack_target is not None:
            return self.pack_for(out, pack_target)
        return out

    def _ir_operands(self, meta):
        """(w1, b1, wd, bd, w2, b2) of a fused block in K5's layouts: the
        expand and project weights packed once, as the 1x1 weights of K5's
        operand layout, with the zero-point-compensated biases, the
        depthwise weights (k, k, Ce) with the plain bias, since K5's
        depthwise runs on unpacked values (`int_engine.py:932-954`)."""
        en, dn, pn = meta.body
        sd = self.graph[dn]
        ce, k = sd.out_ch, sd.kernel[0]
        w1 = _gemm_v2.pack_gemm_weight(self.params[en]["w"].reshape(-1, ce))
        w2 = _gemm_v2.pack_gemm_weight(self.params[pn]["w"].reshape(ce, -1))
        wd = self.params[dn]["w"].reshape(k, k, ce)
        return w1, self._bias_pad(en)[0], wd, self.params[dn]["b"], w2, self._bias_pad(pn)[0]

    def fused_ir(self, meta, a: IAct, next_consumer: Optional[str],
                 pack_target: Optional[str] = None) -> IAct:
        """A whole inverted-residual block through K5 (`try_fused_ir`,
        `int_engine.py:862-1031`).  A residual block adds the carry `a` on
        the common grid: int32 (strict) or packed 1-byte, widened in K5 by
        the offset of its grid (int8 rung), ending in int32 or, in the int8
        rung, requant8 packed for `pack_target`; a bf16 carry (bf16 rung)
        is added outside K5 to its bf16 output.  Any other block ends in
        requant8 packed for a unique consumer, or for `pack_target` in the
        int8 rung, else in bf16 (bf16 rung) or int32."""
        en, dn, pn = meta.body
        ple, pld, plp = self.plan[en], self.plan[dn], self.plan[pn]
        ap = self.pack_for(a, en)
        kw = dict(
            net1=ple.out_fl - pld.input_fl, dw_in_signed=pld.input_symmetric,
            net2=pld.out_fl - plp.input_fl, proj_in_signed=plp.input_symmetric,
        )
        ops = self._fused[en]

        def requant8_for(name, y_fl, *carry, **ckw):
            cons = self.plan[name]
            y8 = self._irk(ap.x, *ops, *carry, out="requant8", net_out=y_fl - cons.input_fl,
                           out_signed=cons.input_symmetric, **ckw, **kw)
            return IAct(y8, cons.input_fl, packed_for=name)

        if meta.residual:
            if a.scaled:
                y = self._irk(ap.x, *ops, out="bf16", out_fl=plp.out_fl, **kw)
                return self.add_int(IAct(y, plp.out_fl, scaled=True), a)
            offset = 0
            if a.packed_for is not None:  # a 1-byte carry on its grid
                offset = 0 if self.plan[a.packed_for].input_symmetric else 128
            rf, vf = plp.out_fl, a.fl
            ckw = dict(shift_res=max(vf - rf, 0), shift_carry=max(rf - vf, 0),
                       carry_add_offset=offset)
            if self.int8_boundary and pack_target is not None:
                return requant8_for(pack_target, max(rf, vf), a.x, **ckw)
            return IAct(self._irk(ap.x, *ops, a.x, out="int32", **ckw, **kw), max(rf, vf))
        if next_consumer is None and self.int8_boundary and pack_target is not None:
            next_consumer = pack_target
        if next_consumer is not None:
            return requant8_for(next_consumer, plp.out_fl)
        if self.bf16_boundary:
            y = self._irk(ap.x, *ops, out="bf16", out_fl=plp.out_fl, **kw)
            return IAct(y, plp.out_fl, scaled=True)
        return IAct(self._irk(ap.x, *ops, out="int32", **kw), plp.out_fl)

    def block_mbv2(self, meta, a: IAct, next_consumer: Optional[str],
                   pack_target: Optional[str] = None) -> IAct:
        """Inverted residual (`_block_mbv2_int`, `int_engine.py:1112-1136`):
        whole in K5 where the structure allows, else layer by layer with
        fused requant8 edges; residual blocks keep int32 (bf16) ends for
        the aligned add, and there is no post-add ReLU.  In the int8 rung a
        block output that is not packed for a unique consumer is packed for
        `pack_target`, the next block's first conv or the tail."""
        if meta.body[0] in self._fused:
            return self.fused_ir(meta, a, next_consumer, pack_target)
        v = a
        for prev, nxt in zip(meta.body[:-1], meta.body[1:]):
            v = self.conv_int(prev, v, pack_output_for=nxt)
        if meta.residual:
            out = self.add_int(self.conv_int(meta.body[-1], v), a)
            if self.int8_boundary and pack_target is not None:
                out = self.pack_for(out, pack_target)
            return out
        if next_consumer is None and self.int8_boundary:
            next_consumer = pack_target
        return self.conv_int(meta.body[-1], v, pack_output_for=next_consumer)

    def block_mbv1(self, meta, a: IAct, next_consumer: Optional[str]) -> IAct:
        """Depthwise-separable block (`_block_mbv1_int`,
        `int_engine.py:1092-1100`): the depthwise output packed for the
        pointwise conv, the pointwise output for the next block's depthwise;
        the block's ReLU is the next conv's unsigned requant clamp.  The last
        block keeps int32 (bf16 in the bf16 rung) with its ReLU fused into
        the product, for the pool."""
        a = self.conv_int(meta.body[0], a, pack_output_for=meta.body[1])
        if next_consumer is not None:
            return self.conv_int(meta.body[1], a, pack_output_for=next_consumer)
        return self.conv_int(meta.body[1], a, relu=True)

    def features_mbv1(self, x: torch.Tensor) -> IAct:
        """Head and blocks (`int_engine.py:1362-1366`), every output packed
        for its unique consumer but the last block's."""
        blocks = self.model.blocks
        a = self.head_conv(x, blocks[0].body[0])
        for meta, nxt in zip(blocks, [m.body[0] for m in blocks[1:]] + [None]):
            a = self.block_mbv1(meta, a, nxt)
        return a

    def features_mbv2(self, x: torch.Tensor) -> IAct:
        """Head, blocks and tail (`int_engine.py:1367-1381`): a block's
        output is packed for the next block's first conv unless that block
        is residual (then it is the carry: int32, bf16, or in the int8 rung
        packed for that conv all the same); the last block's is packed for
        the tail, whose ReLU is fused into K7."""
        blocks = self.model.blocks
        consumers = [None if nxt.residual else nxt.body[0] for nxt in blocks[1:]] + ["tail"]
        ptargets = [nxt.body[0] for nxt in blocks[1:]] + ["tail"]
        a = self.head_conv(x, None if blocks[0].residual else blocks[0].body[0])
        for meta, nxt, pt in zip(blocks, consumers, ptargets):
            a = self.block_mbv2(meta, a, nxt, pt)
        return self.conv_int("tail", a, relu=True)

    def avgpool(self, a: IAct) -> IAct:
        """Global average pool (`int_engine.py:1383-1415`): the shift-sum
        with an int32 (wrapping) sum under quant_avgpool -- for a bf16 value
        the exact sum rounded to f32, times 2^-shift, rounded to bf16 --
        else the reference's float mean (of the real value, or of the
        integers / 2^fl) requantized to the classifier's grid."""
        if self.cfg.quant_avgpool:
            shift = avgpool_shift_for(self.model.pool_kernel)
            if a.scaled:
                # the bf16 terms summed exactly (in float64: each is a multiple
                # of 2^-fl below 2^(32 - fl), so the sums of 49 keep far fewer
                # than 53 bits), then rounded once to float32 -- the same bits
                # whatever order a device takes the terms in, and whatever the
                # channel count (a tensor-parallel rank pools C/tp of them)
                s = a.x.to(torch.float64).sum((1, 2)).to(torch.float32) * float(2.0**-shift)
                return IAct(s.to(torch.bfloat16), a.fl + shift, scaled=True)
            return IAct(wrap_i32(a.x.sum((1, 2), dtype=torch.int64)), a.fl + shift)
        m = a.x.to(torch.float32).mean((1, 2))
        if not a.scaled:
            m = m / 2.0**a.fl
        pl = self.plan["classifier"]
        q, _ = fix_quant(m, 8, float(pl.input_fl), 1, pl.input_symmetric)
        return IAct(torch.round(q * 2.0**pl.input_fl).to(torch.int32), pl.input_fl)

    def classifier(self, a: IAct) -> torch.Tensor:
        """int8 classifier GEMM through K1, int32 epilogue, float32 logits
        (`_classifier_int`, `int_engine.py:1151-1173`); a bf16 input is
        quantized onto its grid by pack_for."""
        a = self.pack_for(a, "classifier")
        p = self.params["classifier"]
        b = p.get("b") if self.plan["classifier"].input_symmetric else p["b_zp"]
        if b is None:
            b = torch.zeros(p["w"].shape[1], dtype=torch.int32, device=self.device)
        return self._gemm(a.x, self._packed["classifier"], b, epilogue="int32").to(torch.float32)

    # -- the float-dtype cross-check (int_only=False) ------------------------

    def conv_sim(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A real-valued input quantized onto the layer's 8-bit grid, the
        conv on integer-valued float32 operands plus the bias, clipped to
        the int32 range and rescaled (`_Walker.conv_sim`, `:1035-1047`)."""
        pl, spec = self.plan[name], self.graph[name]
        q, _ = fix_quant(x, 8, float(pl.input_fl), x.ndim - 1, pl.input_symmetric)
        xi = torch.round(q * 2.0**pl.input_fl)
        p = self.params[name]
        y = conv2d_nhwc(xi, p["w"].to(torch.float32), spec) + p["b"].to(torch.float32)
        return torch.clamp(y, -float(INT32_MAX), float(INT32_MAX)) / 2.0**pl.out_fl

    @staticmethod
    def add_sim(res, res_fl: int, x, x_fl: int):
        """Residual add on the larger fraclen's grid, saturated to the int32
        range (`_Walker.add_sim`, `:1049-1053`)."""
        out_fl = max(res_fl, x_fl)
        scale = 2.0**out_fl
        s = torch.clamp(res * scale + x * scale, -float(INT32_MAX), float(INT32_MAX))
        return s / scale, out_fl

    def block_sim(self, meta, x, fl: int):
        """One block of any family (`_block_resnet_sim` `:1076`,
        `_block_mbv1_sim` `:1103`, `_block_mbv2_sim`): a ReLU before every
        body conv but the first; the residual add (ResNet: and its ReLU);
        MobileNetV1 ends in a ReLU."""
        x_in, fl_in = x, fl
        for i, name in enumerate(meta.body):
            if i > 0:
                x = x.clamp_min(0.0)
            x = self.conv_sim(name, x)
        fl = self.plan[meta.body[-1]].out_fl
        if hasattr(meta, "shortcut"):
            if meta.shortcut is None:
                s, s_fl = x_in, fl_in
            else:
                s, s_fl = self.conv_sim(meta.shortcut, x_in), self.plan[meta.shortcut].out_fl
            x, fl = self.add_sim(x, fl, s, s_fl)
            return x.clamp_min(0.0), fl
        if getattr(meta, "residual", False):
            return self.add_sim(x, fl, x_in, fl_in)
        if self.model.name == "mobilenet_v1":
            x = x.clamp_min(0.0)
        return x, fl

    def float_sim(self, x: torch.Tensor) -> torch.Tensor:
        """The float-dtype forward (`int_engine.py:1417-1452`): conditioned
        float input -> logits on the classifier's 2^out_fl integer grid."""
        head = self.plan["head"]
        if self.cfg.normalize:
            q, _ = fix_quant(x, 8, float(head.input_fl), 3, head.input_symmetric)
            xi = torch.round(q * 2.0**head.input_fl)
        else:
            xi = torch.round(x * 2.0**head.input_fl)
        p = self.params["head"]
        hx = conv2d_nhwc(xi, p["w"].to(torch.float32), self.graph["head"])
        hx = torch.clamp(hx + p["b"].to(torch.float32), -float(INT32_MAX), float(INT32_MAX))
        hx, fl = (hx / 2.0**head.out_fl).clamp_min(0.0), head.out_fl
        if self.model.name.startswith("resnet"):
            hx = maxpool(hx, 3, 2, 1).x
        for meta in self.model.blocks:
            hx, fl = self.block_sim(meta, hx, fl)
        if self.model.name == "mobilenet_v2":
            hx = self.conv_sim("tail", hx).clamp_min(0.0)
        if self.cfg.quant_avgpool:
            hx = hx.sum((1, 2)) / 2.0 ** avgpool_shift_for(self.model.pool_kernel)
        else:
            hx = hx.mean((1, 2))
        pl, p = self.plan["classifier"], self.params["classifier"]
        q, _ = fix_quant(hx, 8, float(pl.input_fl), 1, pl.input_symmetric)
        y = matmul_f32(torch.round(q * 2.0**pl.input_fl), p["w"].to(torch.float32))
        if "b" in p:
            y = y + p["b"].to(torch.float32)
        return torch.clamp(y, -float(INT32_MAX), float(INT32_MAX))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Conditioned input (condition_input's output) -> float32 logits."""
        x = x.to(self.device)
        if not self.int_only:
            return self.float_sim(x)
        if self.model.name == "mobilenet_v2":
            a = self.features_mbv2(x)
        elif self.model.name == "mobilenet_v1":
            a = self.features_mbv1(x)
        else:
            blocks = self.model.blocks
            a = self.head(x)
            for meta, pt in zip(blocks, [m.body[0] for m in blocks[1:]] + [None]):
                a = self.block(meta, a, pt)
        return self.classifier(self.avgpool(a))
