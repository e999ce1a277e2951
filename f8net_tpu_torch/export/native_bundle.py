"""Flat binary bundle for the native (C++) inference runtime, `csrc/infer_main`
(the port of `f8net_tpu/export/native_bundle.py:31-124`).

A dependency-free format the runtime reads with plain fread: header,
topology (family, blocks, conv indices), then per-layer records with raw
int8/int32 tensors.  All integers little-endian int32.  For one model and
plan the port writes the same bytes as the JAX package.

Layout:
  magic 'F8NB' | version | family(0=resnet,1=mbv1,2=mbv2) | num_classes
  | quant_avgpool | n_layers | n_blocks
  per block: n_body | body layer indices... | shortcut idx or -1 | residual
  per layer: kind(0=conv,1=linear) | input_fl | weight_fl | symmetric
    conv:  kh kw cin cout stride pad groups | w int8[kh*kw*(cin/groups)*cout]
           (HWIO order) | b int32[cout]
    linear: in out has_bias | w int8[in*out] ((in,out) order) | b int32[out]?
"""

from __future__ import annotations

import struct

import numpy as np

from ..nn.spec import ConvBNSpec

MAGIC = b"F8NB"
VERSION = 1
FAMILY = {"resnet": 0, "mobilenet_v1": 1, "mobilenet_v2": 2}


def _raw(t, dtype) -> bytes:
    """A tensor's bytes in `dtype`, from wherever it lives (the card too)."""
    return np.ascontiguousarray(t.detach().cpu().numpy(), dtype).tobytes()


def save_native_bundle(path: str, model, plan, int_params) -> str:
    """Write `model` (the port's), its QuantPlan and int params (torch
    tensors on any device; HWIO conv and (in, out) linear weights) as an
    F8NB bundle; returns the path."""
    fam = FAMILY["resnet"] if model.name.startswith("resnet") else FAMILY[model.name]
    index = {p.name: i for i, p in enumerate(plan.layers)}

    out = bytearray(MAGIC)
    out += struct.pack("<iiiiii", VERSION, fam, model.num_classes,
                       int(model.cfg.quant_avgpool), len(index), len(model.blocks))
    for meta in model.blocks:
        shortcut = getattr(meta, "shortcut", None)
        residual = getattr(meta, "residual", shortcut is None)
        out += struct.pack(f"<i{len(meta.body)}i", len(meta.body), *(index[n] for n in meta.body))
        out += struct.pack("<ii", index[shortcut] if shortcut else -1, int(residual))

    for p in plan.layers:
        spec = model.graph[p.name]
        entry = int_params[p.name]
        head = struct.pack("<iii", p.input_fl, p.weight_fl, int(p.input_symmetric))
        if isinstance(spec, ConvBNSpec):
            kh, kw = spec.kernel
            out += struct.pack("<i", 0) + head
            out += struct.pack("<iiiiiii", kh, kw, spec.in_ch, spec.out_ch,
                               spec.stride[0], spec.padding[0], spec.groups)
            out += _raw(entry["w"], np.int8) + _raw(entry["b"], np.int32)
        else:
            has_b = "b" in entry
            out += struct.pack("<i", 1) + head
            out += struct.pack("<iii", spec.in_features, spec.out_features, int(has_b))
            out += _raw(entry["w"], np.int8)
            if has_b:
                out += _raw(entry["b"], np.int32)

    with open(path, "wb") as f:
        f.write(bytes(out))
    return path


def load_native_bundle(path: str) -> dict:
    """Parse an F8NB bundle back into Python (inspection and round-trip
    checks without the C++ runtime).  Returns {family, num_classes,
    quant_avgpool, blocks: [{body, shortcut, residual}], layers: [conv or
    linear dicts with numpy w and b]}.  Raises ValueError on a wrong magic,
    an unknown version or trailing bytes."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != MAGIC:
        raise ValueError("not an F8NB bundle")
    off = 4

    def ints(n):
        nonlocal off
        vals = struct.unpack_from(f"<{n}i", raw, off)
        off += 4 * n
        return vals

    def array(dtype, n, shape):
        nonlocal off
        a = np.frombuffer(raw, dtype, n, off).reshape(shape)
        off += a.nbytes
        return a

    version, family, num_classes, quant_avgpool, n_layers, n_blocks = ints(6)
    if version != VERSION:
        raise ValueError(f"unsupported F8NB version {version}")
    blocks = []
    for _ in range(n_blocks):
        (n_body,) = ints(1)
        body = list(ints(n_body))
        shortcut, residual = ints(2)
        blocks.append({"body": body, "shortcut": shortcut if shortcut >= 0 else None,
                       "residual": bool(residual)})
    layers = []
    for _ in range(n_layers):
        kind, input_fl, weight_fl, symmetric = ints(4)
        rec = {"input_fl": input_fl, "weight_fl": weight_fl, "symmetric": bool(symmetric)}
        if kind == 0:
            kh, kw, cin, cout, stride, pad, groups = ints(7)
            shape = (kh, kw, cin // groups, cout)
            w = array(np.int8, int(np.prod(shape)), shape)
            rec.update(kind="conv", kernel=(kh, kw), in_ch=cin, out_ch=cout, stride=stride,
                       padding=pad, groups=groups, w=w, b=array(np.int32, cout, (cout,)))
        else:
            fin, fout, has_b = ints(3)
            w = array(np.int8, fin * fout, (fin, fout))
            b = array(np.int32, fout, (fout,)) if has_b else None
            rec.update(kind="linear", in_features=fin, out_features=fout, w=w, b=b)
        layers.append(rec)
    if off != len(raw):
        raise ValueError(f"trailing bytes in bundle ({len(raw) - off})")
    return {"family": family, "num_classes": num_classes,
            "quant_avgpool": bool(quant_avgpool), "blocks": blocks, "layers": layers}
