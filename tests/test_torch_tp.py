"""The port's tensor-parallel engine (engine/tp_engine.py) on four gloo
ranks on the CPU, held against the JAX package's `int_forward_tp` on the
virtual 8-device mesh and against the port's single engine.

tests/_torch_tp_worker.py runs every case on each rank of its mesh -- a
(data, model) grid of (1, 2), (2, 2) or (1, 4) -- and saves each rank's
logits, its mesh's collective counts and its kernel table; the tests here
compare them.  The models are the port's Model.init baked by the port
(32 px, full width, 16 classes, batch 8; tests/_torch_mp.py) and carried
to JAX as arrays.
All rungs are bitwise: the bf16 rung's one stated tolerance
(tests/_rung_reference.py) is for pools of more than one term, and a 32 px
pool has one.

Without processes: the zero-point shares of a row layer's biases, and every
per-rank kernel call at 224 px, tp = 2 and 4, for the four families, held
to the kernels' own checks (ops.*_check on meta tensors: shapes, dtypes,
domains, plans, contiguity; alignment is vacuous there) and to the rank's
launch table.
"""


from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from _torch_mp import (
    BATCH, JAX_RUNG_KW, JAX_THREADS, RUNGS, compiled, jax_side, port_bake, port_logits, row_slice,
    start_ranks,
)
from _torch_tp_worker import CFG, model_of

from f8net_tpu.engine.tp_engine import int_forward_tp as jax_int_forward_tp
from f8net_tpu.parallel import batch_sharding, make_mesh as jax_make_mesh
from f8net_tpu_torch.engine import TPEngine, tp_local_params, tp_modes
from f8net_tpu_torch.engine.int_engine import add_zero_point_bias
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.nn.spec import LinearSpec
from f8net_tpu_torch.ops import conv, dw, gemm, gemm_v2, ir_block, stem
from f8net_tpu_torch.ops.fxp import INT32_MAX, wrap_i32
from f8net_tpu_torch.quant import LayerPlan, QuantPlan
from f8net_tpu_torch.utils import QuantConfig

MESHES = ((1, 2), (2, 2), (1, 4))
FAMILIES = ("resnet18", "mobilenet_v2", "resnet50", "mobilenet_v1")
CASES = ([(f, r, m) for f in ("resnet18", "mobilenet_v2") for r in RUNGS for m in MESHES]
         + [("resnet50", "strict", (1, 4)), ("mobilenet_v1", "strict", (1, 4))])
# int32 partials across INT32_MAX, one row per rank of the (1, 4) mesh
WRAP = [[INT32_MAX, -INT32_MAX - 1, 5, 1 << 30], [1, -1, 7, 1 << 30],
        [INT32_MAX, INT32_MAX, -3, 1 << 30], [2, -INT32_MAX - 1, 0, 1 << 30]]


def case_name(family, rung, mesh):
    return f"tp-{family}-{rung}-{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's results, {family: (records, arrays, images)}, {case:
    the JAX int_forward_tp logits}, {(family, rung): (conditioned input,
    the port's single-engine logits)}): the ranks run while the JAX
    references compile."""
    bakes = {f: port_bake(f) for f in FAMILIES}
    cases = [dict(name=case_name(*c), kind="tp", family=c[0], rung=c[1], mesh=c[2]) for c in CASES]
    cases.append(dict(name="wrap", kind="wrap", mesh=(1, 4)))
    wait = start_ranks(tmp_path_factory.mktemp("tp"), dict(
        bakes={f: b[:2] for f, b in bakes.items()}, images={f: b[2] for f, b in bakes.items()},
        cases=cases, wrap=WRAP))
    single = {(f, r): port_logits(f, *bakes[f], r) for f, r in {c[:2] for c in CASES}}

    def reference(case):
        family, rung, (d, m) = case
        model, plan, ip = jax_side(family, *bakes[family][:2])
        mesh = jax_make_mesh(data=d, model=m, devices=jax.devices()[:d * m])
        xd = jax.device_put(single[(family, rung)][0].numpy(), batch_sharding(mesh))
        return compiled(
            lambda v, p: jax_int_forward_tp(model, plan, p, v, mesh, model.cfg, f32_requant=False,
                                            **JAX_RUNG_KW[rung]), rung, xd, ip)

    with ThreadPoolExecutor(JAX_THREADS) as pool:  # XLA compiles outside the GIL
        refs = dict(zip(map(lambda c: case_name(*c), CASES), pool.map(reference, CASES)))
    return wait(), bakes, refs, single


@pytest.mark.parametrize("family,rung,mesh", CASES, ids=[case_name(*c) for c in CASES])
def test_tp_engine_equals_jax_and_single_engine(run, family, rung, mesh):
    """Every rank's logits, bitwise: the JAX int_forward_tp's on the same
    mesh shape and the port's single engine's, on its data row's images."""
    ranks, _, refs, single = run
    name = case_name(family, rung, mesh)
    want_jax, want_single = refs[name], single[(family, rung)][1]
    np.testing.assert_array_equal(want_single.numpy(), want_jax)
    for r in range(mesh[0] * mesh[1]):
        got = ranks[r][name]["logits"]
        assert got.shape == (BATCH // mesh[0], 16) and got.dtype == torch.float32
        assert torch.equal(got, row_slice(want_single, mesh, r)), (name, r)
        np.testing.assert_array_equal(got.numpy(), row_slice(want_jax, mesh, r))
    assert len({tuple(row) for row in want_single.tolist()}) == BATCH, "images share logits"


def test_all_reduces_per_forward_equal_row_layers(run):
    """One all-reduce per row layer and no other collective, every rank of
    every case (ResNet-18: 8 + 3 + 1 = 12); an axis of one rank issues
    none."""
    ranks = run[0]
    for family, rung, mesh in CASES:
        rows = sum(mode == "row" for mode in tp_modes(model_of(family)).values())
        if family == "resnet18":
            assert rows == 12
        for r in range(mesh[0] * mesh[1]):
            counts = ranks[r][case_name(family, rung, mesh)]["counts"]
            assert set(counts) == {"all_reduce", "all_reduce_bytes"}, counts
            assert counts["all_reduce"] == rows, (family, rung, mesh, r, counts)


def test_int32_all_reduce_wraps(run):
    """An all-reduce of int32 partials across INT32_MAX over four ranks
    equals the single engine's wrapped add of the same partials."""
    want = wrap_i32(torch.tensor(WRAP, dtype=torch.int64).sum(0))
    for r in range(4):
        assert torch.equal(run[0][r]["wrap"], want)
    assert want.tolist() == [1, INT32_MAX - 1, 9, 0]  # the first two wrap


def test_local_params_are_the_ranks_share(run):
    """Each rank's engine holds its share: col and shard layers O/tp (or C/tp)
    channels, row layers K/tp rows, rep layers whole -- padded to a multiple
    of 16 outside K5 blocks."""
    ranks = run[0]
    for family, rung, mesh in CASES:
        model = model_of(family)
        modes, tp = tp_modes(model), mesh[1]
        for r in range(mesh[0] * mesh[1]):
            local = ranks[r][case_name(family, rung, mesh)]["local"]
            for name, shape in local.items():
                whole = model.graph[name].weight_shape()
                axis = {"col": -1, "shard": -1, "row": 0 if len(whole) == 2 else 2}.get(modes[name])
                if axis is None:
                    assert shape == whole, name
                    continue
                cut = whole[axis] // tp
                assert shape[axis] in (cut, -(-cut // 16) * 16), (name, shape, whole)


@pytest.mark.parametrize("family", FAMILIES)
def test_zero_point_shares_sum_to_the_bias(run, family):
    """A row layer's per-rank biases (the IntEngine's b_zp of the rank's
    rows, b on rank 0 alone) sum, wrapping, to the single engine's b_zp;
    b is counted once; a col or shard layer's is its slice of b_zp, zero
    in padded channels."""
    records, arrays, _ = run[1][family]
    model = model_of(family)
    plan = QuantPlan(tuple(LayerPlan(*r) for r in records))
    whole = add_zero_point_bias(model.graph, plan, {k: {kk: torch.from_numpy(v) for kk, v in d.items()}
                                                    for k, d in arrays.items()})
    modes = tp_modes(model)
    for tp in (2, 4):
        shares = []
        for rank in range(tp):
            graph, local = tp_local_params(model, arrays, tp, rank, modes)
            shares.append(add_zero_point_bias(graph, plan, local))
        for name, mode in modes.items():
            key = "b" if plan[name].input_symmetric else "b_zp"
            if mode == "row":
                total = wrap_i32(sum(s[name][key].to(torch.int64) for s in shares))
                assert torch.equal(total, whole[name][key]), (family, tp, name)
                assert all(not s[name]["b"].any() for s in shares[1:]), (family, tp, name)
                assert torch.equal(shares[0][name]["b"], whole[name]["b"])
            elif mode in ("col", "shard"):
                n = whole[name][key].shape[0] // tp
                for rank, s in enumerate(shares):
                    got = s[name][key]
                    assert torch.equal(got[:n], whole[name][key][rank * n:(rank + 1) * n])
                    assert not got[n:].any(), (family, tp, name)


# -- every per-rank kernel call at 224 px, inside its kernel's domain ------------


class ShapeMesh:
    """One rank's view of a model axis of `tp` ranks whose all-reduce gives
    its input back: the walk of its shapes alone."""

    def __init__(self, tp, rank):
        self.axes, self.member, self.counts = ("data", "model"), True, {}
        self.shape, self.coords = {"data": 1, "model": tp}, {"data": 0, "model": rank}

    def size(self, axis):
        return self.shape[axis]

    def index(self, axis):
        return self.coords[axis]

    def all_reduce(self, t, axis):
        self.counts["all_reduce"] = self.counts.get("all_reduce", 0) + 1
        return t


def _conv_out(x, w, stride, padding):
    kh = w.kh if isinstance(w, conv.PackedConvWeight) else w.shape[0]
    n, h, wd, _ = x.shape
    return n, (h + 2 * padding - kh) // stride + 1, (wd + 2 * padding - kh) // stride + 1


def _checked(calls):
    """The engine's kernel functions, each replaced by its kernel's checks
    (ops.*_check, on an H100's 132 SMs) and an empty output of the kernel's
    shape and dtype; every call appended to `calls`."""
    out_dtype = lambda kw: torch.int32 if kw.get("epilogue", "int32") == "int32" else torch.int8

    def gemm1(x, w, b, **kw):
        calls.append("int8_gemm")
        gemm.int8_gemm_check(x, w, b, **kw)
        return torch.empty((x.shape[0], w.n), dtype=out_dtype(kw), device=x.device)

    def gemm2(x, w, b, **kw):
        calls.append("int8_gemm_v2")
        gemm_v2.int8_gemm_v2_check(x, w, b, **kw)
        return torch.empty((x.shape[0], w.o), dtype=out_dtype(kw), device=x.device)

    def convk(x, w, b, **kw):
        calls.append("conv_int8")
        wp, _ = conv.conv_int8_check(x, w, b, **kw)
        shape = _conv_out(x, wp, kw.get("stride", 1), kw.get("padding", 0)) + (wp.o,)
        return torch.empty(shape, dtype=out_dtype(kw), device=x.device)

    def dwk(x, w, b, **kw):
        calls.append("dw_int8")
        dw.dw_int8_check(x, w, b, **kw)
        shape = _conv_out(x, w, kw.get("stride", 1), kw.get("padding", 0)) + (x.shape[3],)
        return torch.empty(shape, dtype=out_dtype(kw), device=x.device)

    def stemk(x, w, b, **kw):
        calls.append("stem_pool")
        stem.stem_pool_check(x, w, b, **kw)
        _, _, ph, pw = stem.stem_out_hw(x.shape[1], x.shape[2])
        return torch.empty((x.shape[0], ph, pw, 64), dtype=torch.int32, device=x.device)

    def irk(x, *args, **kw):
        calls.append("ir_block")
        ir_block.fused_ir_block_check(x, *args, **kw)
        return torch.empty(x.shape[:3] + (args[5].shape[0],),
                           dtype=ir_block.OUTPUTS[kw.get("out", "int32")], device=x.device)

    return dict(_gemm=gemm1, _gemm2=gemm2, _convk=convk, _dwk=dwk, _stemk=stemk, _irk=irk)


def _shape_params(model):
    """Int params and a plan of the model's shapes: values play no part in a
    walk of shapes."""
    arrays, records = {}, []
    for name in model.graph.names():
        spec = model.graph[name]
        shape = spec.weight_shape()
        arrays[name] = {"w": np.zeros(shape, np.int8), "b": np.zeros(shape[-1], np.int32)}
        signed = bool(spec.double_side)
        records.append(LayerPlan(name, 8 if name == "head" else 4, 7, signed))
    return arrays, QuantPlan(tuple(records))


@pytest.mark.parametrize("family", FAMILIES)
def test_every_shard_call_at_224_px_lies_in_its_kernels_domain(family):
    """Every kernel call of every rank at 224 px, batch 8, tp = 2 and 4, in
    every rung, passes its kernel's own checks at the rank's shard shapes;
    the calls per kernel are the rank's launch table (its routing at those
    shapes); one all-reduce per row layer."""
    model = get_model(family, QuantConfig(**CFG), num_classes=1000, image_size=224)
    arrays, plan = _shape_params(model)
    rows = sum(mode == "row" for mode in tp_modes(model).values())
    images = torch.zeros((BATCH, 224, 224, 3), device="meta")
    for tp in (2, 4):
        for rank in range(tp):
            for rung in RUNGS:
                mesh = ShapeMesh(tp, rank)
                eng = TPEngine(model, plan, arrays, mesh, device="meta",
                               **{"int8": dict(int8_boundary=True),
                                  "bf16": dict(bf16_boundary=True)}.get(rung, {}))
                calls = []
                for attr, fn in _checked(calls).items():
                    setattr(eng, attr, fn)
                logits = eng(eng.condition_input(images))
                assert logits.shape == (BATCH, 1000), (family, tp, rank, rung)
                table = {k: calls.count(k) for k in set(calls)}
                assert table == eng.launch_table(), (family, tp, rank, rung, table)
                assert mesh.counts["all_reduce"] == rows


def test_modes_cover_every_layer():
    for family in FAMILIES:
        model = model_of(family)
        modes = tp_modes(model)
        assert set(modes) == set(model.graph.names()), family
        assert set(modes.values()) <= {"col", "row", "shard", "rep"}
        assert modes["classifier"] == "row" and isinstance(model.graph["classifier"], LinearSpec)
