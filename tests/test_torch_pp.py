"""The port's pipeline-parallel engine (engine/pp_engine.py) on gloo ranks
on the CPU, held against the JAX package's PPEngine on the virtual 8-device
mesh and against the port's single engine: ResNet-18 and MobileNetV2 at
32 px, full width, 16 classes, batch 8, in the three rungs, at 2 stages (4
microbatches) and 4 stages (8 microbatches), and ResNet-18 on a (data 2,
pipe 2) mesh.  Each rank holds its stage's layers alone; each boundary
crosses in its own dtype, the shapes and dtypes of the JAX engine's wire
trace (packed 1 B/elt, bf16 2, int32 4)."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from _torch_mp import (
    BATCH, BF16_OPTIONS, JAX_RUNG_KW, JAX_THREADS, RUNGS, jax_side, port_bake, port_logits, row_slice,
    start_ranks,
)
from _torch_tp_worker import model_of

from f8net_tpu.engine.pp_engine import PPEngine as JaxPPEngine
from f8net_tpu.engine.pp_engine import make_pipe_mesh as jax_make_pipe_mesh
from f8net_tpu_torch.engine import build_units, stage_bounds

FAMILIES = ("resnet18", "mobilenet_v2")
# (family, rung, stages, microbatches, data rows)
CASES = ([(f, r, s, 2 * s, 1) for f in FAMILIES for r in RUNGS for s in (2, 4)]
         + [("resnet18", "strict", 2, 4, 2)])
ITEMSIZE = {torch.int8: 1, torch.bfloat16: 2, torch.int32: 4}


def case_name(family, rung, stages, micro, data):
    return f"pp-{family}-{rung}-{data}x{stages}-m{micro}"


def jax_pp(family, bake, xi, rung, stages, micro, data):
    """The JAX PPEngine's logits and its wire trace [(shape, dtype name)]."""
    model, plan, ip = jax_side(family, *bake[:2])
    if data == 1:
        mesh, daxis = jax_make_pipe_mesh(stages), None
    else:
        devs = np.asarray(jax.devices()[:data * stages]).reshape(data, stages)
        mesh, daxis = JaxMesh(devs, ("data", "pipe")), "data"
    pp = JaxPPEngine(model, plan, ip, mesh, microbatches=micro, data_axis=daxis,
                     f32_requant=False, **JAX_RUNG_KW[rung])
    x = np.asarray(xi.numpy())
    mb = x.shape[0] // micro
    prog = pp._program(mb // pp.D, x.shape[1:], x.dtype)
    stream = x.reshape((micro, mb) + x.shape[1:])
    out = prog.lower(stream, pp._pstack).compile(
        compiler_options=BF16_OPTIONS if rung == "bf16" else None)(stream, pp._pstack)
    metas, _ = pp._trace_boundaries(mb // pp.D, x.shape[1:], x.dtype)
    wire = [(tuple(m[0]), np.dtype(m[1]).name) for m in metas[1:]]
    return np.asarray(out).reshape(x.shape[0], -1), wire


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's results, {case: (JAX logits, JAX wire trace)}, {(family,
    rung): (conditioned input, the port's single-engine logits)})."""
    bakes = {f: port_bake(f) for f in FAMILIES}
    cases = [dict(name=case_name(*c), kind="pp", family=c[0], rung=c[1], mesh=(c[4], c[2]),
                  microbatches=c[3]) for c in CASES]
    wait = start_ranks(tmp_path_factory.mktemp("pp"), dict(
        bakes={f: b[:2] for f, b in bakes.items()}, images={f: b[2] for f, b in bakes.items()},
        cases=cases))
    single = {(f, r): port_logits(f, *bakes[f], r) for f, r in {c[:2] for c in CASES}}
    with ThreadPoolExecutor(JAX_THREADS) as pool:  # XLA compiles outside the GIL
        refs = dict(zip(map(lambda c: case_name(*c), CASES), pool.map(
            lambda c: jax_pp(c[0], bakes[c[0]], single[c[:2]][0], c[1], *c[2:]), CASES)))
    return wait(), refs, single


@pytest.mark.parametrize("case", CASES, ids=[case_name(*c) for c in CASES])
def test_pp_engine_equals_jax_and_single_engine(run, case):
    """Every rank's logits (the last stage's, broadcast over the pipe)
    bitwise the JAX PPEngine's and the port's single engine's."""
    ranks, refs, single = run
    family, rung, stages, micro, data = case
    name = case_name(*case)
    want_jax, want = refs[name][0], single[(family, rung)][1]
    np.testing.assert_array_equal(want.numpy(), want_jax)
    assert len({tuple(row) for row in want.tolist()}) == BATCH, "images share logits"
    for r in range(data * stages):
        got = ranks[r][name]["logits"]
        assert torch.equal(got, row_slice(want, (data, stages), r)), (name, r)
        np.testing.assert_array_equal(got.numpy(), row_slice(want_jax, (data, stages), r))


@pytest.mark.parametrize("case", CASES, ids=[case_name(*c) for c in CASES])
def test_stage_local_weights_and_wire(run, case):
    """A rank holds its stage's layers alone, the stages' layers partition
    the graph; each boundary crosses once per microbatch in the dtype and
    shape of the JAX engine's wire trace, the bytes 1, 2 or 4 per element;
    the pipe's only other collective is the logits' one broadcast."""
    ranks, refs, _ = run
    family, rung, stages, micro, data = case
    name = case_name(*case)
    model = model_of(family)
    units, layer_sets = build_units(model)
    bounds = stage_bounds(len(units), stages)
    wire = refs[name][1]
    assert len(wire) == stages - 1
    for row in range(data):
        seen = []
        for s in range(stages):
            res = ranks[row * stages + s][name]
            a, b = bounds[s]
            assert res["stage"] == s
            assert res["held"] == res["layers"] == sorted(set().union(*layer_sets[a:b]))
            seen += res["held"]
            counts = res["counts"]
            assert counts["broadcast"] == 1 and "all_reduce" not in counts
            if s == stages - 1:
                assert res["sent"] == [] and "send" not in counts
                continue
            shape, dtype = wire[s]
            assert len(res["sent"]) == micro, res["sent"]
            for dt, shp in res["sent"]:
                assert (shp, str(dt).split(".")[-1]) == (shape, dtype), (s, shp, dt, wire[s])
            assert res["wire_bytes"] == micro * int(np.prod(shape)) * ITEMSIZE[res["sent"][0][0]]
            assert counts["send"] == micro + 1  # one header per forward
        assert sorted(seen) == sorted(model.graph.names())
    dtypes = {dtype for _, dtype in wire}
    if family == "resnet18":  # cuts on block outputs: int32, packed int8, bf16 by rung
        assert dtypes == {"strict": {"int32"}, "int8": {"int8"}, "bf16": {"bfloat16"}}[rung]
