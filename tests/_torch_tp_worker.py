"""One rank of the port's multi-process engine tests (gloo on the CPU):
tests/test_torch_tp.py, tests/test_torch_tp_overlap.py and
tests/test_torch_pp.py.

    python tests/_torch_tp_worker.py <port> <rank> <world> <dir>

Reads <dir>/cases.pt, written by the test: the cases -- each a kind ("tp",
"pp", "paired", "ring", "wrap"), a mesh shape and its arguments -- and
what they read: baked models ({family: (plan records, {layer: {"w", "b"}}
numpy)}) and images, tp_overlap operands, int32 partials.  Joins the group through
`parallel.init_dist`, builds every case's mesh in the listed order (every
rank builds every mesh), runs each case it is a rank of, and writes what it
computed to <dir>/rank<r>.pt.  Imports no JAX.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from f8net_tpu_torch.engine import IntEngine, PPEngine, TPEngine, make_pipe_mesh  # noqa: E402
from f8net_tpu_torch.models import get_model  # noqa: E402
from f8net_tpu_torch.parallel import init_dist, make_mesh  # noqa: E402
from f8net_tpu_torch.parallel.mesh import shard_batch  # noqa: E402
from f8net_tpu_torch.parallel.tp_overlap import (  # noqa: E402
    tp_paired_matmul_int8, tp_ring_matmul_int8,
)
from f8net_tpu_torch.quant import LayerPlan, QuantPlan  # noqa: E402
from f8net_tpu_torch.utils import QuantConfig  # noqa: E402

CFG = dict(format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
           pool_fusing=True)
CLASSES, SIZE = 16, 32
RUNG_KW = {"strict": {}, "int8": {"int8_boundary": True}, "bf16": {"bf16_boundary": True}}


def model_of(family, normalize=False):
    return get_model(family, QuantConfig(normalize=normalize, **CFG), num_classes=CLASSES,
                     image_size=SIZE)


def plan_of(records):
    return QuantPlan(tuple(LayerPlan(*r) for r in records))


def run_case(case, mesh, data, rank):
    kind = case["kind"]
    if kind == "wrap":
        t = torch.tensor(data["wrap"][rank], dtype=torch.int32)
        return mesh.all_reduce(t, mesh.axes[1])
    if kind in ("paired", "ring"):
        p, i = mesh.size("model"), mesh.index("model")
        op = {k: torch.from_numpy(v) for k, v in data["ops"][case["ops"]].items()}
        mesh.reset_counts()
        if kind == "paired":
            n = op["w1"].shape[1] // p
            y = tp_paired_matmul_int8(
                mesh, op["x"], op["w1"][:, i * n:(i + 1) * n].contiguous(),
                op["b1"][i * n:(i + 1) * n].contiguous(), op["w2"][i * n:(i + 1) * n].contiguous(),
                op["b2"], **case["kw"])
        else:
            kb, n = op["w"].shape[0] // p, op["w"].shape[1] // p
            y = tp_ring_matmul_int8(
                mesh, op["x"][:, i * kb:(i + 1) * kb].contiguous(),
                op["w"][:, i * n:(i + 1) * n].contiguous(), op["b"][i * n:(i + 1) * n].contiguous(),
                **case["kw"])
        return dict(y=y, counts=dict(mesh.counts))
    family = case["family"]
    records, arrays = data["bakes"][family]
    model, plan = model_of(family), plan_of(records)
    x = torch.from_numpy(data["images"][family])
    xi = IntEngine(model, plan, {k: {kk: torch.from_numpy(v) for kk, v in d.items()}
                                 for k, d in arrays.items()}, device="cpu").condition_input(x)
    xs = shard_batch(mesh, xi)
    rung = RUNG_KW[case["rung"]]
    if kind == "tp":
        eng = TPEngine(model, plan, arrays, mesh, device="cpu", **rung)
        mesh.reset_counts()
        logits = eng(xs)
        return dict(logits=logits, counts=dict(mesh.counts), launches=eng.launch_table(),
                    local={n: tuple(p["w"].shape) for n, p in eng.params.items()})
    eng = PPEngine(model, plan, arrays, mesh, case["microbatches"], device="cpu",
                   data_axis="data" if mesh.size("data") > 1 else None, **rung)
    mesh.reset_counts()
    logits = eng(xs)
    return dict(logits=logits, counts=dict(mesh.counts), sent=eng.sent, layers=eng.layers,
                held=sorted(eng.engine.params), stage=eng.s, wire_bytes=eng.wire_bytes)


def main():
    port, rank, world, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    init_dist(f"tcp://127.0.0.1:{port}", rank, world, backend="gloo")
    data = torch.load(os.path.join(out, "cases.pt"), weights_only=False)
    meshes, results = {}, {}
    for case in data["cases"]:
        key = (case["kind"] == "pp", tuple(case["mesh"]))
        if key not in meshes:
            d, m = case["mesh"]
            meshes[key] = (make_pipe_mesh(m, d, device="cpu") if key[0]
                           else make_mesh(d, m, device="cpu"))
        mesh = meshes[key]
        if mesh.member:
            results[case["name"]] = run_case(case, mesh, data, rank)
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: ok")


if __name__ == "__main__":
    main()
