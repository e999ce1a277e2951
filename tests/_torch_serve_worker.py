"""One rank of tests/test_torch_serving_mesh.py (gloo on the CPU).

    python tests/_torch_serve_worker.py <port> <rank> <world> <dir>

Reads <dir>/cases.pt, written by the test: ResNet-18's bake (plan records,
{layer: {"w", "b"}} numpy) at 32 px and 10 classes, a pool of uint8 images
and the cases -- each a kind ("serve": ServingEngine(mesh=); "xhost":
CrossHostServingEngine; "boom": an engine error on a follower), a mesh
shape, a rung and the requests, as row ranges of the pool.  Joins the group
through `parallel.init_dist`, builds every case's mesh in the listed order,
runs each case on every rank and writes what each rank saw to
<dir>/rank<r>.pt.  Then the crash case: on a (4, 1) mesh rank 3 exits in
the middle of a round; each surviving rank writes how its server ended to
<dir>/crash<r>.pt and exits without tearing the group down.  Imports no JAX.
"""

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from f8net_tpu_torch.engine import (  # noqa: E402
    CrossHostServingEngine, IntEngine, ServingEngine, TPEngine,
)
from f8net_tpu_torch.engine.serve import MeshError  # noqa: E402
from f8net_tpu_torch.export import params_from_numpy  # noqa: E402
from f8net_tpu_torch.models import get_model  # noqa: E402
from f8net_tpu_torch.parallel import init_dist, make_mesh  # noqa: E402
from f8net_tpu_torch.utils import QuantConfig  # noqa: E402

CFG = dict(format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
           pool_fusing=True)
CLASSES, SIZE = 10, 32
RUNG_KW = {"strict": {}, "int8": {"int8_boundary": True}, "bf16": {"bf16_boundary": True}}
LONG_MS = 60_000.0  # a ServingEngine batch launches when its requests fill it
TIMEOUT = 120.0


def model_of():
    return get_model("resnet18", QuantConfig(**CFG), num_classes=CLASSES, image_size=SIZE)


class Boom:
    """An engine that raises on its first call, then is `engine`."""

    def __init__(self, engine):
        self.engine, self.device, self.armed = engine, engine.device, True

    def __call__(self, x):
        if self.armed:
            self.armed = False
            raise ValueError("boom in the engine")
        return self.engine(x)


class Crash(Boom):
    """An engine whose process exits on its first call."""

    def __call__(self, x):
        os._exit(3)


def build_engine(case, mesh, data):
    model = model_of()
    rung = RUNG_KW[case["rung"]]
    if case.get("tp"):
        return TPEngine(model, data["plan"], data["arrays"], mesh, device="cpu", **rung)
    return IntEngine(model, data["plan"], data["params"], device="cpu", **rung)


def serve(case, mesh, eng, pool):
    """ServingEngine on the mesh; the front end submits every request, the
    others wait for the stop round.  Returns the front end's results and
    stats and every rank's collective counts."""
    srv = ServingEngine(eng, mesh=mesh, buckets=case["buckets"], max_wait_ms=LONG_MS,
                        ring_capacity=4 * max(case["buckets"]), image_shape=pool.shape[1:],
                        image_dtype=np.uint8)
    mesh.reset_counts()
    srv.start()
    if not srv.front:
        srv.stop()
        return dict(counts=dict(mesh.counts))
    futs = [srv.submit(pool[a:b]) for a, b in case["requests"]]
    out = []
    for f in futs:
        try:
            out.append(f.result(TIMEOUT))
        except Exception as e:  # the boom case's first batch
            out.append(f"{type(e).__name__}: {e}")
    srv.stop()
    return dict(served=out, stats=srv.stats, counts=dict(mesh.counts),
                alive=srv._thread.is_alive())


def xhost(case, mesh, eng, pool):
    """CrossHostServingEngine on the mesh: each leader submits its own
    requests in three waves -- one image, one request of the per-host shard,
    then several requests at once -- waiting for each wave's answers."""
    srv = CrossHostServingEngine(eng, mesh, buckets=case["buckets"], tick_ms=case["tick_ms"],
                                 image_shape=pool.shape[1:], image_dtype=np.uint8)
    mesh.reset_counts()
    srv.start()
    if not srv.leader:
        srv.stop()
        return dict(counts=dict(mesh.counts))
    served = []
    for wave in case["waves"][mesh.index("data")]:
        futs = [(a, b, srv.submit(pool[a:b])) for a, b in wave]
        served += [(a, b, f.result(TIMEOUT)) for a, b, f in futs]
    srv.stop()
    return dict(served=served, stats=srv.stats, counts=dict(mesh.counts),
                alive=srv._thread.is_alive())


def crash(out, rank, data):
    """Rank 3 of a (4, 1) mesh exits in its engine; each other rank writes
    how its server ended."""
    mesh = make_mesh(4, 1, device="cpu")
    eng = IntEngine(model_of(), data["plan"], data["params"], device="cpu")
    srv = ServingEngine(Crash(eng) if rank == 3 else eng, mesh=mesh, buckets=(8,),
                        max_wait_ms=LONG_MS).start()
    pool = data["pool"]
    res = {}
    if srv.front:
        first = srv.submit(pool[:8])
        try:
            first.result(TIMEOUT)
            res["first"] = "served"
        except Exception as e:
            res["first"] = f"{type(e).__name__}: {e}"
        second = srv.submit(pool[:1])  # after the fault: fails at once
        res["second"] = f"{type(second.exception(5.0)).__name__}" if second.done() else "pending"
    try:
        srv.stop()
        res["stop"] = "returned"
    except RuntimeError as e:  # gloo's error on the closed socket, or a MeshError
        res["stop"] = "MeshError" if isinstance(e, MeshError) else "RuntimeError"
    res["alive"] = srv._thread.is_alive()
    torch.save(res, os.path.join(out, f"crash{rank}.pt"))


def main():
    port, rank, world, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    init_dist(f"tcp://127.0.0.1:{port}", rank, world, backend="gloo")
    data = torch.load(os.path.join(out, "cases.pt"), weights_only=False)
    data["plan"], data["params"] = params_from_numpy(data["records"], data["arrays"], "cpu")
    meshes, results = {}, {}
    for case in data["cases"]:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device="cpu")
        mesh = meshes[shape]
        eng = build_engine(case, mesh, data)
        if case["kind"] == "boom" and rank == case["boom_rank"]:
            eng = Boom(eng)
        run = xhost if case["kind"] == "xhost" else serve
        t0 = time.perf_counter()
        results[case["name"]] = run(case, mesh, eng, data["pool"])
        print(f"rank {rank}: {case['name']} {time.perf_counter() - t0:.2f} s", flush=True)
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    print(f"rank {rank}: cases done", flush=True)
    crash(out, rank, data)
    print(f"rank {rank}: crash case done", flush=True)
    sys.stdout.flush()
    os._exit(0)  # the group has a dead rank: no teardown


if __name__ == "__main__":
    main()
