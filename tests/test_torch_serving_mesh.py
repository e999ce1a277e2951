"""The port's servers across ranks (f8net_tpu_torch.engine.serve:
`ServingEngine(mesh=)` and `CrossHostServingEngine`) on four gloo ranks on
the CPU, held against the JAX package's engine and servers.

tests/_torch_serve_worker.py runs every case on each rank of its mesh --
ResNet-18 at 32 px, 10 classes, on the port's bake (Model.init, two
train-mode forwards, the BN calibration, bake_plan), served over (4, 1)
with an `IntEngine` replica per rank and over (2, 2) with a `TPEngine`
shard -- while the parent compiles the JAX `IntEngine(int_only=True)` on
the whole image pool in each rung.  Tolerance 0: every served row equals
the JAX engine's row for that image in the strict, int8 and bf16 rungs.
The front end's stats equal a single-card server's on the same traffic
(coalescing made deterministic by a max_wait_ms of a minute, as in
tests/test_torch_serving.py), and each rank's collectives per round are
the protocol's.  A follower's engine error reaches the front end's future;
a rank that dies ends every other rank's loop.

In process: `_pick_bucket` against the reference's over a grid, and the
port's CrossHostServingEngine on a 1x1 mesh against the JAX one at
process_count == 1 on the 8-device virtual mesh (echo engines, requests
queued before start(), the stop set by the engine after the last round).
"""

import os
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from _torch_mp import BF16_OPTIONS, JAX_RUNG_KW, JAX_THREADS, ROOT, _free_port
from _torch_serve_worker import CFG, CLASSES, SIZE, model_of

from f8net_tpu.engine import IntEngine as JaxIntEngine
from f8net_tpu.engine.serve import CrossHostServingEngine as JaxCrossHost
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.parallel import make_mesh as jax_make_mesh
from f8net_tpu.quant.plan import LayerPlan as JaxLayerPlan
from f8net_tpu.quant.plan import QuantPlan as JaxQuantPlan
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.engine import CrossHostServingEngine, ServingEngine
from f8net_tpu_torch.parallel import make_mesh
from f8net_tpu_torch.quant import bake_plan, reset_bn_for_calib

WORLD, POOL = 4, 64
RUNGS = ("strict", "int8", "bf16")
# ServingEngine traffic: with LONG_MS each collected set is the shortest run
# of requests reaching 8 images, a larger one split: [3, 5] [2, 2, 2, 2]
# [8] [1, 7] [10] -> 8 + 2 (bucket 4) [4, 4]; the [10] is a copy batch
SERVE_SIZES = [3, 5, 2, 2, 2, 2, 8, 1, 7, 10, 4, 4]
SERVE_BUCKETS, RING = (4, 8), 64
XHOST_BUCKETS, TICK_MS = (4, 8, 16), 20.0
SERVE_MESHES = ((4, 1), (2, 2))
XHOST_MESHES = ((2, 2), (4, 1))
TP_ROWS = 12  # ResNet-18's row layers: one all-reduce each per forward


def _ranges(sizes, start=0):
    edges = np.cumsum([start] + list(sizes))
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def xhost_waves(hosts):
    """Per host: one image, one request of the per-host shard, then three
    requests at once, from a region of the pool of its own."""
    per = max(XHOST_BUCKETS) // hosts
    out = []
    for h in range(hosts):
        o = h * (POOL // hosts)
        out.append([[(o, o + 1)], [(o + 1, o + 1 + per)], _ranges([1, 2, 3], o + 1 + per)])
    return out


def case_name(kind, mesh, rung):
    return f"{kind}-{mesh[0]}x{mesh[1]}-{rung}"


def _bake():
    """The port's bake of ResNet-18 at 32 px, 10 classes: (plan records,
    int params as numpy)."""
    model = model_of()
    params, state = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(1)
    x = torch.from_numpy((np.round(255 * rng.rand(8, SIZE, SIZE, 3)) / 256).astype(np.float32))
    for _ in range(2):
        _, state = model.apply(params, state, x, mode="train")
    state = reset_bn_for_calib(state)
    for _ in range(2):
        _, state = model.apply(params, state, x, mode="calib")
    plan, ip = bake_plan(model, params, state)
    records = [(p.name, p.input_fl, p.weight_fl, p.input_symmetric) for p in plan.layers]
    return records, {k: {kk: v.numpy() for kk, v in d.items()} for k, d in ip.items()}


class _Echo:
    """logits[i] = (sum of image i, max of image i)."""

    device = torch.device("cpu")

    def __call__(self, x):
        v = x.to(torch.float32)
        return torch.stack([v.sum((1, 2, 3)), v.amax((1, 2, 3))], 1)


def _single_card_stats(pool):
    """The port's single-card server (an echo engine) on the mesh cases'
    traffic: the stats the front end must count."""
    srv = ServingEngine(_Echo(), buckets=SERVE_BUCKETS, max_wait_ms=60_000.0,
                        ring_capacity=RING, image_shape=pool.shape[1:], image_dtype=np.uint8)
    srv.start()
    try:
        futs = [srv.submit(pool[a:b]) for a, b in _ranges(SERVE_SIZES)]
        [f.result(60) for f in futs]
    finally:
        srv.stop()
    return srv.stats


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's results, each surviving rank's crash record, {rung: JAX
    logits on the pool}, the single-card server's stats)."""
    records, arrays = _bake()
    pool = np.random.RandomState(2).randint(0, 256, (POOL, SIZE, SIZE, 3)).astype(np.uint8)
    cases = []
    for mesh in SERVE_MESHES:
        for rung in RUNGS:
            cases.append(dict(name=case_name("serve", mesh, rung), kind="serve", mesh=mesh,
                              rung=rung, tp=mesh[1] > 1, buckets=SERVE_BUCKETS,
                              requests=_ranges(SERVE_SIZES)))
    for mesh in XHOST_MESHES:
        for rung in RUNGS:
            cases.append(dict(name=case_name("xhost", mesh, rung), kind="xhost", mesh=mesh,
                              rung=rung, tp=mesh[1] > 1, buckets=XHOST_BUCKETS, tick_ms=TICK_MS,
                              waves=xhost_waves(mesh[0])))
    cases.append(dict(name="boom", kind="boom", mesh=(2, 2), rung="strict", boom_rank=3,
                      buckets=(8,), requests=[(0, 8), (8, 16)]))
    out = str(tmp_path_factory.mktemp("serve_mesh"))
    torch.save(dict(records=records, arrays=arrays, pool=pool, cases=cases),
               os.path.join(out, "cases.pt"))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "_torch_serve_worker.py"),
                               str(port), str(r), str(WORLD), out],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]

    jmodel = jax_get_model("resnet18", JaxQuantConfig(**CFG), CLASSES, SIZE)
    jplan = JaxQuantPlan(tuple(JaxLayerPlan(*r) for r in records))
    ip = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in arrays.items()}

    def reference(rung):
        eng = JaxIntEngine(jmodel, jplan, ip, int_only=True, **JAX_RUNG_KW[rung])
        xc = jnp.asarray(pool)
        fwd = eng._jit.lower(eng.int_params, xc).compile(
            compiler_options=BF16_OPTIONS if rung == "bf16" else None)
        return np.asarray(fwd(eng.int_params, xc))

    with ThreadPoolExecutor(JAX_THREADS) as ex:  # XLA compiles outside the GIL
        refs = dict(zip(RUNGS, ex.map(reference, RUNGS)))
    single = _single_card_stats(pool)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:  # exact-PID cleanup only
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0, 0, 0, 3], f"rank exit codes {codes}:\n" + "\n".join(
        f"rank {r}:\n{log[-3000:]}" for r, log in enumerate(logs))
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    crashed = [torch.load(os.path.join(out, f"crash{r}.pt"), weights_only=False)
               for r in range(WORLD - 1)]
    assert len({tuple(r) for r in refs["strict"].tolist()}) == POOL, "images share logits"
    return ranks, crashed, refs, single


@pytest.mark.parametrize("mesh,rung", [(m, r) for m in SERVE_MESHES for r in RUNGS],
                         ids=[case_name("serve", m, r) for m in SERVE_MESHES for r in RUNGS])
def test_serving_engine_on_the_mesh_equals_jax(run, mesh, rung):
    """Every request's rows bitwise the JAX engine's on its images; the
    front end's stats a single-card server's on the same traffic."""
    ranks, _, refs, single = run
    got = ranks[0][case_name("serve", mesh, rung)]
    for (a, b), rows in zip(_ranges(SERVE_SIZES), got["served"]):
        assert rows.shape == (b - a, CLASSES) and rows.dtype == np.float32
        np.testing.assert_array_equal(rows, refs[rung][a:b])
    assert got["stats"] == single and not got["alive"]
    assert single["bucket_hits"] == {8: 5, 4: 1} and single["padded"] == 2


def test_collectives_per_round(run):
    """Each rank's counted collectives per round: the header (down the data
    line, along the row), the slices to the row leaders, the row's
    broadcast of its slice and its error exchange, the logits back (a
    status header and the payload), the stop round; under TP the engine's
    all-reduces.  Bytes: 64 per header, 32 x 32 x 3 per image row, 4 x 10
    per logits row, over the rows the rounds computed (padding included)."""
    ranks = run[0]
    img, out = SIZE * SIZE * 3, CLASSES * 4
    for rung in RUNGS:
        st = ranks[0][case_name("serve", (4, 1), rung)]["stats"]
        n, rows = st["batches"], (st["images"] + st["padded"]) // 4  # per data row
        c = [rk[case_name("serve", (4, 1), rung)]["counts"] for rk in ranks]
        assert c[0] == {"broadcast": n + 1, "broadcast_bytes": 64 * (n + 1), "send": 3 * n,
                        "send_bytes": 3 * rows * img, "recv": 6 * n,
                        "recv_bytes": 3 * (64 * n + rows * out)}, c[0]
        for r in (1, 2, 3):
            assert c[r] == {"broadcast": n + 1, "broadcast_bytes": 64 * (n + 1), "recv": n,
                            "recv_bytes": rows * img, "send": 2 * n,
                            "send_bytes": 64 * n + rows * out}, (r, c[r])
        st = ranks[0][case_name("serve", (2, 2), rung)]["stats"]
        n, rows = st["batches"], (st["images"] + st["padded"]) // 2
        c = [rk[case_name("serve", (2, 2), rung)]["counts"] for rk in ranks]
        for r in range(WORLD):
            lead, front = r % 2 == 0, r == 0
            assert c[r]["broadcast"] == (3 if lead else 2) * n + (2 if lead else 1), (r, c[r])
            assert c[r]["all_reduce"] == (TP_ROWS + 1) * n, (r, c[r])
            want_recv = 2 * n if front else (n if lead else 0)
            want_send = n if front else (2 * n if lead else 0)
            assert c[r].get("recv", 0) == want_recv and c[r].get("send", 0) == want_send, (r, c[r])
        assert c[0]["send_bytes"] == rows * img and c[0]["recv_bytes"] == 64 * n + rows * out


@pytest.mark.parametrize("mesh,rung", [(m, r) for m in XHOST_MESHES for r in RUNGS],
                         ids=[case_name("xhost", m, r) for m in XHOST_MESHES for r in RUNGS])
def test_crosshost_on_the_mesh_equals_jax(run, mesh, rung):
    """Each leader's rows bitwise the JAX engine's on its own images; every
    leader ran the same rounds (coordination ticks equal); the low-load
    round ran the smallest bucket and the per-host-shard request the
    largest; each leader's data-line all-reduces one per tick."""
    ranks, _, refs, _ = run
    hosts, m = mesh
    name = case_name("xhost", mesh, rung)
    leaders = [ranks[h * m][name] for h in range(hosts)]
    ticks = {ld["stats"]["coord_ticks"] for ld in leaders}
    assert len(ticks) == 1, ticks
    for h, ld in enumerate(leaders):
        st = ld["stats"]
        waves = xhost_waves(hosts)[h]
        assert st["images"] == sum(b - a for w in waves for a, b in w) and not ld["alive"]
        for a, b, rows in ld["served"]:
            np.testing.assert_array_equal(rows, refs[rung][a:b])
        hits = st["bucket_hits"]
        assert hits.get(min(XHOST_BUCKETS)) and hits.get(max(XHOST_BUCKETS)), st
        assert sum(hits.values()) == st["batches"]
        rounds = st["batches"] + st["idle_rounds"]
        assert st["coord_ticks"] >= rounds
        assert ld["counts"]["all_reduce"] == st["coord_ticks"] + (TP_ROWS + 1) * rounds * (m > 1)
        if m > 1:  # the row: a header and the shard per round, the stop round
            follower = ranks[h * m + 1][name]["counts"]
            assert follower["broadcast"] == ld["counts"]["broadcast"] == 2 * rounds + 1
            assert follower["all_reduce"] == (TP_ROWS + 1) * rounds


def test_follower_engine_error_reaches_the_front_end(run):
    """(2, 2) mesh of replicas, rank 3 (model index 1 of data row 1) raises
    in its first call: the first batch's future fails naming it, the next
    batch is served and equal to the JAX engine's, every rank's loop ends."""
    ranks, _, refs, _ = run
    got = ranks[0]["boom"]
    assert got["served"][0].startswith("RuntimeError") and "rank 3" in got["served"][0]
    assert "boom in the engine" in got["served"][0]
    np.testing.assert_array_equal(got["served"][1], refs["strict"][8:16])
    assert got["stats"]["batches"] == 1 and not got["alive"]


def test_a_lost_rank_ends_every_loop(run):
    """Rank 3 of a (4, 1) mesh exits in the middle of a round: the front
    end's future fails with MeshError, a later request fails at once, the
    other ranks' stop() raises once the front end has gone; every process
    ends (the fixture's exit codes: 0, 0, 0, 3)."""
    crashed = run[1]
    assert crashed[0]["first"].startswith("MeshError"), crashed[0]
    assert crashed[0]["second"] == "MeshError" and crashed[0]["stop"] == "returned"
    for r in (1, 2):
        assert crashed[r]["stop"] == "RuntimeError", crashed[r]
    assert not any(c["alive"] for c in crashed)


def test_pick_bucket_equals_jax():
    """The bucket ladder's choice over (total, max_host, nproc), with the
    JAX server's own method."""
    for buckets in ((8,), (8, 16, 64), (4, 8, 16, 32, 128)):
        obj = types.SimpleNamespace(buckets=buckets)
        for nproc in (1, 2, 4):
            for total in range(0, 140, 3):
                for max_host in range(0, min(total, 40) + 1, 2):
                    want = JaxCrossHost._pick_bucket(obj, total, max_host, nproc)
                    assert CrossHostServingEngine._pick_bucket(obj, total, max_host, nproc) == want


def test_crosshost_single_host_equals_jax():
    """A 1x1 mesh without processes against the JAX server at
    process_count == 1 on Mesh(data=8): requests queued before start(), the
    bucket ladder (8, 16, 32), an engine that sets the stop flag in its
    second call.  The same routed outputs and the same batches, images,
    padding and bucket hits."""
    sizes = [5, 9, 3, 8, 6, 7, 2, 4]  # round 1: 5 + 9 + 3 + 8 + 6, the 7 deferred; round 2: 13
    reqs = [np.full((k, 4, 4, 3), i + 1, np.float32) for i, k in enumerate(sizes)]

    def serve(make, engine_of):
        calls = {"n": 0}
        box = {}

        def engine(x):
            calls["n"] += 1
            if calls["n"] == 2:
                box["srv"]._stop.set()
            return engine_of(x)

        srv = box["srv"] = make(engine)
        futs = [srv.submit(r) for r in reqs]
        srv.start()
        outs = [f.result(30) for f in futs]
        srv.stop()
        assert not srv._thread.is_alive()
        return outs, {k: srv.stats[k] for k in ("batches", "images", "padded", "bucket_hits")}

    jmesh = jax_make_mesh(data=8, model=1)
    from jax.sharding import NamedSharding, PartitionSpec as P

    jfn = jax.jit(lambda v: jnp.stack([jnp.sum(v, axis=(1, 2, 3)), jnp.max(v, axis=(1, 2, 3))], 1),
                  out_shardings=NamedSharding(jmesh, P("data")))
    want, wstats = serve(lambda e: JaxCrossHost(e, jmesh, buckets=(8, 16, 32), tick_ms=300.0), jfn)
    got, gstats = serve(lambda e: CrossHostServingEngine(e, make_mesh(1, 1, device="cpu"),
                                                         buckets=(8, 16, 32), tick_ms=300.0),
                        _Echo())
    assert gstats == wstats == {"batches": 2, "images": 44, "padded": 4,
                                "bucket_hits": {32: 1, 16: 1}}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
