"""The port's ServingEngine (f8net_tpu_torch.engine.serve) against the JAX
package's, and the deploy path's serving slice on the CPU.

Coalescing is made deterministic without the wall clock: a server whose
`max_wait_ms` is a minute launches a batch only when its requests fill it,
so the batches follow from the request sizes alone (tests/test_serving.py
instead lets 50 ms of wall time decide).  The scenarios run through both
packages' servers with echo engines, which must route the same outputs and
count the same batches, padding, bucket hits and ring/copy batches.

The slice: the port's `ServingEngine(IntEngine(..., device="cpu"))` on
ResNet-18 at 32 px, 10 classes, on chip_smoke.py's synthetic bake, buckets
(2, 4, 8), a ring, requests of 1-20 images.  Tolerance 0: in the strict
rung each request's logits equal one JAX `IntEngine(int_only=True)` call on
all the images; in the int8 and bf16 rungs each served row equals the
port's own engine on the device batch the server handed it.
"""

import queue
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

import chip_smoke
from f8net_tpu.engine import IntEngine as JaxIntEngine
from f8net_tpu.engine.serve import ServingEngine as JaxServingEngine
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.quant.plan import LayerPlan as JaxLayerPlan
from f8net_tpu.quant.plan import QuantPlan as JaxQuantPlan
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.engine import IntEngine, ServingEngine
from f8net_tpu_torch.export import params_from_numpy
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.utils import QuantConfig

LONG_MS = 60_000.0  # a batch launches when its requests fill it, never on the clock
TIMEOUT = 60.0
RING = dict(ring_capacity=16, image_shape=(8, 8, 3), image_dtype=np.float32)


class _EchoEngine:
    """logits[i] = (sum of image i, call number), in torch."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        s = x.to(torch.float32).sum((1, 2, 3))
        return torch.stack([s, torch.full_like(s, self.calls)], 1)


class _JaxEchoEngine(_EchoEngine):
    def __call__(self, x):
        self.calls += 1
        s = jnp.sum(x.astype(jnp.float32), axis=(1, 2, 3))
        return jnp.stack([s, jnp.full_like(s, self.calls)], axis=1)


def _request(v0, n, hw=8):
    """n images of side hw, image i filled with v0 + i."""
    return np.stack([np.full((hw, hw, 3), v0 + i, np.float32) for i in range(n)])


def _sums(req):
    return req.astype(np.float64).sum((1, 2, 3))


# Each scenario: server keywords, waves of requests (v0, n[, hw]) -- a wave
# is submitted from one thread, then all its results are awaited -- and the
# stats it must end with.
SCENARIOS = {
    "coalesce_and_demux": (
        dict(batch_size=4, max_wait_ms=LONG_MS), [[(0, 1), (1, 1), (2, 1), (3, 1)]],
        dict(batches=1, images=4, padded=0, bucket_hits={4: 1}, copy_batches=1),
    ),
    "padding": (
        dict(batch_size=8, max_wait_ms=1.0), [[(2, 1)]],
        dict(batches=1, images=1, padded=7, bucket_hits={8: 1}),
    ),
    "oversized_split": (
        dict(batch_size=4, max_wait_ms=1.0), [[(0, 10)]],
        dict(batches=3, images=10, padded=2, bucket_hits={4: 1}, copy_batches=1),
    ),
    "buckets": (
        dict(buckets=(2, 4, 16), max_wait_ms=1.0), [[(3, 1)], [(0, 7)]],
        dict(batches=2, images=8, padded=1 + 9, bucket_hits={2: 1, 16: 1}),
    ),
    "ring_zero_copy": (
        dict(batch_size=4, max_wait_ms=LONG_MS, **RING), [[(i, 1) for i in range(4)]],
        dict(batches=1, padded=0, ring_batches=1, copy_batches=0),
    ),
    # sizes 1 + 3 fill each batch; on a ring of 10, from the third batch on
    # every other 3-image request skips the wrap tail, and its batch is not
    # contiguous
    "ring_wraparound": (
        dict(batch_size=4, max_wait_ms=LONG_MS, **dict(RING, ring_capacity=10)),
        [[(10 * k, 1), (10 * k + 1, 3)] for k in range(12)],
        dict(batches=12, images=48, padded=0, ring_batches=7, copy_batches=5),
    ),
    "ring_fallback_on_shape_mismatch": (
        dict(batch_size=4, max_wait_ms=LONG_MS, **RING),
        [[(1, 1), (2, 1, 4), (3, 1), (4, 1)]],
        dict(batches=2, images=4, padded=4, ring_batches=0, copy_batches=2),
    ),
}


def _serve(server, waves):
    """Runs the waves; returns [(request, result)] in submission order."""
    out = []
    try:
        server.start()
        for wave in waves:
            reqs = [_request(*r) for r in wave]
            futs = [server.submit(r) for r in reqs]
            out += [(r, f.result(TIMEOUT)) for r, f in zip(reqs, futs)]
    finally:
        server.stop()
    assert not server._thread.is_alive()
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(name):
    kw, waves, want = SCENARIOS[name]
    srv, jsrv = ServingEngine(_EchoEngine(), **kw), JaxServingEngine(_JaxEchoEngine(), **kw)
    got, ref = _serve(srv, waves), _serve(jsrv, waves)
    for (req, out), (_, out_ref) in zip(got, ref):
        assert out.shape == (req.shape[0], 2)
        np.testing.assert_array_equal(out[:, 0], _sums(req))
        np.testing.assert_array_equal(out, out_ref)
    assert srv.stats == jsrv.stats
    assert {k: srv.stats[k] for k in want} == want


@pytest.mark.parametrize("ring", [False, True], ids=["queue", "ring_hammer"])
def test_many_concurrent_clients(ring):
    """Many client threads at once (through the ring: all writing into it
    concurrently, more of them than it holds): every future gets exactly
    its own logits, and full batches only."""
    clients, batch = (48, 8) if ring else (64, 16)
    kw = dict(RING, ring_capacity=32) if ring else {}
    srv = ServingEngine(_EchoEngine(), batch_size=batch, max_wait_ms=LONG_MS, **kw).start()
    results, lock = {}, threading.Lock()

    def client(k):
        out = srv.infer(_request(100 + k, 1), timeout=TIMEOUT)
        with lock:
            results[k] = out

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
    finally:
        srv.stop()
    assert not any(t.is_alive() for t in threads) and not srv._thread.is_alive()
    assert sorted(results) == list(range(clients))
    for k, out in results.items():
        np.testing.assert_array_equal(out[:, 0], _sums(_request(100 + k, 1)))
    assert srv.stats["batches"] == clients // batch and srv.stats["padded"] == 0


def test_error_routing():
    class Boom:
        def __call__(self, x):
            raise RuntimeError("kernel exploded")

    srv = ServingEngine(Boom(), batch_size=2, max_wait_ms=1.0).start()
    try:
        fut = srv.submit(_request(1, 1))
        with pytest.raises(RuntimeError, match="kernel exploded"):
            fut.result(TIMEOUT)
    finally:
        srv.stop()


def test_cpu_engine_gets_a_copy_of_the_reused_buffer():
    """On the CPU the batch handed to the engine is its own memory, not the
    pad buffer the next batches rewrite."""
    seen = []

    class Keep(_EchoEngine):
        def __call__(self, x):
            seen.append(x)
            return super().__call__(x)

    srv = ServingEngine(Keep(), batch_size=4, max_wait_ms=1.0)
    _serve(srv, [[(1, 1)], [(2, 1)], [(3, 1)]])
    assert [float(x[0, 0, 0, 0]) for x in seen] == [1.0, 2.0, 3.0]


# -- the slice: ResNet-18 through the server --------------------------------

CFG = dict(format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
           pool_fusing=True)
HW, CLASSES = 32, 10
# request sizes; with LONG_MS each collected set is the shortest run of
# requests that reaches 8 images, and a set of more is split: [3, 5]
# [2, 2, 2, 2] [3, 4, 3] -> 8 + 2, [5, 6] -> 8 + 3 (bucket 4), [1, 7],
# [20] -> 8 + 8 + 4, [4, 4], [9] -> 8 + 1 (bucket 2); the four sets of 8
# are ring slices, requests over 8 images do not enter the ring
SIZES = [3, 5, 2, 2, 2, 2, 3, 4, 3, 5, 6, 1, 7, 20, 4, 4, 9]


@pytest.fixture(scope="module")
def resnet18():
    """(port model, plan records, numpy arrays, wire images (uint8 NHWC),
    the JAX strict engine's logits on all of them)."""
    model = get_model("resnet18", QuantConfig(**CFG), CLASSES, HW)
    rng = np.random.RandomState(9)
    x = (np.round(255 * rng.rand(sum(SIZES), HW, HW, 3)) / 256).astype(np.float32)
    records, arrays, _ = chip_smoke.synthetic_bundle(model, 9, torch.from_numpy(x[:8]))
    wire = np.round(255 * x).astype(np.uint8)
    jmodel = jax_get_model("resnet18", JaxQuantConfig(**CFG), CLASSES, HW)
    plan = JaxQuantPlan(tuple(JaxLayerPlan(*r) for r in records))
    ip = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in arrays.items()}
    want = np.asarray(JaxIntEngine(jmodel, plan, ip, int_only=True)(jnp.asarray(wire)))
    return model, records, arrays, wire, want


@pytest.mark.parametrize("rung", [None, "int8_boundary", "bf16_boundary"])
def test_resnet18_served_through_the_engine(resnet18, rung):
    model, records, arrays, wire, want = resnet18
    plan, params = params_from_numpy(records, arrays, "cpu")
    eng = IntEngine(model, plan, params, device="cpu", **({rung: True} if rung else {}))
    rec = chip_smoke.ServeRecorder(eng)  # keeps each device batch and its logits
    srv = ServingEngine(rec, buckets=(2, 4, 8), max_wait_ms=LONG_MS, ring_capacity=64,
                        image_shape=(HW, HW, 3), image_dtype=np.uint8)
    offsets = np.cumsum([0] + SIZES)
    try:
        srv.start()
        futs = [srv.submit(wire[a:b]) for a, b in zip(offsets[:-1], offsets[1:])]
        served = [f.result(TIMEOUT) for f in futs]
    finally:
        srv.stop()
    assert not srv._thread.is_alive()
    assert srv.stats["images"] == len(wire) and srv.stats["batches"] == len(rec.calls) == 13
    assert srv.stats["bucket_hits"] == {2: 2, 4: 2, 8: 4} and srv.stats["padded"] == 2
    assert (srv.stats["ring_batches"], srv.stats["copy_batches"]) == (4, 4)
    if rung is None:  # strict: integer throughout, the batch does not matter
        for (a, b), got in zip(zip(offsets[:-1], offsets[1:]), served):
            np.testing.assert_array_equal(got, want[a:b])
    for x, y, _ in rec.calls:  # the engine again on each device batch
        assert torch.equal(eng(x), y)
    for (a, b), got in zip(zip(offsets[:-1], offsets[1:]), served):
        for img, row in zip(wire[a:b], got):
            hits = [y[i] for x, y, _ in rec.calls for i in range(len(x))
                    if np.array_equal(x[i].numpy(), img)]
            assert any(np.array_equal(h.numpy(), row) for h in hits)


def test_routes_a_batch_without_waiting_for_the_next_request():
    """With a batch in flight and no request waiting, the dispatcher routes
    the batch at once.  A request queue that delivers one request and then
    holds every waiting get stands for a client that sends nothing more:
    the reference's loop would hold the answer until such a get returned."""
    quiet = threading.Event()

    class Quiet(queue.Queue):
        delivered = 0

        def get(self, block=True, timeout=None):
            if block and self.delivered:
                quiet.wait(TIMEOUT)
                raise queue.Empty
            item = super().get(block, timeout)
            self.delivered += 1
            return item

    srv = ServingEngine(_EchoEngine(), batch_size=1, max_wait_ms=0.0)
    srv._q = Quiet()
    try:
        srv.start()
        out = srv.submit(_request(5, 1)).result(TIMEOUT / 2)
    finally:
        quiet.set()
        srv.stop()
    assert not srv._thread.is_alive()
    np.testing.assert_array_equal(out[:, 0], _sums(_request(5, 1)))
