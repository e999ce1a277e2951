"""Continuous-batching inference server around the integer engine (the port
of `f8net_tpu/engine/serve.py:29-429`).

  * requests (single images or small batches) enter a queue, or are written
    by the client straight into a shared ingestion ring;
  * a dispatcher thread coalesces them into device batches within
    `max_wait_ms`, padding a tail only to the smallest bucket that holds it
    (each bucket is one input shape the engine sees), and splitting an
    oversized request across full batches;
  * results are demuxed back to per-request futures, errors included.

Throughput scales with the device batch; latency is bounded by max_wait_ms
plus a forward.  Works with any callable engine that takes a torch tensor
and returns one (IntEngine in any rung, or a baseline); the batch goes to
the engine's `device` where it has one, else stays on the CPU.

On a card the host buffers the dispatcher hands over -- the ring and the
per-bucket pad buffers -- are pinned (page-locked), so a batch's copy to the
device is asynchronous (`non_blocking=True`), and the engine only enqueues
its kernels on torch's current stream.  Right behind each batch's forward
the dispatcher enqueues its logits' copy into pinned host memory and an
event; routing batch k waits on that event alone (the one blocking step),
so the card computes batch k+1 while the host routes batch k.  (A plain
`.cpu()` would wait for the whole stream, batch k+1's forward included.)
The dispatcher thread launches every kernel, on the engine's device: the
kernels' launch counters are plain attributes, so no other thread may run
the engine while the server does.

Not ported here: `mesh=` (data-parallel dispatch) and the reference's
`CrossHostServingEngine` belong to multi-GPU serving (ROADMAP item 1.10).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np
import torch


def _host_array(shape, dtype, pinned: bool) -> np.ndarray:
    """A zeroed host array; page-locked when it feeds a card (pinning needs
    CUDA, so only then).  The numpy view keeps its torch tensor alive."""
    if not pinned:
        return np.zeros(shape, dtype)
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    return torch.zeros(tuple(shape), dtype=tdtype, pin_memory=True).numpy()


class _ImageRing:
    """Shared-memory ingestion ring: clients copy their images directly into
    a preallocated (capacity, H, W, C) buffer at submit time, so the
    dispatcher's hot loop does no per-image copy -- a batch is a contiguous
    slice view of the ring.

    Positions are absolute monotonically-increasing integers; slot =
    pos % capacity.  `alloc` never returns a wrapping range (it skips the
    tail slots instead; the skipped positions are reclaimed when the next
    batch frees past them).  A slot is "ready" once its writer finished
    (`ready[slot] == pos`); the dispatcher waits on exactly the rows it
    routes, so stale pad rows cost nothing.  Slots are freed after the
    batch's logits are routed, by when its copy to the device is done.
    """

    def __init__(self, capacity: int, shape, dtype, pinned: bool = False):
        self.R = int(capacity)
        self.buf = _host_array((self.R,) + tuple(shape), dtype, pinned)
        self.ready = np.full(self.R, -1, np.int64)
        self.head = 0  # next abs position to allocate
        self.tail = 0  # abs position before which every slot is free
        self.cond = threading.Condition()
        self.waiters = 0  # notify only when someone actually waits

    def alloc(self, n: int, timeout: float = 10.0) -> Optional[int]:
        """Reserve n contiguous slots; returns the abs start position, or
        None on timeout (the caller falls back to the copy path)."""
        if not 0 < n <= self.R:
            raise ValueError(f"cannot reserve {n} slots of a ring of {self.R}")
        deadline = time.perf_counter() + timeout
        with self.cond:
            if (self.head % self.R) + n > self.R:
                # skip the wrap tail; those positions are never written and
                # are reclaimed when free_upto passes them
                self.head += self.R - (self.head % self.R)
            while self.head + n - self.tail > self.R:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return None
                self.waiters += 1
                try:
                    self.cond.wait(remaining)
                finally:
                    self.waiters -= 1
            start = self.head
            self.head += n
            return start

    def write(self, start: int, images: np.ndarray):
        s = start % self.R
        self.buf[s : s + images.shape[0]] = images
        with self.cond:
            self.ready[s : s + images.shape[0]] = np.arange(start, start + images.shape[0])
            if self.waiters:
                self.cond.notify_all()

    def wait_ready(self, start: int, n: int, timeout: float = 10.0) -> bool:
        s = start % self.R
        want = np.arange(start, start + n)
        deadline = time.perf_counter() + timeout
        with self.cond:
            while not (self.ready[s : s + n] == want).all():
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return False
                self.waiters += 1
                try:
                    self.cond.wait(remaining)
                finally:
                    self.waiters -= 1
        return True

    def view(self, start: int, n: int) -> np.ndarray:
        s = start % self.R
        if s + n > self.R:
            raise ValueError(f"a view of {n} rows at slot {s} wraps a ring of {self.R}")
        return self.buf[s : s + n]

    def free_upto(self, pos: int):
        with self.cond:
            if pos > self.tail:
                self.tail = pos
                if self.waiters:
                    self.cond.notify_all()


class _RingRef:
    """Queue payload standing in for images living in the ring."""

    __slots__ = ("ring", "start", "shape")

    def __init__(self, ring: _ImageRing, start: int, n: int):
        self.ring = ring
        self.start = start
        self.shape = (n,) + ring.buf.shape[1:]

    @property
    def end(self) -> int:
        return self.start + self.shape[0]

    def materialize(self) -> np.ndarray:
        return self.ring.view(self.start, self.shape[0])


class ServingEngine:
    def __init__(
        self,
        engine,
        batch_size: Optional[int] = None,
        max_wait_ms: float = 5.0,
        mesh=None,
        buckets=None,
        ring_capacity: int = 0,
        image_shape=None,
        image_dtype=np.uint8,
        name: str = "f8net-serving",
    ):
        """buckets: optional ascending batch-size buckets, e.g. (8, 16, 64).
        The dispatcher pads a tail batch only up to the smallest bucket that
        holds it, so low load runs a small batch (less padding waste, lower
        latency) instead of always paying the full one; the largest bucket
        is the device batch size.  ring_capacity (in images, >= 2x the
        batch; 4x keeps it off the allocator's critical path) with
        image_shape and image_dtype: the zero-copy ingestion ring for
        requests of that row shape and dtype.  mesh: not ported (raises)."""
        if mesh is not None:
            raise NotImplementedError(
                "ServingEngine(mesh=...): data-parallel dispatch over several cards is "
                "multi-GPU serving, ROADMAP item 1.10"
            )
        self.engine = engine
        if buckets:
            buckets = tuple(sorted(set(int(b) for b in buckets)))
            if batch_size is not None and batch_size != buckets[-1]:
                raise ValueError("pass the batch via buckets (largest bucket) or keep them equal")
            batch_size = buckets[-1]
        batch_size = batch_size or 64
        self.buckets = buckets or (batch_size,)
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.device = torch.device(getattr(engine, "device", None) or "cpu")
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._started = False
        # reusable batch buffers, 2 per bucket (round-robin matching the
        # one-deep pipeline): tail rows keep stale data instead of paying a
        # pad memcpy -- their outputs are never routed
        self._bufs = {}
        self._ring = None
        self._submit_lock = threading.Lock()
        if ring_capacity:
            if image_shape is None:
                raise ValueError("ring ingestion needs image_shape")
            if ring_capacity < 2 * batch_size:
                raise ValueError(f"ring_capacity {ring_capacity} < 2 x batch {batch_size}")
            self._ring = _ImageRing(ring_capacity, image_shape, image_dtype,
                                    pinned=self.device.type == "cuda")
        self.stats = {
            "batches": 0, "images": 0, "padded": 0, "bucket_hits": {},
            "ring_batches": 0, "copy_batches": 0,
        }

    # -- public API ---------------------------------------------------------

    def start(self):
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def stop(self):
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5.0)

    def submit(self, images: np.ndarray) -> Future:
        """images: (H,W,C) or (n,H,W,C) conditioned engine input (numpy).
        Returns a Future resolving to the logits for those images (numpy)."""
        if images.ndim == 3:
            images = images[None]
        fut: Future = Future()
        ring = self._ring
        if (
            ring is not None
            and images.shape[1:] == ring.buf.shape[1:]
            and images.dtype == ring.buf.dtype
            and images.shape[0] <= self.batch_size
        ):
            # alloc + enqueue under one lock so queue order matches slot
            # order (contiguous slices stay the common case); the copy runs
            # in the client's thread, off the dispatcher's critical path
            with self._submit_lock:
                start = ring.alloc(images.shape[0], timeout=0.0)
                if start is not None:
                    self._q.put((_RingRef(ring, start, images.shape[0]), fut))
            if start is not None:
                ring.write(start, images)
                return fut
            # ring full right now: block for space outside the order lock
            # (order breaks -> the dispatcher's contiguity check catches it)
            start = ring.alloc(images.shape[0], timeout=5.0)
            if start is not None:
                self._q.put((_RingRef(ring, start, images.shape[0]), fut))
                ring.write(start, images)
                return fut
        self._q.put((images, fut))
        return fut

    def infer(self, images: np.ndarray, timeout: Optional[float] = 60.0):
        return self.submit(images).result(timeout)

    # -- dispatcher ---------------------------------------------------------

    def _collect(self, wait: bool = True) -> List[Tuple[np.ndarray, Future]]:
        """Wait for the first request (without `wait`, take one only if it
        is there), then fill the batch within the latency budget."""
        try:
            first = self._q.get(timeout=0.1) if wait else self._q.get_nowait()
        except queue.Empty:
            return []
        items = [first]
        n = first[0].shape[0]
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while n < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            items.append(item)
            n += item[0].shape[0]
        return items

    def _loop(self):
        """One-deep pipeline: batch k+1 is collected, copied and enqueued on
        the device before the host waits for batch k's logits (their copy
        was enqueued right behind batch k's forward), so the device computes
        k+1 while the host routes k.  When no request is waiting,
        batch k is routed at once: the reference's loop waits there up to
        100 ms for a next request first, a latency floor under light load.
        The current CUDA device is per thread: the loop runs on the
        engine's."""
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            pending = []  # [((host logits, event), items, valid rows, ring free point)]
            while not self._stop.is_set():
                items = self._collect(wait=not pending)
                launched = []
                if items:
                    try:
                        launched = self._launch(items)
                    except Exception as e:  # route errors to the waiting futures
                        _fail(items, e)
                self._drain(pending)
                pending = launched
            self._drain(pending)

    def _drain(self, pending):
        """Route each launched batch's logits (the blocking step) and free
        its ring slots; a failure goes to the batch's futures."""
        for (logits, done), its, valid, free_pos in pending:
            try:
                rows = logits.numpy()
                if done is not None:
                    # routed rows must not hold the pinned block: copy it
                    done.synchronize()
                    rows = rows.copy()
                self._route(rows, its, valid)
            except Exception as e:
                _fail(its, e)
            finally:
                if free_pos is not None:
                    self._ring.free_upto(free_pos)

    def _launch(self, items):
        """Enqueue device work for the collected requests; non-blocking.

        Zero-copy fast path: when every collected item lives in the
        ingestion ring in one contiguous slot run and the padded bucket fits
        before the ring's wrap point, the device batch is a slice view of
        the ring (pad rows are whatever the ring holds; never routed)."""
        ring = self._ring
        free_pos = None
        if ring is not None:
            ring_items = [a for a, _ in items if isinstance(a, _RingRef)]
            if ring_items:
                free_pos = max(r.end for r in ring_items)
            n = sum(a.shape[0] for a, _ in items)
            if (
                len(ring_items) == len(items)
                and n <= self.batch_size
                and all(items[i + 1][0].start == items[i][0].end for i in range(len(items) - 1))
            ):
                start = items[0][0].start
                bucket = next(b for b in self.buckets if b >= n)
                if (start % ring.R) + bucket <= ring.R and ring.wait_ready(start, n):
                    self.stats["padded"] += bucket - n
                    self.stats["bucket_hits"][bucket] = self.stats["bucket_hits"].get(bucket, 0) + 1
                    self.stats["ring_batches"] += 1
                    return [(self._run(ring.view(start, bucket)), items, n, free_pos)]
            # slow path: ring views into the copy path (each ref waits for
            # its writer first -- a view of unwritten slots reads garbage)
            for a, _ in items:
                if isinstance(a, _RingRef) and not ring.wait_ready(a.start, a.shape[0]):
                    raise TimeoutError("ring writer never completed")
            items = [(a.materialize() if isinstance(a, _RingRef) else a, f) for a, f in items]
        # a collected set may mix row shapes (ring traffic plus an odd-shaped
        # request): one copy-path batch per shape group
        shapes = {a.shape[1:] for a, _ in items}
        if len(shapes) > 1:
            out = []
            for shp in shapes:
                grp = [(a, f) for a, f in items if a.shape[1:] == shp]
                out.extend(self._launch_copy(grp, free_pos))
                free_pos = None  # attach the ring free point once
            return out
        return self._launch_copy(items, free_pos)

    def _launch_copy(self, items, free_pos):
        self.stats["copy_batches"] += 1
        batch = np.concatenate([a for a, _ in items], axis=0)
        n = batch.shape[0]
        out = []
        # oversized multi-image requests split across full device batches
        while n > self.batch_size:
            head, batch = batch[: self.batch_size], batch[self.batch_size :]
            n = batch.shape[0]
            out.append((self._run(head), items, None, None))
        # pad the tail only to the smallest bucket that holds it
        bucket = next(b for b in self.buckets if b >= n)
        pad = bucket - n
        if pad:
            key = (bucket,) + tuple(batch.shape[1:]) + (batch.dtype.str,)
            bufs = self._bufs.setdefault(key, [
                _host_array((bucket,) + batch.shape[1:], batch.dtype, self.device.type == "cuda")
                for _ in range(2)
            ])
            bufs.append(buf := bufs.pop(0))
            buf[:n] = batch  # stale tail rows are never routed
            batch = buf
        self.stats["padded"] += pad
        self.stats["bucket_hits"][bucket] = self.stats["bucket_hits"].get(bucket, 0) + 1
        out.append((self._run(batch), items, n, free_pos))
        return out

    def _run(self, batch: np.ndarray):
        """The host batch on the engine's device, the engine call and the
        logits' way back, all enqueued (asynchronous on a card); returns
        (host logits, event or None) for `_drain`.  From a pinned buffer the
        copy is asynchronous too, and the buffer is rewritten only once no
        copy of it can be in flight: a ring slot after its batch's logits
        were routed, a pad buffer two batches later, after the batch that
        used it was routed -- and routing waits on an event recorded after
        that batch's copy on the same stream.  From any other array (an
        exact-fit copy batch, the heads of an oversized request) the copy
        is synchronous with the host.  On the CPU torch.from_numpy would
        alias the reusable buffer, so it is copied."""
        x = torch.from_numpy(batch)
        if self.device.type == "cuda":
            x = x.to(self.device, non_blocking=True)
        else:
            x = x.clone()
        return _fetch(self.engine(x))

    def _route(self, logits, items, valid: Optional[int] = None):
        return _route_rows(self.stats, logits, items, valid)


def _fetch(y: torch.Tensor):
    """Start a batch's logits on their way to the host: (host tensor, event
    or None).  On a card the copy into pinned memory and the event are
    enqueued behind the forward and ahead of the next batch's work, so
    waiting on the event waits for this batch alone."""
    if not y.is_cuda:
        return y, None
    stream = torch.cuda.current_stream(y.device)
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    host.copy_(y, non_blocking=True)
    done = torch.cuda.Event()
    done.record(stream)
    return host, done


def _fail(items, e: BaseException):
    for _, fut in items:
        if not fut.done():
            fut.set_exception(e)


def _route_rows(stats, logits, items, valid: Optional[int] = None):
    """Route a batch's logits rows back to the futures in arrival order; a
    request split across batches resolves when its last rows arrive."""
    stats["batches"] += 1
    stats["images"] += valid if valid is not None else logits.shape[0]
    row = 0
    for arr, fut in items:
        k = arr.shape[0]
        done_rows = getattr(fut, "_serving_offset", 0)
        take = min(k - done_rows, logits.shape[0] - row)
        if take <= 0:
            continue
        part = logits[row : row + take]
        row += take
        prev = getattr(fut, "_serving_parts", [])
        prev.append(part)
        setattr(fut, "_serving_parts", prev)
        setattr(fut, "_serving_offset", done_rows + take)
        if done_rows + take == k and not fut.done():
            fut.set_result(np.concatenate(prev, axis=0))
