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

Across cards (the port of `:163-168`, `:395-405` and `:432-691`), on a
`parallel.Mesh` of processes, one rank per card (or several sharing one
card over gloo):

  * `ServingEngine(engine, mesh=mesh)`, built and started on every rank of
    the mesh: rank 0 (data 0, model 0) is the front end -- the queue, the
    ring, the buckets, the padding and the stats above, unchanged -- and
    `submit` anywhere else raises.  Each device batch is one round: a
    fixed-size int64 header (stop flag, the row slice's dtype and shape)
    goes to every rank by broadcast, down the data-row leaders' line
    (model index 0) and along each row; each data row's leader receives
    only its slice of the padded batch (`parallel.mesh.shard_batch`'s rows)
    and broadcasts it along its row; every rank calls `engine(its row's
    slice)` -- a `TPEngine` shard or an `IntEngine` replica -- and each
    leader sends its row's logits back to rank 0, which puts them in data
    order and routes them.  A round is synchronous on the front end: its
    logits come back before the next batch is sent.  The stop round ends
    every rank's loop; a follower's `stop()` waits for it.
  * `CrossHostServingEngine(engine, mesh, ...)`: a "host" of the reference
    is a data row.  Every row's leader (every rank where model == 1) runs a
    queue of its own; each tick the leaders agree, by one all-reduce of a
    (depth, stop) pair per row along their data line, on the bucket (the
    smallest holding the global demand) and on shutdown; the leader pads
    its rows to the bucket's per-row shard and broadcasts it along its row,
    every rank of the row runs the engine on it, and the leader routes its
    own rows.  Rows exchange nothing else.

On a mesh an engine error on any rank fails that batch's futures (every
rank of a row learns of its peers' errors by one all-reduce of their
messages); the round completes, so the ranks stay in step.  A failure of
the transport itself (a peer gone) ends every rank's loop: the front end's
futures and queued requests fail, a follower's `stop()` raises.  Under
NCCL every header and payload crosses on the card; under gloo, on the host.
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


def _device_of(engine) -> torch.device:
    """Where the engine computes ("cpu" for one that does not say).  A card
    without an index is the current card of the thread that builds the
    server: the dispatcher thread computes there."""
    dev = torch.device(getattr(engine, "device", None) or "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


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
        requests of that row shape and dtype.  mesh: a `parallel.Mesh` this
        process is a rank of; every rank builds the server with the same
        buckets (each a multiple of the data axis) and starts it, rank 0 is
        the front end (module docstring).  The ring lives on the front
        end; the other ranks learn the row shape from each round."""
        self.engine = engine
        if buckets:
            buckets = tuple(sorted(set(int(b) for b in buckets)))
            if batch_size is not None and batch_size != buckets[-1]:
                raise ValueError("pass the batch via buckets (largest bucket) or keep them equal")
            batch_size = buckets[-1]
        batch_size = batch_size or 64
        self.buckets = buckets or (batch_size,)
        self.batch_size = batch_size
        self.mesh = mesh
        if mesh is not None:
            if not mesh.member:
                raise ValueError("this process is not a rank of the mesh")
            d = mesh.size(mesh.axes[0])
            if any(b % d for b in self.buckets):
                raise ValueError(f"every bucket must shard evenly over the mesh's data axis: "
                                 f"{self.buckets} over {d}")
        self._wire = _Wire(mesh) if mesh is not None and _ranks(mesh) > 1 else None
        self.front = self._wire is None or not any(mesh.coords.values())
        self.max_wait_ms = max_wait_ms
        self.device = _device_of(engine)
        self.error: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop if self.front else _follow,
                                        args=() if self.front else (self,), daemon=True,
                                        name=name)
        self._started = False
        # reusable batch buffers, 2 per bucket (round-robin matching the
        # one-deep pipeline): tail rows keep stale data instead of paying a
        # pad memcpy -- their outputs are never routed
        self._bufs = {}
        self._ring = None
        self._submit_lock = threading.Lock()
        if ring_capacity and self.front:
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
        """The front end: ends the dispatcher (and on a mesh sends the stop
        round).  Any other rank: waits for the front end's stop round, and
        raises what ended its loop if the mesh failed."""
        if not self.front:
            return _await_stop(self)
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5.0)

    def submit(self, images: np.ndarray) -> Future:
        """images: (H,W,C) or (n,H,W,C) conditioned engine input (numpy).
        Returns a Future resolving to the logits for those images (numpy)."""
        if not self.front:
            raise ValueError("submit requests to the front end, rank 0 of the mesh")
        if images.ndim == 3:
            images = images[None]
        fut: Future = Future()
        if self.error is not None:
            fut.set_exception(self.error)
            return fut
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
        engine's.  On a mesh each launch is a whole round (`_mesh_round`),
        so nothing overlaps."""
        with _on(self.device):
            pending = []  # [((host logits, event), items, valid rows, ring free point)]
            while not self._stop.is_set():
                items = self._collect(wait=not pending)
                launched = []
                if items:
                    try:
                        launched = self._launch(items)
                    except MeshError as e:  # the mesh is gone: nothing more is served
                        self.error = e
                        _fail(items, e)
                        break
                    except Exception as e:  # route errors to the waiting futures
                        _fail(items, e)
                self._drain(pending)
                pending = launched
            self._drain(pending)
            _close(self, data=True)

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
        alias the reusable buffer, so it is copied.  On a mesh: one round
        (`_mesh_round`)."""
        if self._wire is not None:
            return self._mesh_round(batch), None
        return _fetch(self.engine(self._to_engine(torch.from_numpy(batch))))

    def _to_engine(self, x: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cuda":
            return x.to(self.device, non_blocking=True)
        return x.clone()

    def _mesh_round(self, batch: np.ndarray) -> torch.Tensor:
        """One round of the padded batch over the mesh (module docstring):
        the header to every rank, each data row's slice to its leader and
        along its row, the engine on rank 0's own slice, the other rows'
        logits back in data order.  Returns the batch's logits on the host.
        An engine error anywhere raises once the round is complete; a
        transport error raises MeshError."""
        w, mesh = self._wire, self.mesh
        x = torch.from_numpy(batch)
        per = x.shape[0] // mesh.size(w.data)
        try:
            w.header(_describe(0, x[:per]))
            sends = [mesh.isend(w.put(t), w.data, d)
                     for d, t in enumerate(x.split(per)) if d]
            own = w.row(w.put(x[:per]))
            err, y = _call(self.engine, self._to_engine(own))
            failed = w.row_errors(err)
            for sent in sends:
                sent.wait()
            parts = [None if y is None else y.cpu()]
            for d in range(1, mesh.size(w.data)):
                flag, dtype, shape = _read(mesh.recv((_WORDS,), torch.int64, w.data, d,
                                                     device=w.device))
                if flag:
                    text = mesh.recv((flag,), torch.uint8, w.data, d, device=w.device)
                    failed.append(bytes(text.cpu().tolist()).decode(errors="replace"))
                else:
                    parts.append(mesh.recv(shape, dtype, w.data, d, device=w.device).cpu())
        except Exception as e:
            raise MeshError(f"the mesh's transport failed: {e!r}") from e
        if err is not None and len(failed) == 1:
            raise err
        if failed:
            raise RuntimeError("the engine failed on the mesh: " + "; ".join(failed))
        return torch.cat(parts)

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


# -- across cards ---------------------------------------------------------------

# dtypes a header can name (its code is the index)
_WIRE_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64, torch.float16,
                torch.bfloat16, torch.float32, torch.float64)
_WORDS = 8  # int64 words of a header: flag, dtype code, ndim, up to 5 dims
_ERR_BYTES = 256  # of each rank's engine error message in a row's exchange


class MeshError(RuntimeError):
    """The mesh's transport failed (a peer is gone): the server stops."""


def _ranks(mesh) -> int:
    return mesh.size(mesh.axes[0]) * mesh.size(mesh.axes[1])


def _on(device: torch.device):
    """The current CUDA device is per thread: a server's loop runs on its
    engine's."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _call(engine, x):
    """(error, None) or (None, engine(x)): an engine error is held until the
    round is complete."""
    try:
        return None, engine(x)
    except Exception as e:
        return e, None


def _describe(flag: int, t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A header: the flag, then t's dtype and shape (without t: the flag
    alone)."""
    words = [int(flag)] + [0] * (_WORDS - 1)
    if t is not None:
        if t.dim() > _WORDS - 3:
            raise ValueError(f"a header holds up to {_WORDS - 3} dims, not {t.dim()}")
        words[1:3] = _WIRE_DTYPES.index(t.dtype), t.dim()
        words[3:3 + t.dim()] = t.shape
    return torch.tensor(words, dtype=torch.int64)


def _read(words: torch.Tensor):
    """(flag, dtype, shape) of a header."""
    w = words.cpu().tolist()
    return w[0], _WIRE_DTYPES[w[1]], tuple(w[3:3 + w[2]])


class _Wire:
    """A server's traffic over a mesh, each piece one of the mesh's counted
    collectives: headers, a row's payload, a row's engine errors.  Tensors
    cross on the card under NCCL and on the host under gloo (`device`)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.data, self.model = mesh.axes
        self.lead = mesh.index(self.model) == 0
        self.device = mesh.device if mesh.backend == "nccl" else torch.device("cpu")

    def put(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def header(self, words: Optional[torch.Tensor] = None, data: bool = True):
        """Index 0's header (`words`, there) to every rank: along the
        leaders' data line (with `data`), then along each row.  Returns
        (flag, dtype, shape)."""
        t = (self.put(words) if words is not None
             else torch.empty(_WORDS, dtype=torch.int64, device=self.device))
        if data and self.lead:
            self.mesh.broadcast(t, self.data, 0)
        self.mesh.broadcast(t, self.model, 0)
        return _read(t)

    def row(self, t: Optional[torch.Tensor], shape=None, dtype=None) -> torch.Tensor:
        """The leader's payload `t` to every rank of its row (the others pass
        its shape and dtype)."""
        if t is None:
            t = torch.empty(shape, dtype=dtype, device=self.device)
        return self.mesh.broadcast(t, self.model, 0)

    def row_errors(self, err: Optional[BaseException]) -> list:
        """Every rank of the row learns which of them failed: one all-reduce
        of their messages (each rank writes its own slot).  Returns
        ["rank r: message", ...]."""
        me = self.mesh.ranks[self.model][self.mesh.index(self.model)]
        text = "" if err is None else f"rank {me}: {type(err).__name__}: {err}"
        m = self.mesh.size(self.model)
        if m == 1:
            return [text] if text else []
        buf = torch.zeros((m, _ERR_BYTES), dtype=torch.uint8)
        raw = text.encode()[:_ERR_BYTES]
        if raw:
            buf[self.mesh.index(self.model), :len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
        buf = self.mesh.all_reduce(self.put(buf), self.model).cpu()
        return [bytes(r).rstrip(b"\0").decode(errors="replace") for r in buf.tolist() if any(r)]


def _follow(server) -> None:
    """The loop of a rank that does not ingest; what ends it other than the
    stop round is kept in `server.error`."""
    with _on(server.device):
        try:
            _follow_rounds(server.engine, server.device, server._wire)
        except Exception as e:
            server.error = e


def _await_stop(server) -> None:
    """A follower's stop(): waits for the stop round; raises what ended the
    loop if the mesh failed."""
    if server._started:
        server._thread.join()
    if server.error is not None:
        raise server.error


def _close(server, data: bool) -> None:
    """The end of an ingesting rank's loop: the stop round to the ranks that
    follow it (along the data line too with `data`), or, after a mesh
    failure, every queued request failed."""
    if server._wire is not None and server.error is None:
        try:
            server._wire.header(_describe(1), data=data)
        except Exception as e:
            server.error = MeshError(f"the stop round failed: {e!r}")
    if server.error is not None:
        while True:
            try:
                _fail([server._q.get_nowait()], server.error)
            except queue.Empty:
                break


def _follow_rounds(engine, device: torch.device, wire: _Wire) -> None:
    """Round after round until the stop round: the header, the row's
    payload (a ServingEngine row leader first receives it from the front
    end), the engine on it, the row's errors; a ServingEngine row leader
    then sends the row's logits, or its errors, back to the front end."""
    mesh = wire.mesh
    report = wire.lead  # only a ServingEngine's leaders of rows > 0 follow at model 0
    while True:
        flag, dtype, shape = wire.header()
        if flag:
            return
        x = mesh.recv(shape, dtype, wire.data, 0, device=wire.device) if report else None
        x = wire.row(x, shape, dtype)
        err, y = _call(engine, x.to(device))
        failed = wire.row_errors(err)
        if not report:
            continue
        if failed:
            msg = "; ".join(failed).encode()
            sent = [mesh.isend(wire.put(_describe(len(msg))), wire.data, 0),
                    mesh.isend(wire.put(torch.tensor(list(msg), dtype=torch.uint8)), wire.data, 0)]
        else:
            y = wire.put(y)
            sent = [mesh.isend(wire.put(_describe(0, y)), wire.data, 0),
                    mesh.isend(y, wire.data, 0)]
        for s in sent:
            s.wait()


class CrossHostServingEngine:
    """Cross-host continuous batching over a mesh of processes (the port of
    `f8net_tpu/engine/serve.py:432-691`, "the north-star serving story").

    A host of the reference is a data row of the mesh; its leader (model
    index 0; every rank where the model axis has one) runs an ingestion
    queue of its own, and the other ranks of the row follow it.  The
    dispatcher runs in lockstep rounds: every `tick_ms` each leader
    coalesces up to `global_batch / rows` of its own requests, the leaders
    agree on the round's bucket by one all-reduce of each row's (queue
    depth, stop flag) along their data line (the reference's jitted reduce
    of a sharded array), the leader pads its shard to the bucket's per-row
    size and broadcasts it along its row, and every rank of the row runs
    the engine on it: a `TPEngine` shard, or an `IntEngine` replica.  An
    idle leader contributes padding rows, which keeps the rounds matched.
    Each leader routes its own rows' logits to its futures.

    Without processes (torch.distributed not initialised, or a 1x1 mesh)
    it is single-host continuous batching, as the reference at
    process_count == 1."""

    def __init__(
        self,
        engine,
        mesh,
        global_batch: Optional[int] = None,
        tick_ms: float = 5.0,
        image_shape=None,
        image_dtype=np.uint8,
        buckets=None,
        prewarm: bool = False,
        name: str = "f8net-xhost-serving",
    ):
        """buckets: optional ascending global batch-size ladder (each a
        multiple of the mesh's data axis).  Every round the leaders agree on
        one bucket by the coordination all-reduce: the smallest that holds
        the global demand and every row's depth, so idle or low-load ticks
        run the smallest batch.  image_shape: the row shape, required with
        more than one data row (an idle leader pads rows it never saw);
        prewarm: run every bucket once on padding before serving (needs
        image_shape; every rank runs the same sequence)."""
        if not mesh.member:
            raise ValueError("this process is not a rank of the mesh")
        hosts = mesh.size(mesh.axes[0])
        if buckets:
            buckets = tuple(sorted(set(int(b) for b in buckets)))
            if global_batch is not None and global_batch != buckets[-1]:
                raise ValueError("pass the batch via buckets (largest bucket) or keep them equal")
            global_batch = buckets[-1]
        global_batch = global_batch or 64
        self.buckets = buckets or (global_batch,)
        if any(b % hosts for b in self.buckets):
            raise ValueError(f"every bucket must split over the {hosts} data rows: {self.buckets}")
        if hosts > 1 and image_shape is None:
            raise ValueError("serving over several data rows needs image_shape up front")
        if prewarm and image_shape is None:
            raise ValueError("prewarm needs image_shape")
        self.image_shape = tuple(image_shape) if image_shape is not None else None
        self.image_dtype = image_dtype
        self.engine = engine
        self.mesh = mesh
        self.hosts = hosts
        self.global_batch = global_batch
        self.per_host = global_batch // hosts
        self.tick_ms = tick_ms
        self.prewarm = prewarm
        self.device = _device_of(engine)
        self._wire = _Wire(mesh) if _ranks(mesh) > 1 else None
        self.leader = self._wire is None or self._wire.lead
        self.error: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop if self.leader else _follow,
                                        args=() if self.leader else (self,), daemon=True,
                                        name=name)
        self._started = False
        self.stats = {
            "batches": 0, "images": 0, "padded": 0, "idle_rounds": 0,
            "bucket_hits": {}, "coord_ticks": 0, "coord_s": 0.0,
        }

    def start(self):
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def stop(self):
        """A leader: stops ingesting; its loop keeps ticking padding rounds
        until every leader has stopped, then sends its row the stop round.
        Any other rank: waits for that stop round (and raises what ended
        its loop if the mesh failed)."""
        if not self.leader:
            return _await_stop(self)
        self._stop.set()
        if self._started:
            self._thread.join(timeout=10.0)

    def submit(self, images: np.ndarray) -> Future:
        if not self.leader:
            raise ValueError("submit requests to a data row's leader (model index 0)")
        if images.ndim == 3:
            images = images[None]
        if images.shape[0] > self.per_host:
            raise ValueError(f"a request of {images.shape[0]} images exceeds the per-host "
                             f"shard of {self.per_host}")
        if self.image_shape is not None and tuple(images.shape[1:]) != self.image_shape:
            raise ValueError(f"row shape {images.shape[1:]} is not the declared "
                             f"{self.image_shape}: one shape keeps the rounds matched")
        fut: Future = Future()
        if self.error is not None:
            fut.set_exception(self.error)
            return fut
        self._q.put((images, fut))
        return fut

    def infer(self, images: np.ndarray, timeout: Optional[float] = 60.0):
        return self.submit(images).result(timeout)

    def _collect(self):
        items, n = [], 0
        deadline = time.perf_counter() + self.tick_ms / 1e3
        while n < self.per_host:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if n + item[0].shape[0] > self.per_host:
                # keep shapes static: defer to the next round
                self._q.put(item)
                break
            items.append(item)
            n += item[0].shape[0]
        return items, n

    def _coord(self, n_local: int, stopping: bool):
        """The coordination collective: (total depth, deepest row, all
        stopped), the same on every leader.  Each row writes its (depth,
        stop) pair into its own slots of a 2 x rows int32 vector, summed
        along the leaders' data line."""
        mesh = self.mesh
        v = torch.zeros(2 * self.hosts, dtype=torch.int32)
        h = mesh.index(mesh.axes[0])
        v[2 * h], v[2 * h + 1] = n_local, int(stopping)
        if self._wire is not None:
            v = mesh.all_reduce(self._wire.put(v), mesh.axes[0]).cpu()
        depth = v[0::2]
        return int(depth.sum()), int(depth.max()), bool((v[1::2] == 1).all())

    def _pick_bucket(self, total: int, max_host: int, nproc: int) -> int:
        for b in self.buckets:
            if b >= total and b // nproc >= max_host:
                return b
        return self.buckets[-1]

    def _forward(self, local: np.ndarray):
        """The round's shard along the row and the engine on it: (host
        logits, event) for `_drain`.  An engine error anywhere in the row
        raises once every rank of it has finished; a transport error raises
        MeshError."""
        x = torch.from_numpy(local)
        err = None
        if self._wire is None:
            err, y = _call(self.engine, x.to(self.device))
            failed = [str(err)] if err is not None else []
        else:
            w = self._wire
            try:
                w.header(_describe(0, x), data=False)
                err, y = _call(self.engine, w.row(w.put(x)).to(self.device))
                failed = w.row_errors(err)
            except Exception as e:
                raise MeshError(f"the mesh's transport failed: {e!r}") from e
        if err is not None and len(failed) == 1:
            raise err
        if failed:
            raise RuntimeError("the engine failed on the row: " + "; ".join(failed))
        return _fetch(y)

    def _loop(self):
        with _on(self.device):
            pending = []  # [((host logits, event), items, valid rows)]: one-deep pipeline
            try:
                pending = self._rounds(pending)
            except MeshError as e:
                self.error = e
            self._drain(pending)
            _close(self, data=False)

    def _rounds(self, pending):
        shape, dtype = self.image_shape, self.image_dtype
        nproc = self.hosts
        # several rows always coordinate (bucket agreement, collective
        # shutdown); one row coordinates only to pick among buckets
        coordinated = nproc > 1 or len(self.buckets) > 1
        if self.prewarm:
            for b in self.buckets:
                host, done = self._forward(np.zeros((b // nproc,) + tuple(shape), dtype))
                if done is not None:
                    done.synchronize()
            self.stats["prewarmed"] = list(self.buckets)
        while True:
            stopping = self._stop.is_set()
            if stopping and not coordinated:
                return pending
            items, n = ([], 0) if stopping else self._collect()
            if shape is None and not items:
                # one row may learn the shape from its first request; skip
                # empty rounds until then
                self._drain(pending)
                pending = []
                continue
            if items:
                shape, dtype = items[0][0].shape[1:], items[0][0].dtype
            if coordinated:
                t0 = time.perf_counter()
                try:
                    total, max_host, all_stopped = self._coord(n, stopping)
                except Exception as e:
                    _fail(items, e)
                    raise MeshError(f"the coordination failed: {e!r}") from e
                dt = time.perf_counter() - t0
                self.stats["coord_s"] += dt
                self.stats["coord_ticks"] += 1
                if self.stats["coord_ticks"] > 3:  # steady state: past the first ticks
                    self.stats["coord_s_steady"] = self.stats.get("coord_s_steady", 0.0) + dt
                    self.stats["coord_ticks_steady"] = self.stats.get("coord_ticks_steady", 0) + 1
                if all_stopped:
                    return pending
                bucket = self._pick_bucket(total, max_host, nproc)
            else:
                bucket = self.buckets[-1]
            per = bucket // nproc
            local = np.zeros((per,) + tuple(shape), dtype)
            row = 0
            for arr, _ in items:
                local[row:row + arr.shape[0]] = arr
                row += arr.shape[0]
            self.stats["padded"] += per - n
            if not items:
                self.stats["idle_rounds"] += 1
            else:
                self.stats["bucket_hits"][bucket] = self.stats["bucket_hits"].get(bucket, 0) + 1
            launched = []
            try:
                logits = self._forward(local)
                launched = [(logits, items, n)] if items else []
            except MeshError as e:
                _fail(items, e)
                raise
            except Exception as e:
                _fail(items, e)
            self._drain(pending)
            pending = launched

    def _drain(self, pending):
        """Route each launched round's own rows (the port of `_local_rows`:
        a leader's logits are its rows alone)."""
        for (logits, done), its, valid in pending:
            try:
                rows = logits.numpy()
                if done is not None:
                    done.synchronize()
                    rows = rows.copy()  # routed rows must not hold the pinned block
                _route_rows(self.stats, rows, its, valid)
            except Exception as e:
                _fail(its, e)
