"""Checkpoint save/resume (the port of `f8net_tpu/train/checkpoint.py`).

Same contract and the same files as the reference: `latest_checkpoint`
holds model params+state, optimizer buffers, last epoch, best val error;
`best_model` holds the model only; auto-resume restores the scheduler
position from the stored epoch.  Format: a single .npz of flattened
'/'-joined keys plus a JSON sidecar, written under a temporary name and
renamed into place.  A checkpoint either package writes loads into the
other; `load_checkpoint` returns numpy trees, which
`export.qat_from_numpy` / `export.tensors_from_numpy` put on a device.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _host_copy(leaf) -> np.ndarray:
    """A numpy array that owns its data: a tensor is copied off its device
    (a CPU tensor too), so that no later in-place update reaches it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(prefix: str, tree, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}" if prefix else k, v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}/{i}", v, out)
    else:
        out[prefix] = _host_copy(tree)


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def flatten_trees(trees: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Named trees (dicts of tensors or arrays) -> {'/'-joined key: host
    array}, every array a copy."""
    flat: Dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        _flatten(name, tree, flat)
    return flat


def _write(path: str, flat: Dict[str, np.ndarray], meta: dict):
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def save_checkpoint(path: str, trees: Dict[str, Any], meta: Optional[dict] = None):
    """trees: named trees, e.g. {'params': ..., 'state': ..., 'opt_momentum':
    ...}.  Returns the npz path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    final = path if path.endswith(".npz") else path + ".npz"
    _write(final, flatten_trees(trees), meta or {})
    return final


class AsyncCheckpointer:
    """Non-blocking checkpoint writes.

    `save()` copies every tensor to the host before it returns (so the next
    in-place SGD step cannot reach a queued save) and hands serialization
    and the atomic rename to a worker thread.  A new save for the same path
    supersedes any queued-but-unstarted one.  A worker's error is raised by
    the next `save()` or `wait()`.  `wait()` blocks until all pending writes
    are durable (call before exit / eval-of-file)."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._pending: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            path, flat, meta, ticket = item
            try:
                with self._lock:
                    stale = self._pending.get(path, 0) > ticket
                if not stale:
                    _write(path, flat, meta)
            except BaseException as e:  # surfaced on next save()/wait()
                with self._lock:
                    self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, path: str, trees: Dict[str, Any], meta: Optional[dict] = None) -> str:
        self._raise_pending()
        if not path.endswith(".npz"):
            path = path + ".npz"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        flat = flatten_trees(trees)
        with self._lock:
            ticket = self._pending.get(path, 0) + 1
            self._pending[path] = ticket
        self._q.put((path, flat, meta or {}, ticket))
        return path

    def wait(self):
        self._q.join()
        self._raise_pending()

    def close(self):
        self.wait()
        self._q.put(None)
        self._worker.join()


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], dict]:
    """(numpy trees, meta) of a checkpoint either package wrote."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return _unflatten(flat), meta
