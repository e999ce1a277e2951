"""Input pipeline: ImageFolder datasets with the reference's transforms (the
port of `f8net_tpu/data/pipeline.py`, its PIL path).

Parity with the reference's torchvision pipelines (fix_train.py:299-415):
  train: RandomResizedCrop(224) + RandomHorizontalFlip
  eval : Resize(256) + CenterCrop(224)
  normalize: conditional -- the unnormalized mode keeps inputs in [0,1] for
  the fixed-point head (mean 0 / std 1), normalized mode uses ImageNet
  mean/std (fix_train.py:302-307).

Implemented on PIL + numpy with a threaded prefetch loader; batches are
numpy NHWC float32, which the trainer moves to the device.  For multi-host
training each process takes a strided index shard, the analog of
DistributedSampler (fix_train.py:374-379).  The reference's native decode
and resize path (`f8net_tpu/native`) is not ported: every batch here is
the reference's PIL path, bit for bit.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from typing import Iterator, List, Sequence, Tuple

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp")


def sample_crop(w: int, h: int, rng: random.Random):
    """RandomResizedCrop sampling, torchvision semantics (scale [0.08, 1],
    log-uniform ratio [3/4, 4/3]).  Returns (y0, x0, ch, cw, flip)."""
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        log_ratio = (np.log(3 / 4), np.log(4 / 3))
        ratio = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * ratio)))
        ch = int(round(np.sqrt(target_area / ratio)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.randint(0, w - cw)
            y0 = rng.randint(0, h - ch)
            break
    else:  # center fallback
        s = min(w, h)
        y0, x0, ch, cw = (h - s) // 2, (w - s) // 2, s, s
    flip = rng.random() < 0.5
    return y0, x0, ch, cw, flip


def train_transform(
    img,
    rng: random.Random,
    size: int = 224,
    normalize: bool = False,
):
    """RandomResizedCrop(size) + HFlip (PIL applies the crop/resize/flip)."""
    w, h = img.size
    y0, x0, ch, cw, flip = sample_crop(w, h, rng)
    img = img.crop((x0, y0, x0 + cw, y0 + ch))
    img = img.resize((size, size), Image.BILINEAR)
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return _to_array(img, normalize)


def eval_transform(
    img,
    size: int = 224,
    resize: int = 256,
    normalize: bool = False,
):
    """Resize(shorter side -> resize) + CenterCrop(size)."""
    w, h = img.size
    if w < h:
        nw, nh = resize, max(1, int(round(h * resize / w)))
    else:
        nw, nh = max(1, int(round(w * resize / h))), resize
    img = img.resize((nw, nh), Image.BILINEAR)
    x0, y0 = (nw - size) // 2, (nh - size) // 2
    img = img.crop((x0, y0, x0 + size, y0 + size))
    return _to_array(img, normalize)


def _to_array(img, normalize: bool) -> np.ndarray:
    a = np.asarray(img.convert("RGB"), np.float32) / 255.0  # HWC in [0,1]
    if normalize:
        a = (a - IMAGENET_MEAN) / IMAGENET_STD
    return a


class ImageFolderDataset:
    """class-per-subdirectory layout, like torchvision ImageFolder."""

    def __init__(self, root: str):
        self.root = root
        self.classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(_EXTS):
                    self.samples.append((os.path.join(cdir, fn), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def load(self, idx: int):
        path, label = self.samples[idx]
        return Image.open(path), label


class SyntheticDataset:
    """Deterministic random images; for tests and throughput benches."""

    def __init__(self, n: int = 256, size: int = 224, classes: int = 1000, seed: int = 0):
        self.n, self.size, self.classes, self.seed = n, size, classes, seed

    def __len__(self):
        return self.n

    def load(self, idx: int):
        rng = np.random.RandomState(self.seed + idx)
        arr = rng.randint(0, 256, (self.size, self.size, 3), np.uint8)
        return Image.fromarray(arr), int(rng.randint(self.classes))


class Loader:
    """Threaded prefetch loader yielding (images NHWC float32, labels int32).

    shard/num_shards implement per-host data sharding; seed+epoch drive the
    shuffle so all hosts agree on the permutation (the sampler.set_epoch
    pattern, fix_train.py:743).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        train: bool = True,
        normalize: bool = False,
        image_size: int = 224,
        shard: int = 0,
        num_shards: int = 1,
        num_workers: int = 4,
        seed: int = 0,
    ):
        self.ds = dataset
        self.bs = batch_size
        self.train = train
        self.normalize = normalize
        self.image_size = image_size
        self.shard = shard
        self.num_shards = num_shards
        self.workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return (len(self._indices()) + self.bs - 1) // self.bs

    def _indices(self) -> Sequence[int]:
        idx = np.arange(len(self.ds))
        if self.train:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.shard :: self.num_shards]

    def _load_one(self, i: int, rng: random.Random):
        img, label = self.ds.load(i)
        if self.train:
            a = train_transform(img, rng, self.image_size, self.normalize)
        else:
            # shorter-side resize scales with crop size (256 for the
            # reference's 224 crops)
            a = eval_transform(
                img,
                self.image_size,
                resize=int(self.image_size * 256 / 224),
                normalize=self.normalize,
            )
        return a, label

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        indices = list(self._indices())
        out_q: "queue.Queue" = queue.Queue(maxsize=self.workers * 2)
        batches = [indices[i : i + self.bs] for i in range(0, len(indices), self.bs)]

        stop = threading.Event()

        def worker(worker_id: int):
            rng = random.Random(self.seed * 1000003 + self.epoch * 97 + worker_id)
            for bi in range(worker_id, len(batches), self.workers):
                if stop.is_set():
                    return
                batch = batches[bi]
                labels = np.empty((len(batch),), np.int32)
                imgs = np.empty((len(batch), self.image_size, self.image_size, 3), np.float32)
                for j, i in enumerate(batch):
                    imgs[j], labels[j] = self._load_one(int(i), rng)
                out_q.put((bi, imgs, labels))
            out_q.put((None, worker_id, None))

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.workers)
        ]
        for t in threads:
            t.start()
        done = 0
        pending = {}
        next_bi = 0
        try:
            while done < self.workers or pending or next_bi < len(batches):
                bi, imgs, labels = out_q.get()
                if bi is None:
                    done += 1
                    if done == self.workers and next_bi >= len(batches):
                        break
                    continue
                pending[bi] = (imgs, labels)
                while next_bi in pending:
                    yield pending.pop(next_bi)
                    next_bi += 1
        finally:
            # a consumer that stops early (finetune_iters) leaves workers
            # blocked on a full queue: drain it until they have returned
            stop.set()
            while any(t.is_alive() for t in threads):
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass
            for t in threads:
                t.join()
