"""Input pipeline: ImageFolder datasets with the reference's transforms (the
port of `f8net_tpu/data/pipeline.py`, its PIL path).

Parity with the reference's torchvision pipelines (fix_train.py:299-415):
  train: RandomResizedCrop(224) + RandomHorizontalFlip
  eval : Resize(256) + CenterCrop(224)
  normalize: conditional -- the unnormalized mode keeps inputs in [0,1] for
  the fixed-point head (mean 0 / std 1), normalized mode uses ImageNet
  mean/std (fix_train.py:302-307).

A threaded prefetch loader yields numpy NHWC float32 batches, which the
trainer moves to the device.  It takes the reference's paths, chosen as
the reference chooses them (`f8net_tpu/data/pipeline.py:250-266`):
  native_jpeg  the file's bytes decoded by libjpeg on native threads
               (`native.c_decode_jpeg_batch`, without the GIL; PIL for an
               image it rejects), then crop, resize, flip and normalize in
               C++ (`native.c_train_preprocess_batch` /
               `c_eval_preprocess_batch`): where the native library built
               with libjpeg and the dataset has `load_bytes`;
  native       PIL decodes, C++ resizes: where the library built without
               libjpeg, or for a dataset of PIL images;
  pil          PIL and numpy throughout: where the library cannot be built.
`Loader.path` says which one its last iteration took.  Every path gives
the reference's batches bit for bit on the same inputs.  For multi-process
training each process takes a strided index shard, the analog of
DistributedSampler (fix_train.py:374-379).
"""

from __future__ import annotations

import os
import queue
import random
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native

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


def train_transform(img, rng: random.Random, size: int = 224, normalize: bool = False):
    """RandomResizedCrop(size) + HFlip (the crop sampled as the native path
    samples it; PIL applies the crop, resize and flip)."""
    w, h = img.size
    y0, x0, ch, cw, flip = sample_crop(w, h, rng)
    img = img.crop((x0, y0, x0 + cw, y0 + ch))
    img = img.resize((size, size), Image.BILINEAR)
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return _to_array(img, normalize)


def eval_transform(img, size: int = 224, resize: int = 256, normalize: bool = False):
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

    def load_bytes(self, idx: int) -> Tuple[bytes, int]:
        """The file's bytes (the native JPEG decode reads these)."""
        path, label = self.samples[idx]
        with open(path, "rb") as f:
            return f.read(), label


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

    shard/num_shards implement per-process data sharding; seed+epoch drive
    the shuffle so all processes agree on the permutation (the
    sampler.set_epoch pattern, fix_train.py:743).  aug_seed (default: seed)
    seeds the augmentation stream (crops, flips) alone, so that processes
    can draw different augmentations of one shared permutation.
    decode_threads: native JPEG decode threads per worker (default: the
    cores over the workers).
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
        decode_threads: int = 0,
        aug_seed: Optional[int] = None,
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
        self.aug_seed = seed if aug_seed is None else aug_seed
        # the decode releases the GIL: workers x decode_threads should about
        # cover the cores, not each worker take all of them
        self.decode_threads = decode_threads or max(1, (os.cpu_count() or 4) // self.workers)
        self.epoch = 0
        self.path: Optional[str] = None  # the path of the last iteration

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

    @property
    def _resize(self) -> int:
        # the eval resize scales with the crop (256 for the reference's 224)
        return int(self.image_size * 256 / 224)

    def choose_path(self) -> str:
        """'native_jpeg', 'native' or 'pil' (module docstring)."""
        if not native.imageops_available():
            return "pil"
        if native.jpeg_available() and hasattr(self.ds, "load_bytes"):
            return "native_jpeg"
        return "native"

    def _load_one(self, i: int, rng: random.Random):
        img, label = self.ds.load(i)
        if self.train:
            a = train_transform(img, rng, self.image_size, self.normalize)
        else:
            a = eval_transform(img, self.image_size, resize=self._resize,
                               normalize=self.normalize)
        return a, label

    def _jpeg_raws(self, batch, labels, rng):
        """Decode a batch natively (`f8net_tpu/data/pipeline.py:272-318`):
        (images, crop boxes, flips), the boxes and flips for training only;
        PIL decodes any image the native decoder rejects."""
        blobs = []
        for j, i in enumerate(batch):
            b, labels[j] = self.ds.load_bytes(int(i))
            blobs.append(b)
        dims = native.c_jpeg_dims_batch(blobs)
        boxes, flips = [], []
        if self.train:
            for j, (w0, h0, ok) in enumerate(dims):
                if not ok:  # PIL knows the true size
                    w0, h0 = self.ds.load(int(batch[j]))[0].size
                y0, x0, ch, cw, fl = sample_crop(w0, h0, rng)
                boxes.append((y0, x0, ch, cw))
                flips.append(1 if fl else 0)
        # a full-scale decode: the dims just parsed are the output's
        outs = native.c_decode_jpeg_batch(blobs, num_threads=self.decode_threads, dims=dims)
        raws = [arr if arr is not None  # else PIL decodes it
                else np.asarray(self.ds.load(int(i))[0].convert("RGB"), np.uint8)
                for i, arr in zip(batch, outs)]
        return raws, boxes, flips

    def _pil_raws(self, batch, labels, rng):
        """PIL decodes a batch for the native resize (`f8net_tpu/data/
        pipeline.py:334-344`, `:362-381`): (images, crop boxes, flips)."""
        raws, boxes, flips = [], [], []
        for j, i in enumerate(batch):
            img, labels[j] = self.ds.load(int(i))
            raws.append(np.asarray(img.convert("RGB"), np.uint8))
            if self.train:
                y0, x0, ch, cw, fl = sample_crop(*img.size, rng)
                boxes.append((y0, x0, ch, cw))
                flips.append(1 if fl else 0)
        return raws, boxes, flips

    def _native_batch(self, batch, labels, rng, jpeg: bool) -> np.ndarray:
        raws, boxes, flips = (self._jpeg_raws if jpeg else self._pil_raws)(batch, labels, rng)
        mean = IMAGENET_MEAN if self.normalize else None
        std = IMAGENET_STD if self.normalize else None
        if self.train:
            return native.c_train_preprocess_batch(
                raws, np.asarray(boxes, np.int32), np.asarray(flips, np.uint8),
                self.image_size, mean=mean, std=std, num_threads=2)
        return native.c_eval_preprocess_batch(raws, resize=self._resize, size=self.image_size,
                                              mean=mean, std=std, num_threads=2)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        indices = list(self._indices())
        out_q: "queue.Queue" = queue.Queue(maxsize=self.workers * 2)
        batches = [indices[i : i + self.bs] for i in range(0, len(indices), self.bs)]
        self.path = path = self.choose_path()

        stop = threading.Event()

        def worker(worker_id: int):
            rng = random.Random(self.aug_seed * 1000003 + self.epoch * 97 + worker_id)
            try:
                for bi in range(worker_id, len(batches), self.workers):
                    if stop.is_set():
                        return
                    batch = batches[bi]
                    labels = np.empty((len(batch),), np.int32)
                    if path == "pil":
                        imgs = np.empty((len(batch), self.image_size, self.image_size, 3),
                                        np.float32)
                        for j, i in enumerate(batch):
                            imgs[j], labels[j] = self._load_one(int(i), rng)
                    else:
                        imgs = self._native_batch(batch, labels, rng, path == "native_jpeg")
                    out_q.put((bi, imgs, labels))
            except Exception as e:  # handed to the consumer, which raises it
                out_q.put((None, worker_id, e))
                return
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
                    if labels is not None:
                        raise RuntimeError(f"Loader worker {imgs} failed") from labels
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
