"""Image datasets and host-side batching (port of
``vqvae2_tpu/data/datasets.py``).

The host assembles one batch as a numpy array ``(B, H, W, C)`` — the layout of
every public function of this package — and the caller moves it to the card,
raw ``uint8`` where the dataset allows it: :func:`to_unit_device` normalizes on
the device.  A background thread keeps host preprocessing off the device's
critical path.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def normalize_to_unit(img: np.ndarray) -> np.ndarray:
    """uint8 HWC → float32 in [-1, 1]."""
    return img.astype(np.float32) / 127.5 - 1.0


def to_unit_device(x, device="cuda"):
    """Move a host batch to ``device`` and normalize there: uint8 → float32 in
    [-1, 1]; float passes through.  Shipping raw uint8 pixels is a quarter of
    the host→device traffic of pre-normalized fp32."""
    import torch

    from vqvae2_tpu_torch import resolve_device

    x = torch.as_tensor(x).to(resolve_device(device))
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 127.5 - 1.0
    return x


class ImageFileDataset:
    """Recursively indexes an image directory; items are (img, class_idx,
    relpath): the image, the index of its sub-directory and its file name, which
    code extraction stores beside the codes."""

    def __init__(self, root: str, size: int = 256, raw: bool = False):
        self.root = os.path.abspath(root)
        self.size = size
        self.raw = raw  # True → items stay uint8 (normalize on device)
        self.samples: List[Tuple[str, int]] = []
        classes = {}
        for dirpath, _, names in sorted(os.walk(self.root)):
            for n in sorted(names):
                if n.lower().endswith(IMG_EXTS):
                    cls = os.path.relpath(dirpath, self.root)
                    cls_idx = classes.setdefault(cls, len(classes))
                    self.samples.append((os.path.join(dirpath, n), cls_idx))
        self.num_classes = len(classes)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int):
        from PIL import Image

        path, cls = self.samples[i]
        img = Image.open(path).convert("RGB")
        # torchvision Resize(size) + CenterCrop(size) equivalent
        w, h = img.size
        scale = self.size / min(w, h)
        img = img.resize((max(self.size, round(w * scale)),
                          max(self.size, round(h * scale))))
        w, h = img.size
        left, top = (w - self.size) // 2, (h - self.size) // 2
        img = img.crop((left, top, left + self.size, top + self.size))
        arr = np.asarray(img, dtype=np.uint8)
        if not self.raw:
            arr = normalize_to_unit(arr)
        rel = os.path.relpath(path, self.root)
        return arr, cls, rel


class SyntheticImages:
    """Deterministic synthetic image set for smoke tests / benchmarks."""

    def __init__(self, n: int = 256, size: int = 256, channels: int = 3, seed: int = 0):
        self.n, self.size, self.channels, self.seed = n, size, channels, seed
        self.num_classes = 1

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self.seed * 100003 + i)
        img = rng.normal(scale=0.5, size=(self.size, self.size, self.channels))
        return img.astype(np.float32), 0, f"synthetic/{i}.png"


def iterate_batches(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    prefetch: int = 2,
    epochs: Optional[int] = 1,
    workers: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray, List[str]]]:
    """Threaded global-batch iterator yielding (imgs NHWC, labels, paths).

    ``workers`` > 0 decodes items through a thread pool (PIL decode and the
    numpy resize release the GIL); with one producer thread this overlaps host
    decode with the device's work.

    ``workers`` > 0 requires ``dataset.__getitem__`` to be deterministic per
    index (every dataset here is; ``ShapesDataset`` seeds per index).  A
    dataset drawing augmentations from a *shared* RNG would see thread-order-
    dependent draws — give such datasets a per-index ``SeedSequence`` (the
    ``data/shapes.py`` pattern) or run them with ``workers=0``."""

    done = threading.Event()     # the consumer stopped: the producer must too

    def put(q: queue.Queue, item) -> bool:
        while not done.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer(q: queue.Queue, pool):
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.random.default_rng(seed + epoch).permutation(len(dataset)) \
                if shuffle else np.arange(len(dataset))
            end = len(order) - (len(order) % batch_size if drop_last else 0)
            for s in range(0, end, batch_size):
                idx = order[s : s + batch_size]
                if len(idx) < batch_size and drop_last:
                    break
                if done.is_set():
                    return
                if pool is not None:
                    try:
                        items = list(pool.map(dataset.__getitem__,
                                              [int(i) for i in idx]))
                    except RuntimeError:
                        if done.is_set():      # the pool was shut down under us
                            return
                        raise
                else:
                    items = [dataset[int(i)] for i in idx]
                imgs = np.stack([it[0] for it in items])
                labels = np.asarray([it[1] for it in items], np.int32)
                paths = [it[2] for it in items]
                if not put(q, (imgs, labels, paths)):
                    return
            epoch += 1
        put(q, None)

    pool = None
    if workers:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=workers)
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    t = threading.Thread(target=producer, args=(q, pool), daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            yield item
    finally:
        done.set()
        if pool is not None:
            pool.shutdown(wait=False)


def prefetch_iter(make_iter, depth: int = 2):
    """Run any batch-producing iterable in a background thread with a bounded
    queue, so host-side collation (augmentation, numpy stacking) overlaps the
    device's work.  ``make_iter`` is a zero-argument callable returning the
    iterable, so the work happens on the producer thread.  An error of the
    producer is raised to the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: List[BaseException] = []
    done = threading.Event()     # the consumer stopped: the producer must too

    def put(item) -> bool:
        while not done.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for item in make_iter():
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        done.set()


def epoch_row_batches(dataset, loader_batch: int, depth: int = 2):
    """Prefetched sequential row batches for one epoch of an identity-sampled
    dataset (call after ``samplize()``): ``[dataset[i], ...]`` lists of
    ``loader_batch`` rows for each full window, gathered on one background
    thread, so the augmentations draw from the dataset's generator in the same
    order as inline gathering would."""

    def gen():
        for s in range(0, len(dataset) - loader_batch + 1, loader_batch):
            yield [dataset[int(i)] for i in range(s, s + loader_batch)]

    return prefetch_iter(gen, depth=depth)
