"""Input pipeline (counterpart of arco_tpu/data/pipeline.py): host batching
threads and a prefetch to the device.

``TwoStreamPipeline`` is the JAX package's, copied: a background thread
assembles numpy batches (file read + host transform) while the device
computes. ``Prefetcher`` keeps ``depth`` batches in flight on the device:
each array goes to pinned host memory and is copied with
``non_blocking=True``, so the copy overlaps the step queued before it and
the host does not wait for the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class Prefetcher:
    """Wrap an iterator of dicts of numpy arrays; yield dicts of tensors on
    ``device``, ``depth`` batches ahead."""

    def __init__(self, it: Iterator, device, depth: int = 2):
        self.it = it
        self.device = torch.device(device)
        self.depth = depth
        self.buf = []

    def _put(self, batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def __iter__(self):
        for batch in self.it:
            self.buf.append(self._put(batch))
            if len(self.buf) >= self.depth:
                yield self.buf.pop(0)
        while self.buf:
            yield self.buf.pop(0)


def nchw_batches(batches):
    """A host pipeline's batches with channels-first images (NCHW or
    NCDHW), for the Prefetcher."""
    for b in batches:
        yield {"image_l": np.moveaxis(b["image_l"], -1, 1),
               "label_l": b["label_l"],
               "image_u": np.moveaxis(b["image_u"], -1, 1)}


class TwoStreamPipeline:
    """Endless (labeled, unlabeled) batch pairs for the ARCO stage.

    Each ``next()`` returns a dict with image_l/label_l/image_u/label_u numpy
    arrays (images [B, H, W, 1]). Batch assembly runs in a worker thread.

    ``labeled_bs`` mirrors the reference's --labeled_bs split
    (train_arco_2d.py:35-36): ``batch_size`` is the TOTAL per-step batch, of
    which ``labeled_bs`` samples are labeled and the rest unlabeled. When
    ``labeled_bs`` is None both streams get ``batch_size`` samples.
    """

    def __init__(self, dataset_l, dataset_u, batch_size: int, seed: int = 0,
                 queue_depth: int = 4, workers: int = 1,
                 labeled_bs: int = None):
        self.dataset_l = dataset_l
        self.dataset_u = dataset_u
        self.batch_size = batch_size
        if labeled_bs is None:
            self.bs_l = self.bs_u = batch_size
        else:
            if not 0 < labeled_bs < batch_size:
                raise ValueError(
                    f"labeled_bs ({labeled_bs}) must be in (0, batch_size="
                    f"{batch_size})")
            self.bs_l = labeled_bs
            self.bs_u = batch_size - labeled_bs
        self.seed = seed
        self.q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self.threads = [threading.Thread(target=self._worker, args=(w,),
                                         daemon=True)
                        for w in range(workers)]
        for t in self.threads:
            t.start()

    def _assemble(self, dataset, idxs, rng):
        samples = [dataset.get(i, rng) for i in idxs]
        return (np.stack([s["image"] for s in samples]),
                np.stack([s["label"] for s in samples]))

    def _worker(self, wid: int):
        rng = np.random.RandomState(self.seed + 1000 * wid)
        n_l, n_u = len(self.dataset_l), len(self.dataset_u)
        while not self._stop.is_set():
            li = rng.randint(0, n_l, size=self.bs_l)
            ui = rng.randint(0, n_u, size=self.bs_u)
            img_l, lab_l = self._assemble(self.dataset_l, li, rng)
            img_u, lab_u = self._assemble(self.dataset_u, ui, rng)
            batch = {"image_l": img_l, "label_l": lab_l,
                     "image_u": img_u, "label_u": lab_u}
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        for t in self.threads:
            t.join(timeout=10.0)
