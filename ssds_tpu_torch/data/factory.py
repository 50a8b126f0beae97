"""Dataset factory and the host input pipeline.

Counterpart of :mod:`ssds_tpu.data.factory` (reference
``lib/dataset/dataset_factory.py``): ``load_data(cfg.DATASET, phase)`` picks
TRAIN_SETS or TEST_SETS, builds ``preproc(IMAGE_SIZE, PIXEL_MEANS, PROB)``
(PROB = -1 outside training) and wraps the dataset in a loader whose
``detection_collate`` pads every image's targets to ``MAX_GT`` rows with a
validity mask, so each phase runs at one batch shape.

- Worker processes are forked, as torch's ``DataLoader`` forks them: the
  augmentation's numpy/Python parts hold the GIL, so threads cannot spread
  it. The workers run the dataset and numpy only; they never touch CUDA.
  At most two batches a worker are in flight; :meth:`DetectionLoader.close`
  waits for those, then ends the workers (``Pool.terminate`` deadlocks when
  a worker is still writing a batch into the result pipe: the pool stops
  reading it first).
- Train batches drop the last partial batch; eval batches pad the last one
  by wrapping around and the eval keeps the true image count.
- ``dataset_map`` holds ``voc`` (:class:`~ssds_tpu_torch.data.voc.VOCDetection`)
  and ``coco`` (:class:`~ssds_tpu_torch.data.coco.COCODetection`), as the
  JAX package's.
"""

from __future__ import annotations

import collections
import itertools
import os
import random
import sys
import time
from typing import Iterator

import numpy as np

from ssds_tpu_torch.data.augment import preproc
from ssds_tpu_torch.data.coco import COCODetection
from ssds_tpu_torch.data.voc import VOCDetection

dataset_map = {"voc": VOCDetection, "coco": COCODetection}


def detection_collate(samples, max_gt: int) -> dict:
    """Stack images (uint8 kept) and pad targets to ``[B, max_gt]`` with a
    validity mask; ``sizes`` are the original ``(h, w)`` when given."""
    images = np.stack([s[0] for s in samples])
    b = len(samples)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    sizes = np.zeros((b, 2), np.int32)
    for i, sample in enumerate(samples):
        if len(sample) > 2:
            sizes[i] = sample[2]
        t = np.asarray(sample[1], np.float32).reshape(-1, 5)
        # an all-zero single row is preproc's "no GT" sentinel
        if not (t.shape[0] == 1 and not t.any()):
            n = min(t.shape[0], max_gt)
            boxes[i, :n] = t[:n, :4]
            labels[i, :n] = t[:n, 4].astype(np.int32)
            valid[i, :n] = True
    return {"images": images, "boxes": boxes, "labels": labels, "valid": valid, "sizes": sizes}


def truncation_stats(samples, max_gt: int):
    """``(boxes dropped by the max_gt pad, max per-image GT count)`` of one
    batch; the loader adds them up over an epoch so that no label is lost
    silently."""
    dropped = 0
    max_seen = 0
    for sample in samples:
        t = np.asarray(sample[1], np.float32).reshape(-1, 5)
        if t.shape[0] == 1 and not t.any():
            continue  # "no GT" sentinel
        max_seen = max(max_seen, t.shape[0])
        dropped += max(0, t.shape[0] - max_gt)
    return dropped, max_seen


# -- fork-pool plumbing: the children inherit the dataset, batches come back
# pickled (batches this module's own workers made); _AHEAD batches a worker
# are queued ahead of the consumer; close() waits up to _CLOSE_WAIT_S for them
# (a worker that died loses its batch, which never arrives)
_AHEAD, _CLOSE_WAIT_S = 2, 120.0
_WORKER_DATASET = None
_WORKER_MAX_GT = None


def _worker_init(dataset, max_gt, seed):
    global _WORKER_DATASET, _WORKER_MAX_GT
    _WORKER_DATASET = dataset
    _WORKER_MAX_GT = max_gt
    random.seed((os.getpid() * 1000003) ^ seed)
    np.random.seed((os.getpid() * 7919 + seed) % (2**32))


def _wait_for(results):
    """Wait up to ``_CLOSE_WAIT_S`` in all for ``AsyncResult`` s to arrive."""
    deadline = time.monotonic() + _CLOSE_WAIT_S
    for r in results:
        r.wait(max(0.0, deadline - time.monotonic()))


def _worker_make_batch(task):
    bi, chunk = task
    samples = [_WORKER_DATASET[i] for i in chunk]
    return (bi, detection_collate(samples, _WORKER_MAX_GT),
            truncation_stats(samples, _WORKER_MAX_GT))


class DetectionLoader:
    """Batch loader over a map-style dataset.

    ``num_workers > 0`` loads in a fork pool (capped at the cores less one;
    on a host of at most 2 cores it loads inline); ``num_workers = 0`` loads
    inline. Shuffling is ``random.Random(seed + epoch)``; with
    ``num_shards > 1`` each shard takes its interleaved slice of the same
    permutation (one rank's share of the train set, for data parallelism).
    ``image_range = (start, end)`` restricts the loader to those images (one
    rank's contiguous share of the eval set, :meth:`range_view`).
    """

    def __init__(self, dataset, batch_size: int, max_gt: int, shuffle: bool,
                 drop_last: bool, num_workers: int = 4, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1, image_range=None):
        self.dataset = dataset
        self.image_range = image_range
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.drop_last = drop_last
        cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else (
            os.cpu_count() or 1)
        self.num_workers = 0 if cores <= 2 else min(max(0, num_workers), cores - 1)
        self.seed = seed
        self.epoch = 0
        self._pool = None
        # each live iteration's batches in the pool not yet taken, in order
        self._inflight = {}
        self.gt_dropped_last_epoch = 0
        self.gt_max_seen = 0
        self._warned_truncation = False
        self.shard_id = shard_id
        self.num_shards = max(1, num_shards)

    def image_span(self):
        """The ``(start, end)`` of the images this loader covers."""
        return self.image_range if self.image_range is not None else (0, len(self.dataset))

    def _shard_indices(self):
        idx = list(range(*self.image_span()))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_id::self.num_shards]
        return idx

    def range_view(self, start: int, end: int) -> "DetectionLoader":
        """A loader over the images ``[start, end)`` of the same dataset, in
        order, every image kept: one rank's share of a sharded eval."""
        return DetectionLoader(self.dataset, batch_size=self.batch_size, max_gt=self.max_gt,
                               shuffle=False, drop_last=False, num_workers=self.num_workers,
                               seed=self.seed, image_range=(start, end))

    def __len__(self):
        start, end = self.image_span()
        n = (end - start) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = self._shard_indices()
        batches = []
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    continue
                # wrap around (again, for a remainder under half a batch) so
                # the last eval batch keeps the batch shape
                while len(chunk) < self.batch_size:
                    chunk = chunk + chunk[: self.batch_size - len(chunk)]
            batches.append(chunk)
        return batches

    def _get_pool(self):
        if self._pool is None:
            import multiprocessing as mp

            self._pool = mp.get_context("fork").Pool(
                self.num_workers, initializer=_worker_init,
                initargs=(self.dataset, self.max_gt, self.seed))
        return self._pool

    def _note_truncation(self, dropped: int, max_seen: int):
        self.gt_dropped_last_epoch += dropped
        self.gt_max_seen = max(self.gt_max_seen, max_seen)

    def _finish_epoch_accounting(self):
        """Warn once, at the end of the first epoch that dropped boxes."""
        if self.gt_dropped_last_epoch and not self._warned_truncation:
            self._warned_truncation = True
            print(
                f"WARNING: DATASET.MAX_GT={self.max_gt} dropped "
                f"{self.gt_dropped_last_epoch} ground-truth boxes this epoch "
                f"(max per-image GT seen: {self.gt_max_seen}). Raise "
                f"DATASET.MAX_GT to >= {self.gt_max_seen} to train on every "
                "label (the pad is only a fixed-shape batch layout; cost "
                "is a few KB/image).", file=sys.stderr, flush=True)

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()
        self.epoch += 1
        self.gt_dropped_last_epoch = 0
        if self.num_workers == 0:
            for chunk in batches:
                samples = [self.dataset[i] for i in chunk]
                self._note_truncation(*truncation_stats(samples, self.max_gt))
                yield detection_collate(samples, self.max_gt)
            self._finish_epoch_accounting()
            return

        pool = self._get_pool()
        tasks = enumerate(batches)
        key = object()
        inflight = self._inflight.setdefault(key, collections.deque())
        try:
            for task in itertools.islice(tasks, _AHEAD * self.num_workers):
                inflight.append(pool.apply_async(_worker_make_batch, (task,)))
            while inflight:
                _, batch, stats = inflight[0].get()
                inflight.popleft()
                for task in itertools.islice(tasks, 1):
                    inflight.append(pool.apply_async(_worker_make_batch, (task,)))
                self._note_truncation(*stats)
                yield batch
        except Exception as e:
            self.close()
            raise RuntimeError("data worker failed") from e
        finally:  # left early (its generator closed): its batches in flight arrive first
            _wait_for(inflight)
            self._inflight.pop(key, None)
        self._finish_epoch_accounting()

    def close(self) -> None:
        """End the worker processes (a later iteration starts new ones),
        once the batches in flight have arrived (none is then being written
        into the pool's result pipe, which ``terminate`` stops reading)."""
        if self._pool is not None:
            _wait_for(itertools.chain(*self._inflight.values()))
            self._inflight.clear()
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown


def load_data(dataset_cfg, phase: str, image_size=None, batch_size: int = 32,
              shard_id: int = 0, num_shards: int = 1) -> DetectionLoader:
    """The phase's loader (reference ``load_data(cfg.DATASET, phase)``).

    ``phase``: 'train' (TRAIN_SETS, augmentation PROB; resize only with
    ``DEVICE_AUG``, whose augmentation the train step runs), 'eval' /
    'test' (TEST_SETS, PROB = -1) or 'visualize' (TRAIN_SETS, PROB = -1).
    ``shard_id`` / ``num_shards``: this rank's interleaved share of the
    permutation (data parallelism; ``batch_size`` is then the rank's).
    """
    name = dataset_cfg.DATASET
    if name not in dataset_map:
        raise KeyError(f"unknown or not yet ported DATASET.DATASET={name!r}")
    image_size = image_size or [300, 300]
    means = tuple(dataset_cfg.PIXEL_MEANS)
    if phase == "train":
        sets, prob, shuffle, drop_last = dataset_cfg.TRAIN_SETS, dataset_cfg.PROB, True, True
        if bool(dataset_cfg.get("DEVICE_AUG", False)):
            prob = -1  # the host only resizes; the train step augments on the device
    elif phase in ("eval", "test"):
        sets, prob, shuffle, drop_last = dataset_cfg.TEST_SETS, -1, False, False
    elif phase == "visualize":
        sets, prob, shuffle, drop_last = dataset_cfg.TRAIN_SETS, -1, False, False
    else:
        raise ValueError(f"unknown phase {phase!r}")
    pre = preproc(image_size, means, prob)
    dataset = dataset_map[name](dataset_cfg.DATASET_DIR, sets, preproc=pre)
    return DetectionLoader(
        dataset, batch_size=batch_size, max_gt=int(dataset_cfg.MAX_GT), shuffle=shuffle,
        drop_last=drop_last, num_workers=int(dataset_cfg.NUM_WORKERS), shard_id=shard_id,
        num_shards=num_shards)
