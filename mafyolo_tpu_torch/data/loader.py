"""Batching data loader with worker pools and fixed-shape collation
(counterpart of mafyolo_tpu/data/loader.py:42-159).

  * images collate to one NHWC uint8 numpy array (the Evaler moves it to
    the device; 1 byte a pixel crosses to the card);
  * labels collate to a fixed [B, max_labels, 5] pad (cls = -1 marks pad
    rows);
  * per-process sharding with (shard_id, num_shards);
  * samples come from a thread pool, or from a process pool of spawned
    workers; both draw each sample from a generator keyed by (seed, epoch,
    index), so their batches are bit-identical.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator

import numpy as np

from mafyolo_tpu_torch.data.datasets import DetectionDataset
from mafyolo_tpu_torch.utils.events import LOGGER

# Process-pool workers hold the dataset in a module global (set once by the
# initializer) so per-sample submissions ship only (idx, epoch, seed).
_WORKER_DS = None


def _proc_init(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _sample(dataset, idx, epoch, seed):
    rng = np.random.default_rng((seed, epoch, int(idx), 0x9E3779B9))
    return dataset.get_sample(int(idx), rng)


def _proc_fetch(args):
    return _sample(_WORKER_DS, *args)


class DataLoader:
    def __init__(self, dataset: DetectionDataset, batch_size: int, shuffle: bool,
                 workers: int = 8, seed: int = 0, max_labels: int = 120,
                 drop_last: bool = False, shard_id: int = 0, num_shards: int = 1,
                 prefetch: int = 2, use_processes: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = max(1, workers)
        self.seed = seed
        self.max_labels = max_labels
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.use_processes = use_processes
        self.epoch = 0
        self._truncated = 0

    def set_epoch(self, epoch: int):
        """Reshuffle control (DistributedSampler.set_epoch analog)."""
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, samples):
        imgs = np.stack([s[0] for s in samples])
        labels = np.full((len(samples), self.max_labels, 5), 0, np.float32)
        labels[:, :, 0] = -1.0
        for i, (_, lb, _) in enumerate(samples):
            n = len(lb)
            if n > self.max_labels:
                self._truncated += n - self.max_labels
                lb = lb[: self.max_labels]
                n = self.max_labels
            if n:
                labels[i, :n] = lb
        shapes = [s[2] for s in samples]
        return imgs, labels, shapes

    def shard_order(self) -> np.ndarray:
        """This shard's dataset indices for the current epoch. All shards
        compute the same base permutation (same seed+epoch), so the
        shard_id::num_shards slices partition the epoch exactly."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + 1000003 * self.epoch).permutation(n)
        else:
            order = np.arange(n)
        return order[self.shard_id::self.num_shards]

    def __iter__(self) -> Iterator:
        order = self.shard_order()
        nb = len(order) // self.batch_size if self.drop_last \
            else -(-len(order) // self.batch_size)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]

        if self.use_processes:
            pool_cm = ProcessPoolExecutor(
                self.workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_proc_init, initargs=(self.dataset,))
        else:
            pool_cm = ThreadPoolExecutor(self.workers)

        with pool_cm as pool:
            pending = []
            bi = 0

            def submit(b):
                if self.use_processes:
                    return [pool.submit(_proc_fetch, (i, self.epoch, self.seed)) for i in b]
                return [pool.submit(_sample, self.dataset, i, self.epoch, self.seed)
                        for i in b]

            while bi < len(batches) or pending:
                while bi < len(batches) and len(pending) <= self.prefetch:
                    pending.append(submit(batches[bi]))
                    bi += 1
                futs = pending.pop(0)
                yield self._collate([f.result() for f in futs])

        if self._truncated:
            LOGGER.warning(
                f"loader truncated {self._truncated} labels beyond max_labels="
                f"{self.max_labels} this epoch")
            self._truncated = 0


def create_dataloader(path, img_size, batch_size, stride=32, hyp=None, augment=False,
                      rect=False, pad=0.0, workers=8, shuffle=False, seed=0,
                      class_names=None, max_labels=120, shard_id=0, num_shards=1,
                      task="train", use_processes=False, rect_bucket=0,
                      dataset_cls=DetectionDataset):
    """Dataset + loader in one call; dataset_cls(path, ...) builds the
    dataset (utils/sample.py:ArrayDataset takes arrays in place of a path)."""
    dataset = dataset_cls(
        path, img_size=img_size, augment=augment, hyp=hyp, rect=rect,
        batch_size=batch_size, stride=stride, pad=pad, class_names=class_names,
        task=task, rect_bucket=rect_bucket)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                        workers=workers, seed=seed, max_labels=max_labels,
                        drop_last=augment, shard_id=shard_id,
                        num_shards=num_shards, use_processes=use_processes)
    return loader, dataset
