"""Batching loader with background prefetch, and the synthetic datasets.

The port's copy of `stswincl_tpu/data/loader.py` (numpy only):

  * a deterministic order and per-sample RNG streams: sample i of epoch e
    is always augmented with `_seeded_rng(seed, e, i)`, whatever the
    worker count or timing, so both packages draw the same samples;
  * sharding: each process loads its contiguous `1 / num_shards` of every
    global batch. The shard index and count are arguments (the JAX package
    reads `jax.process_index()`; `pipelines/common.build_loader` passes the
    torch process group's rank and world size);
  * prefetch on a thread, so that host decoding overlaps device work;
  * `drop_last` batching like the reference's training loaders.

Workers are threads, or with `use_processes` processes started by
`spawn` (the caller may hold threads, so `fork` is unsafe); both give the
same batches in the same order.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np


def _seeded_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, epoch, index]))


# process workers: the dataset is shipped once per worker by the pool's
# initializer; each task is just (seed, epoch, index)
_WORKER_DATASET = None


def _proc_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _proc_load(args):
    seed, epoch, idx = args
    return _WORKER_DATASET.get(idx, _seeded_rng(seed, epoch, idx))


class Loader:
    """`epoch(e)` yields this shard's batches of epoch e as dicts of
    stacked numpy arrays."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 4,
        shard_index: int = 0,
        num_shards: int = 1,
        prefetch: int = 2,
        use_processes: bool = False,
    ):
        if batch_size % num_shards:
            raise ValueError(f"batch size {batch_size} does not split into "
                             f"{num_shards} shards")
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.use_processes = use_processes

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])).shuffle(order)
        return order

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield this shard's batches of one epoch."""
        order = self._epoch_order(epoch)
        steps = self.steps_per_epoch()

        def batch_indices(step: int) -> List[int]:
            # this shard's contiguous slice of the global batch
            lo = step * self.batch_size + self.shard_index * self.local_batch
            return [int(order[p])
                    for p in range(lo, min(lo + self.local_batch, len(order)))]

        def load_one(idx: int) -> Dict:
            return self.dataset.get(idx, _seeded_rng(self.seed, epoch, idx))

        def produce(out_q: queue.Queue):
            try:
                if self.use_processes:
                    pool = ProcessPoolExecutor(
                        self.num_workers,
                        mp_context=multiprocessing.get_context("spawn"),
                        initializer=_proc_init, initargs=(self.dataset,))
                    fn = _proc_load
                    task = lambda idx: (self.seed, epoch, idx)  # noqa: E731
                else:
                    pool = ThreadPoolExecutor(self.num_workers)
                    fn, task = load_one, int
                with pool:
                    for step in range(steps):
                        tasks = [task(i) for i in batch_indices(step)]
                        out_q.put(_collate(list(pool.map(fn, tasks))))
                out_q.put(None)
            except BaseException as e:  # hand worker errors to the consumer
                out_q.put(e)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()


def _collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = np.asarray(vals)
    return out


class SyntheticSegDataset:
    """Deterministic sliding-window clips and blocky labels shaped like
    EndoVis18: sample `i` is the clip of global frames [i, i + t), so
    consecutive samples overlap by t - 1 frames like a real video."""

    def __init__(self, length=32, t=4, hw=(128, 192), num_classes=12):
        self.length = length
        self.t = t
        self.h, self.w = hw
        self.num_classes = num_classes

    def __len__(self):
        return self.length

    def _frame(self, k: int) -> np.ndarray:
        return np.random.default_rng(k).random(
            (self.h, self.w, 3), dtype=np.float32)

    def sliding_from(self, prev_path, path) -> bool:
        return prev_path[0] == path[0] and path[1] == prev_path[1] + 1

    def get(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        f = index + self.t - 1  # the clip's target (last) global frame
        image = np.stack([self._frame(k) for k in range(index, index + self.t)])
        g = np.random.default_rng(f + 100_003)
        coarse = g.integers(0, self.num_classes, size=(self.h // 16, self.w // 16))
        label = np.kron(coarse, np.ones((16, 16), dtype=np.int64)).astype(np.int32)
        return {"path": (1, f), "image": image, "label": label}


class SyntheticContrastDataset:
    """Deterministic 6-view contrastive samples: normal clips and blocky
    labels (one class per 16x16 block)."""

    def __init__(self, length=16, t=4, hw=(128, 192), num_classes=12):
        self.length = length
        self.t = t
        self.h, self.w = hw
        self.num_classes = num_classes

    def __len__(self):
        return self.length

    def get(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        g = np.random.default_rng(index)
        clips = g.standard_normal(
            (6, self.t, self.h, self.w, 3)).astype(np.float32)
        coarse = g.integers(0, self.num_classes, size=(6, self.h // 16, self.w // 16))
        labels = np.kron(coarse, np.ones((1, 16, 16), dtype=np.int64)).astype(np.int32)
        coords = g.random((6, 4), dtype=np.float32)
        return {"clips": clips, "labels": labels, "coords": coords,
                "path": (1, index)}
