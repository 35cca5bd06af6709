"""Host-side batch loader with threaded prefetch, and the copy of its
batches to the card.

The port's copy of the JAX package's `data/loader.py`. Replaces the
reference's torch DataLoader + worker processes
(k_fold_cross_valid_combined_brats.py:134-148): per-sample augmentation runs
in a thread pool (numpy/scipy and the native augmenter release the GIL in
the hot paths), batches are stacked contiguously, and a small prefetch queue
overlaps host augmentation with device compute — the reference instead
blocked on `cuda.synchronize()` every step (train_one_epoch.py:76).
`cuda_prefetch` takes the place of the JAX package's `device_prefetch`: the
next batches' host-to-device copies run on a side stream from page-locked
buffers while the card runs the current step.

Where the JAX package reads `jax.process_index()` / `jax.process_count()`,
this module reads the rank and world size of the initialised
`torch.distributed` group, and 0 / 1 without one. The JAX package's
`DeviceResidentBatches` has no counterpart here yet.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np



def all_labels(dataset) -> np.ndarray:
    """Labels for StratifiedKFold without materialising volumes (the reference
    pushes every item through __getitem__ incl. augmentation just to get
    features it never uses for splitting — train_3d_resnet.py:196-204)."""
    labels = getattr(dataset, "labels", None)
    if labels is not None:
        return np.asarray(labels)
    if getattr(dataset, "has_labels", False):
        return np.asarray([int(x[1]) for x in dataset.indices])
    return np.full(len(dataset), -100)


def epoch_shard(
    indices,
    epoch: int,
    seed: int,
    rank: int,
    n_proc: int,
    shuffle: bool = True,
) -> np.ndarray:
    """Per-epoch multi-host sharding, DistributedSampler-equivalent (torch's
    sampler semantics the reference relies on: reshuffle GLOBALLY every epoch
    with an identical seed on all ranks, pad by wrapping so every rank gets
    the same batch count, never silently drop the remainder).

    The global order is drawn from `seed + epoch` — identical on every host —
    then dealt round-robin, so each original index is visited at least once
    per epoch and exactly once when len(indices) % n_proc == 0.
    """
    order = np.asarray(indices).copy()
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    if n_proc == 1:
        return order
    per = -(-len(order) // n_proc)  # ceil: pad rather than drop
    total = per * n_proc
    if total > len(order):
        order = np.concatenate([order, order[: total - len(order)]])
    return order[rank::n_proc]


def process_rank_and_count() -> Tuple[int, int]:
    """(rank, world size) of the initialised `torch.distributed` group, else
    (0, 1): the port's `jax.process_index()` / `jax.process_count()`."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_local_indices(indices) -> np.ndarray:
    """Static (epoch-independent) host shard of a global index list. Prefer
    `Loader(..., shard_across_processes=True)`, which reshuffles globally every
    epoch; this exists for one-shot sharding (e.g. eval loaders)."""
    rank, n_proc = process_rank_and_count()
    return epoch_shard(indices, epoch=0, seed=0, rank=rank, n_proc=n_proc, shuffle=False)


def all_items(dataset) -> Tuple[np.ndarray, np.ndarray]:
    """(stacked_augmented, labels) — reference-compatible materialisation."""
    items = [dataset[i] for i in range(len(dataset))]
    return np.stack([it[0] for it in items]), np.asarray([it[2] for it in items])


class ConcatDataset:
    """Concatenation of datasets with offset indexing (torch ConcatDataset
    equivalent, used by the EGD combined pretraining —
    reference k_fold_cross_valid_combined_egd.py:133-137)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, item):
        ds_idx = int(np.searchsorted(self._offsets, item, side="right") - 1)
        return self.datasets[ds_idx][item - int(self._offsets[ds_idx])]


def cuda_prefetch(iterator, size: int = 2, device=None, put_orig: bool = True,
                  record: Optional[dict] = None) -> Iterator[tuple]:
    """Asynchronous host-to-device copy of (aug, orig, labels) numpy batches,
    `size` batches ahead of the consumer: the counterpart of the JAX
    package's `device_prefetch`.

    Each array is copied into a page-locked staging buffer, from a ring of
    `size + 1` buffers per array, and from there to the card with
    `non_blocking=True` on a side stream, after the work queued so far on
    the consumer's stream; an event recorded after the copies marks the
    ring's slot free again. (Ordered so, the events follow the card's
    progress through the consumer's steps, and the host, which waits on
    them, runs at most `size + 1` batches ahead of the card.) A slot's buffers are rewritten only after the
    event of their last copy has completed: a pinned buffer rewritten under
    a pending copy hands the card another batch, with no error anywhere.
    Before a batch is yielded, the consumer's current stream waits on its
    event, and its tensors are marked as used there (`record_stream`), so
    the caching allocator keeps their memory until the consumer's work on
    them is done.

    Yields the same (aug, orig, labels) tuples with aug and orig as device
    tensors; labels stay numpy, and `put_orig=False` leaves orig on the host
    (the device-augment path derives both views on the card from the raw
    batch, so shipping orig would double the copies for nothing). The
    device comes from `resolve_device`: on "cpu" the batches are yielded as
    CPU tensors of the same values (what the CPU tests run); with CUDA
    asked for and absent it raises here. `record`, when given, receives the
    ring (`staging`: the pinned buffers by array name and slot) and, for
    each batch, the CUDA events before and after its copies on the side
    stream (`copies`), for measurement.
    """
    from vit_ae_plus_plus_torch.device import resolve_device

    dev = resolve_device(device)
    return _prefetch(iterator, size, dev, put_orig, record)


def _prefetch(iterator, size: int, dev, put_orig: bool, record: Optional[dict]):
    import torch

    names = ("aug", "orig") if put_orig else ("aug",)
    on_card = dev.type == "cuda"
    if on_card:
        stream = torch.cuda.Stream(dev)
        staging = {name: [None] * (size + 1) for name in names}
        freed = [None] * (size + 1)  # each slot's event after its last copies
        slot = 0
        if record is not None:
            record.update(staging=staging, copies=[])

    def put(batch):
        nonlocal slot
        arrays = {"aug": batch[0], "orig": batch[1]}
        if not on_card:
            out = {name: torch.from_numpy(np.ascontiguousarray(arrays[name])) for name in names}
            return out["aug"], out.get("orig", batch[1]), batch[2], None
        if freed[slot] is not None:
            freed[slot].synchronize()
        for name in names:
            host = torch.from_numpy(np.ascontiguousarray(arrays[name]))
            buf = staging[name][slot]
            if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
                buf = staging[name][slot] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            buf.copy_(host)
        timed = record is not None
        start = torch.cuda.Event(enable_timing=True) if timed else None
        stream.wait_stream(torch.cuda.current_stream(dev))
        out = {}
        with torch.cuda.stream(stream):
            if timed:
                start.record(stream)
            for name in names:
                out[name] = staging[name][slot].to(dev, non_blocking=True)
        done = torch.cuda.Event(enable_timing=timed)
        done.record(stream)
        freed[slot] = done
        slot = (slot + 1) % (size + 1)
        if timed:
            record["copies"].append((start, done))
        return out["aug"], out.get("orig", batch[1]), batch[2], done

    def ready(item):
        aug, orig, labels, done = item
        if done is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(done)
            for t in (aug, orig) if put_orig else (aug,):
                t.record_stream(current)
        return aug, orig, labels

    ahead = collections.deque()
    for batch in iterator:
        ahead.append(put(batch))
        if len(ahead) >= size:
            yield ready(ahead.popleft())
    while ahead:
        yield ready(ahead.popleft())


def measure_prefetch_overlap(load_ms: float = 20.0, compute_ms: float = 30.0,
                             n_batches: int = 10, batch_size: int = 2, device=None):
    """Measure the streaming pipeline's consumer stall fraction with a
    synthetic slow dataset and a simulated device step: with the producer
    thread + prefetch queue + `cuda_prefetch` put-ahead working, batch k+1 is
    loaded while the consumer is busy with batch k, so an epoch costs
    ~ n * max(load, compute), not ~ n * (load + compute). Returns
    (stall_fraction, total_seconds). `device` as for `cuda_prefetch`."""

    class _SlowDs:
        labels = np.zeros(n_batches * batch_size, np.int64)

        def __len__(self):
            return n_batches * batch_size

        def __getitem__(self, i):
            time.sleep(load_ms / 1e3 / batch_size)  # GIL released
            v = np.zeros((1, 8, 8, 8), np.float32)
            return v, v, 0

    loader = Loader(_SlowDs(), batch_size, shuffle=False, drop_last=True,
                    num_workers=1, prefetch=2, seed=0)
    # no warm-up pass: Loader spins up a fresh producer thread per epoch, so
    # there is nothing to warm; pipeline fill (the first batch's load) is
    # part of what the stall fraction honestly measures
    t0 = time.perf_counter()
    n = 0
    for _aug, _orig, _lab in cuda_prefetch(loader, size=2, device=device):
        time.sleep(compute_ms / 1e3)  # the "device step"
        n += 1
    total = time.perf_counter() - t0
    stall = max(0.0, 1.0 - (n * compute_ms / 1e3) / total)
    return stall, total


class Loader:
    """Iterable over (augmented, original, labels) numpy batches.

    Each iteration (epoch) keeps, for measurement, the host milliseconds of
    each batch's collation in the producer thread (`collate_ms`: the
    dataset's items through the thread pool, then the stacking) and of each
    wait of the consumer on the prefetch queue (`wait_ms`)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        indices: Optional[Sequence[int]] = None,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
        shard_across_processes: bool = False,
        rank: Optional[int] = None,
        n_proc: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices = np.asarray(indices if indices is not None else np.arange(len(dataset)))
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._epoch = 0
        self._seed = seed
        self.collate_ms: list = []
        self.wait_ms: list = []
        if shard_across_processes and (rank is None or n_proc is None):
            group_rank, group_size = process_rank_and_count()
            rank = group_rank if rank is None else rank
            n_proc = group_size if n_proc is None else n_proc
        self._rank = rank if shard_across_processes else 0
        self._n_proc = n_proc if shard_across_processes else 1

    def _local_len(self) -> int:
        n = len(self.indices)
        return -(-n // self._n_proc) if self._n_proc > 1 else n  # wrap-padded

    def __len__(self) -> int:
        n = self._local_len()
        length = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        if length == 0:
            raise ValueError(
                f"Loader would yield 0 batches: {n} items < batch_size "
                f"{self.batch_size} (drop_last={self.drop_last})"
            )
        return length

    def set_epoch(self, epoch: int) -> None:
        """Fast-forward the shuffle schedule for mid-run resume: the next
        `__iter__` draws the same global order the uninterrupted run's
        epoch-`epoch` iteration would have (DistributedSampler.set_epoch
        semantics)."""
        self._epoch = int(epoch)

    def _batches(self) -> Iterator[np.ndarray]:
        order = epoch_shard(
            self.indices, self._epoch, self._seed, self._rank, self._n_proc,
            shuffle=self.shuffle,
        )
        n_batches = len(self)
        for b in range(n_batches):
            yield order[b * self.batch_size : (b + 1) * self.batch_size]

    def __iter__(self):
        self._epoch += 1
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        collate_ms, wait_ms = self.collate_ms, self.wait_ms = [], []

        def collate(batch_idx):
            items = list(pool.map(self.dataset.__getitem__, batch_idx))
            aug = np.stack([it[0] for it in items])
            orig = np.stack([it[1] for it in items])
            labels = np.asarray([it[2] for it in items])
            return aug, orig, labels

        def put(item) -> bool:
            # bounded put that honours `stop`: a consumer that abandons the
            # iterator (break / generator close) must not leave this thread
            # blocked forever on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch_idx in self._batches():
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    batch = collate(batch_idx)
                    collate_ms.append((time.perf_counter() - t0) * 1e3)
                    if not put(batch):
                        return
                put(None)
            except BaseException as e:  # propagate to the consumer, never truncate
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                wait_ms.append((time.perf_counter() - t0) * 1e3)
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False)
