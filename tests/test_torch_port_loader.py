"""The port's loader (data/loader.py) against the JAX package's: epoch
orders, batches and their order over epochs, `set_epoch`, the helpers,
the producer's failure and abandonment behaviour, and `cuda_prefetch` on
the CPU.

Batches are bitwise equal (`assert_array_equal`): the code is a copy under
the same generators. `cuda_prefetch(device="cpu")` yields CPU tensors of
the host batch's values; the card's path is tests/test_torch_port_data_cuda.py.
"""

import threading
import time

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.data import loader as tl
from vit_ae_plus_plus_torch.data import transforms as tt
from vit_ae_plus_plus_torch.data.brats import BraTSDataset as TBraTS
from vit_ae_plus_plus_tpu.data import loader as jl
from vit_ae_plus_plus_tpu.data import transforms as jt
from vit_ae_plus_plus_tpu.data.brats import BraTSDataset as JBraTS


class _IdxDataset:
    """-> (volume filled with the index, its negative, index): a batch shows
    which items it holds and in what order."""

    labels = None

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        v = np.full((1, 2, 2, 2), float(i), np.float32)
        return v, -v, int(i)


@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("n_items", [12, 17])
@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_order_matches_the_jax_loaders(seed, n_items, shuffle):
    """Each epoch's order is the JAX package's `epoch_shard` on one process."""
    indices = np.arange(100, 100 + n_items)
    for epoch in (1, 2, 3):
        got = tl.epoch_order(indices, epoch, seed, shuffle=shuffle)
        np.testing.assert_array_equal(got, jl.epoch_shard(indices, epoch, seed, 0, 1, shuffle=shuffle))


def _batches(loader):
    return [tuple(np.copy(x) for x in b) for b in loader]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_loader_batches_over_epochs_and_set_epoch(drop_last, shard):
    """Two epochs, then `set_epoch(5)`: order and contents equal to the JAX
    loader's (with `shard_rows` (1, 2): rows 2-3 of each of its batches,
    the last partial one padded with its first item), and every epoch
    draws a new order."""
    kw = dict(batch_size=4, shuffle=True, drop_last=drop_last, num_workers=3, prefetch=2, seed=11)
    t, j = tl.Loader(_IdxDataset(19), **kw, shard_rows=shard), jl.Loader(_IdxDataset(19), **kw)

    def jax_batches():
        if shard is None:
            return _batches(j)
        return [tuple(np.concatenate([x, np.repeat(x[:1], 4 - len(x), axis=0)])[2:] for x in b) for b in j]

    assert len(t) == len(j)
    epochs = []
    for _ in range(2):
        got = _batches(t)
        _assert_batches_equal(got, jax_batches())
        epochs.append(np.concatenate([b[2] for b in got]))
    assert not np.array_equal(epochs[0], epochs[1])
    t.set_epoch(5)
    j.set_epoch(5)
    _assert_batches_equal(_batches(t), jax_batches())
    assert len(t.collate_ms) == len(t.wait_ms) == len(t)


def test_loader_over_a_dataset_with_transforms_matches():
    rng = np.random.default_rng(0)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        np.save(f"{d}/x_whole_ssl.npy", rng.standard_normal((6, 10, 10, 10, 1)).astype(np.float32))
        np.save(f"{d}/y_whole_ssl.npy", np.arange(6) % 2)

        def policy(m):
            return m.Compose([m.RandomAffine3D(), m.RandomNoise(0.1), m.RandomGamma((-0.3, 0.3))])

        t = tl.Loader(TBraTS(d, transform=policy(tt), use_z_score=True), 2, seed=1, num_workers=4)
        j = jl.Loader(JBraTS(d, transform=policy(jt), use_z_score=True), 2, seed=1, num_workers=4)
        for _ in range(2):
            _assert_batches_equal(_batches(t), _batches(j))


def test_helpers_match():
    ds = _IdxDataset(7)
    np.testing.assert_array_equal(tl.all_labels(ds), jl.all_labels(ds))
    for a, b in zip(tl.all_items(ds), jl.all_items(ds)):
        np.testing.assert_array_equal(a, b)
    t_cat = tl.ConcatDataset([_IdxDataset(3), _IdxDataset(5)])
    j_cat = jl.ConcatDataset([_IdxDataset(3), _IdxDataset(5)])
    assert len(t_cat) == len(j_cat) == 8
    for i in range(8):
        assert t_cat[i][2] == j_cat[i][2]

    class _Labelled:
        has_labels = True
        indices = [("a", 1), ("b", 0)]

    np.testing.assert_array_equal(tl.all_labels(_Labelled()), [1, 0])


def test_producer_exception_reaches_the_consumer():
    class _Broken(_IdxDataset):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError("item 5 is broken")
            return super().__getitem__(i)

    loader = tl.Loader(_Broken(12), 4, shuffle=False, num_workers=2)
    seen = []
    with pytest.raises(KeyError, match="item 5 is broken"):
        for batch in loader:
            seen.append(batch)
    assert len(seen) == 1  # the first batch, then the second's error


def test_abandoned_iteration_ends_the_producer_within_2s():
    loader = tl.Loader(_IdxDataset(64), batch_size=4, shuffle=False, num_workers=1, prefetch=1)
    before = {t.ident for t in threading.enumerate()}
    it = iter(loader)
    next(it)  # the producer runs and soon blocks on the full queue
    time.sleep(0.2)
    it.close()
    deadline = time.time() + 2.0
    while True:
        leaked = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
        if not leaked or time.time() > deadline:
            break
        time.sleep(0.05)
    assert not leaked, f"threads still running 2 s after the consumer left: {leaked}"


@pytest.mark.parametrize("drop_last", [True, False])
def test_len_raises_on_zero_batches(drop_last):
    loader = tl.Loader(_IdxDataset(0 if not drop_last else 3), batch_size=4, drop_last=drop_last)
    with pytest.raises(ValueError, match="0 batches"):
        len(loader)


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("put_orig", [True, False])
def test_cuda_prefetch_on_the_cpu_yields_the_batches_in_order(size, put_orig):
    loader = tl.Loader(_IdxDataset(22), 4, seed=2, drop_last=False, num_workers=2)
    host = _batches(tl.Loader(_IdxDataset(22), 4, seed=2, drop_last=False, num_workers=2))
    got = list(tl.cuda_prefetch(loader, size=size, device="cpu", put_orig=put_orig))
    assert len(got) == len(host) == 6
    for (aug, orig, labels), (h_aug, h_orig, h_labels) in zip(got, host):
        assert isinstance(aug, torch.Tensor) and aug.device.type == "cpu"
        np.testing.assert_array_equal(aug.numpy(), h_aug)
        if put_orig:
            assert isinstance(orig, torch.Tensor)
            np.testing.assert_array_equal(orig.numpy(), h_orig)
        else:
            assert isinstance(orig, np.ndarray)
            np.testing.assert_array_equal(orig, h_orig)
        assert isinstance(labels, np.ndarray)
        np.testing.assert_array_equal(labels, h_labels)


def test_cuda_prefetch_raises_without_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.cuda_prefetch(iter([]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.cuda_prefetch(iter([]), device="cuda")
    assert list(tl.cuda_prefetch(iter([]), device="cpu")) == []


def test_prefetch_overlaps_loading_with_compute():
    """The bound tests/test_loader_sharding.py holds the JAX pipeline to:
    sequential loading would stall ~load / (load + compute) = 40% of the
    epoch."""
    stall, total = tl.measure_prefetch_overlap(load_ms=20, compute_ms=30, n_batches=10, device="cpu")
    assert stall < 0.22, f"consumer stalled {stall:.0%} of the epoch ({total:.2f}s)"


class _CountedDataset(_IdxDataset):
    """-> (volume holding the index and its access count, ..., index): a
    batch shows each item's augmentation stream (data/brats.py draws it
    from the item and its access count)."""

    def __init__(self, n):
        super().__init__(n)
        self.counts = {}
        self._lock = threading.Lock()

    def count_access(self, item, n=1):
        with self._lock:
            self.counts[item] = self.counts.get(item, 0) + n

    def __getitem__(self, i):
        self.count_access(i)
        v = np.full((1, 2, 2, 2), 1000.0 * i + self.counts[i], np.float32)
        return v, -v, int(i)


@pytest.mark.parametrize("n,ranks,batch", [(15, 2, 4), (17, 4, 8), (12, 3, 6)])
@pytest.mark.parametrize("drop_last", [True, False])
def test_row_shards_make_up_the_one_process_batches(n, ranks, batch, drop_last):
    """`shard_rows=(d, D)`: over three epochs, rank d's batches are rows
    [d b, (d + 1) b) of the one-process loader's (n // batch of them with
    `drop_last`, not one more from wrap padding: 3 for n = 15, D = 2,
    B = 4), the last partial one padded with copies of its first item; every
    item's access count, and so its augmentation, is the one-process run's."""
    kw = dict(batch_size=batch, shuffle=True, drop_last=drop_last, num_workers=3, seed=9)
    one = tl.Loader(_CountedDataset(n), **kw)
    shards = [tl.Loader(_CountedDataset(n), **kw, shard_rows=(d, ranks)) for d in range(ranks)]
    assert all(len(s) == len(one) == (n // batch if drop_last else -(-n // batch)) for s in shards)
    for _ in range(3):
        want = _batches(one)
        got = [_batches(s) for s in shards]
        for k, (aug, orig, labels) in enumerate(want):
            pad = batch - len(labels)
            full = [np.concatenate([x, np.repeat(x[:1], pad, axis=0)]) for x in (aug, orig, labels)]
            for i, whole in enumerate(full):
                np.testing.assert_array_equal(np.concatenate([g[k][i] for g in got]), whole)
    assert all(s.dataset.counts == one.dataset.counts for s in shards)


def test_row_shards_refuse_a_batch_the_ranks_do_not_divide():
    with pytest.raises(ValueError, match="does not split into 3 equal shards"):
        tl.Loader(_IdxDataset(12), 4, shard_rows=(0, 3))
