"""`cuda_prefetch` (data/loader.py) on the card: the batches that reach the
device are bitwise the numpy batches they came from, while their copies
are still pending behind the consumer's work. Every test here needs an
NVIDIA GPU and skips without one; this file imports no JAX, so it runs on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_port_data_cuda.py

The tests fail when a staging buffer is rewritten without waiting for the
event of its last copy: a long chain of products queued on the consumer's
stream holds every copy back (each copy is ordered after the consumer's
queued work), so the host reaches a ring slot again while its copy is
still pending. A page-locked or device allocation waits for the whole
card, which would let the copies finish first; so each test runs its
batches once untimed before the checked pass, and the checked pass takes
its buffers from the allocators' caches.
"""

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.data.loader import Loader, cuda_prefetch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned memory and streams)")
    return torch.device("cuda")


def _busy(device, n: int = 150):
    """Queue about half a second of f32 products on the current stream."""
    a = torch.randn(4096, 4096, device=device)
    b = torch.randn(4096, 4096, device=device)
    for _ in range(n):
        c = a @ b
    return c


def _prefetch_twice(batches, device, consume=list, **kw):
    """One pass to fill the allocators' caches, then the checked pass behind
    a busy consumer stream: -> what `consume` made of the checked pass."""
    consume(cuda_prefetch(iter(batches), device=device, **kw))
    _busy(device, n=1)
    torch.cuda.synchronize()
    _busy(device)
    return consume(cuda_prefetch(iter(batches), device=device, **kw))


def _batches(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((4, 1, 64, 64, 64)).astype(np.float32),
             rng.standard_normal((4, 1, 64, 64, 64)).astype(np.float32),
             np.arange(4) + 10 * i) for i in range(n)]


@pytest.mark.parametrize("put_orig", [True, False])
def test_ring_of_3_reused_only_after_its_copies(cuda, put_orig):
    batches = _batches(6)
    record = {}
    got = _prefetch_twice(batches, cuda, size=2, put_orig=put_orig, record=record)
    torch.cuda.synchronize()
    assert len(got) == 6
    for (aug, orig, labels), (h_aug, h_orig, h_labels) in zip(got, batches):
        assert aug.device.type == "cuda"
        np.testing.assert_array_equal(aug.cpu().numpy(), h_aug)
        if put_orig:
            np.testing.assert_array_equal(orig.cpu().numpy(), h_orig)
        else:
            assert orig is h_orig
        assert labels is h_labels
    ring = record["staging"]["aug"]
    assert len(ring) == 3 and all(buf.is_pinned() for buf in ring)
    assert ("orig" in record["staging"]) == put_orig
    assert len(record["copies"]) == 6
    assert all(start.elapsed_time(end) > 0 for start, end in record["copies"])


def test_consumer_stream_waits_for_the_copy(cuda):
    """A batch used on the consumer's stream right after it is yielded, with
    the copy still pending behind queued work, gives its host values."""
    batches = _batches(4, seed=1)

    def consume(prefetched):
        return [(aug.double().sum(), (aug - orig).abs().max()) for aug, orig, _ in prefetched]

    sums = _prefetch_twice(batches, cuda, consume, size=2)
    for (s, d), (h_aug, h_orig, _) in zip(sums, batches):
        assert float(s) == pytest.approx(float(h_aug.astype(np.float64).sum()), rel=1e-9)
        assert float(d) == float(np.abs(h_aug - h_orig).max())


def test_loader_batches_reach_the_card_unchanged(cuda):
    class _Ds:
        labels = np.arange(24) % 2

        def __len__(self):
            return 24

        def __getitem__(self, i):
            v = np.random.default_rng(i).standard_normal((1, 32, 32, 32)).astype(np.float32)
            return v, v * 2, int(self.labels[i])

    host = [tuple(np.copy(x) for x in b) for b in Loader(_Ds(), 4, seed=3, num_workers=4)]
    loader = Loader(_Ds(), 4, seed=3, num_workers=4)
    got = list(cuda_prefetch(loader, device=cuda))
    torch.cuda.synchronize()
    assert len(got) == len(host) == 6
    for (aug, orig, labels), (h_aug, h_orig, h_labels) in zip(got, host):
        np.testing.assert_array_equal(aug.cpu().numpy(), h_aug)
        np.testing.assert_array_equal(orig.cpu().numpy(), h_orig)
        np.testing.assert_array_equal(labels, h_labels)
