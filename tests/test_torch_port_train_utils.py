"""The port's copies of the JAX package's jax-free helpers that
`pretrain-kfold` uses, held to the originals on the CPU: the INI bridge
(`configs/ini.py`), the metric meters and logger (`train/metrics.py`), the
TensorBoard event file (`utils/tb_events.py`, byte for byte), and the
work-dir lock (`utils/locking.py`), whose hold table the port guards for
threads."""

import dataclasses
import itertools
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from vit_ae_plus_plus_tpu.configs import ini as jini
from vit_ae_plus_plus_tpu.train import metrics as jmetrics
from vit_ae_plus_plus_torch.configs import ini as tini
from vit_ae_plus_plus_torch.train import metrics as tmetrics
from vit_ae_plus_plus_torch.utils import locking

REPO = Path(__file__).resolve().parents[1]

SECTIONS = {
    "DATASET": "name = egd\nmode = test\nsplit = 1p19q\nuse_z_score = false\nin_channels = 4\n"
               "volume_size = 64\nnum_classes = 3\nbase_path = /data/egd\n",
    "K_FOLD": "epochs = 7\nbatch_size = 6\nweight_decay = 0.1\nstart_epoch = 2\nmask_ratio = 0.6\n"
              "perceptual_weight = 0.5\ncontr_weight = 0.01\nuse_edge_map = false\noutput_dir = o\n"
              "log_dir = l\npatch_size = 4\ndrop_path = 0.1\ncheckpoint = c.pth\neval = true\n"
              "use_mixup = true\nnb_classes = 3\nuse_proj = true\nonly_test_split = true\n",
    "FINE_TUNE_K_FOLD": "fix_backbone = true\n",
}


@pytest.mark.parametrize("present", [s for n in range(4) for s in itertools.combinations(SECTIONS, n)],
                         ids=lambda s: "+".join(s) or "empty")
def test_bootstrap_equals_the_jax_packages(present, tmp_path):
    path = tmp_path / "config.ini"
    path.write_text("".join(f"[{name}]\n{SECTIONS[name]}\n" for name in present))
    for key in ("K_FOLD", "EXTRACT_SSL"):
        got, want = tini.bootstrap(str(path), key), jini.bootstrap(str(path), key)
        for g, w in zip(got[:2], want[:2]):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert got[2] == want[2]


class _Clock:
    """time.time for both modules: 0.25 s a call, from the same start."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.25
        return self.t


def test_meters_and_logger_equal_the_jax_packages(monkeypatch, capsys):
    values = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0, 5.0, 3.0, 5.0, 8.0] * 3
    for window in (1, 5, 20):
        t, j = tmetrics.SmoothedValue(window), jmetrics.SmoothedValue(window)
        for v in values:
            t.update(v, n=2)
            j.update(v, n=2)
            assert (t.median, t.avg, t.global_avg, t.value, str(t)) == (j.median, j.avg, j.global_avg, j.value, str(j))
    printed = []
    for module in (tmetrics, jmetrics):
        monkeypatch.setattr(time, "time", _Clock())
        logger = module.MetricLogger(print_freq=4)
        for i in logger.log_every(range(10), header="Fold 0 Epoch [1]", length=10):
            logger.update(loss=values[i], lr=i * 1e-4)
        logger.update(epoch_loss=1.5)
        printed.append((capsys.readouterr().out, str(logger),
                        {k: m.global_avg for k, m in logger.meters.items()}))
    assert printed[0] == printed[1]
    assert "eta: " in printed[0][0] and printed[0][0].count("\n") == 5


def test_tb_event_file_equals_the_jax_packages(monkeypatch, tmp_path):
    monkeypatch.setattr(time, "time", lambda: 1792000000.5)
    files = []
    for name, module in (("port", tmetrics), ("jax", jmetrics)):
        tb = module.TBWriter(str(tmp_path / name))
        for epoch in range(3):
            tb.scalars({"train_loss": 1.0 / (epoch + 1), "lr": 1e-4 * epoch, "contr_loss": -2.5e-5}, epoch + 1)
        tb.scalars_at({"test_acc": 0.75, "step_big": 3e38}, 300)
        tb.flush()
        [path] = list((tmp_path / name).iterdir())
        files.append((path.name, path.read_bytes()))
    assert files[0] == files[1]
    assert len(files[0][1]) > 300


def test_lock_refuses_a_second_process_and_reenters_within_one(tmp_path):
    work = str(tmp_path / "w")
    locking.acquire_workdir_lock(work)
    try:
        locking.acquire_workdir_lock(work)  # re-entrant
        locking.release_workdir_lock(work)
        assert os.path.realpath(work) in locking._held
        out = subprocess.run(
            [sys.executable, "-c",
             "from vit_ae_plus_plus_torch.utils.locking import acquire_workdir_lock, WorkdirLockedError\n"
             f"try:\n    acquire_workdir_lock({work!r})\nexcept WorkdirLockedError as e:\n"
             "    print('refused', e)\n"],
            capture_output=True, text=True, timeout=60, cwd=str(REPO))
        assert out.stdout.startswith("refused") and f"pid {os.getpid()}" in out.stdout, out.stdout + out.stderr
    finally:
        locking.release_workdir_lock(work)
    assert os.path.realpath(work) not in locking._held


@pytest.mark.parametrize("n", [2, 16])
def test_threads_acquiring_one_dir_at_once_all_hold_it(n, tmp_path, monkeypatch):
    """`n` threads take one dir at once, 5 times, with a short switch
    interval and each flock call slowed by 2 ms: an unguarded check of the
    hold table lets two of them both miss it, and the second flock then
    refuses its own process."""
    real_flock = locking.fcntl.flock

    def slow_flock(fd, op):
        time.sleep(0.002)
        return real_flock(fd, op)

    monkeypatch.setattr(locking.fcntl, "flock", slow_flock)
    work = str(tmp_path / "w")
    key = os.path.realpath(work)
    start, errors, counts = threading.Barrier(n), [], []

    def take():
        start.wait()
        try:
            locking.acquire_workdir_lock(work)
        except locking.WorkdirLockedError as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            threads = [threading.Thread(target=take) for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert not any(t.is_alive() for t in threads)
            counts.append(locking._held[key][1])
            for _ in range(n):
                locking.release_workdir_lock(work)
            assert key not in locking._held
    finally:
        sys.setswitchinterval(interval)
    assert not errors and counts == [n] * 5
