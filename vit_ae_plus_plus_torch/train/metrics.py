"""Host-side metric logging.

The port's copy of the JAX package's train/metrics.py (reference
utils/misc.py:24-167): windowed SmoothedValue meters (median / avg /
global_avg) and a MetricLogger that prints ETA, iteration time and data
time; the JSON-lines epoch log (reference k_fold_…_brats.py:205-209); and
TensorBoard scalars with the reference's `epoch_1000x` x-axis
(train_one_epoch.py:90-101) through utils/tb_events.py, which needs no
tensorboard package. Image grids and the embedding projector are not
ported yet.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable

from vit_ae_plus_plus_torch.utils.tb_events import EventWriter


class SmoothedValue:
    """Windowed value tracker (reference misc.py:24-83 semantics)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value, max=max(self.deque) if self.deque else 0.0,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_freq: int = 20):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable: Iterable, header: str = "", length: int = None):
        """Iterator wrapper printing progress/ETA/iter-time/data-time
        (reference misc.py:123-167). `length` overrides len() for generators
        (e.g. a `cuda_prefetch` wrapper around a sized loader)."""
        i = 0
        total = length if length is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None
        )
        iter_time, data_time = SmoothedValue(fmt="{avg:.4f}"), SmoothedValue(fmt="{avg:.4f}")
        start = time.time()
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % self.print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_sec = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_sec))}  "
                print(
                    f"{header} [{i}{f'/{total}' if total else ''}]  {eta}{self}  "
                    f"time: {iter_time}  data: {data_time}"
                )
            i += 1
            end = time.time()
        total_time = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(total_time))}")


class JsonlLogger:
    """Per-epoch JSON-lines log (reference k_fold_…_brats.py:205-209)."""

    def __init__(self, output_dir: str, filename: str = "log.txt"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)

    def write(self, record: Dict):
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")


class TBWriter:
    """TensorBoard scalars with the reference's epoch_1000x x-axis, through
    the native event writer (utils/tb_events.py)."""

    def __init__(self, log_dir: str):
        self._w = EventWriter(log_dir)

    def scalars(self, values: Dict[str, float], epoch_frac: float):
        x = int(epoch_frac * 1000)
        for k, v in values.items():
            self._w.scalar(k, float(v), x)

    def scalars_at(self, values: Dict[str, float], step: int):
        """Plain-step x-axis (the reference's per-epoch fine-tune scalars,
        fine_tune_epoch.py:416-419, use `epoch` directly, not epoch_1000x)."""
        for k, v in values.items():
            self._w.scalar(k, float(v), int(step))

    def flush(self):
        self._w.flush()

    def close(self):
        self._w.close()
