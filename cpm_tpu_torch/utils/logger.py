"""Training logger: windowed smoothed losses, step and loader-wait timers, ETA.

The port's copy of `SmoothedValue`, `TrainingLogger` and `TestingLogger`
from cpm_tpu/utils/logger.py (after the reference's pet/utils/logger.py:12-184).
As there, the logger only displays: the train step computes total_loss, and
the logger is never on the compute path. Beside the step time it keeps the
time each step waited for its batch (the reference's data timer). Under data
parallelism every rank keeps its statistics and rank 0 alone prints them.
"""

import collections
import datetime
import time


class SmoothedValue:
    """Windowed median/average (logger.py:248-281)."""

    def __init__(self, window_size: int = 20):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.total += value
        self.count += 1

    @property
    def median(self):
        if not self.deque:
            return 0.0
        s = sorted(self.deque)
        return s[len(s) // 2]

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class TrainingLogger:
    def __init__(self, model_name: str = "model", log_period: int = 20, max_iter: int = 0,
                 rank: int = 0):
        self.model_name = model_name
        self.rank = rank
        self.log_period = log_period
        self.max_iter = max_iter
        self.stats = collections.defaultdict(SmoothedValue)
        self.iter_time = SmoothedValue()
        self.data_time = SmoothedValue()
        self._tic = None

    def iter_tic(self):
        self._tic = time.perf_counter()

    def iter_toc(self):
        if self._tic is not None:
            self.iter_time.update(time.perf_counter() - self._tic)
            self._tic = None

    def update_stats(self, metrics: dict, iteration: int):
        for k, v in metrics.items():
            self.stats[k].update(float(v))

    def log_stats(self, iteration: int):
        if self.rank != 0:
            return
        eta = ""
        if self.max_iter and self.iter_time.count:
            remain = (self.max_iter - iteration) * self.iter_time.avg
            eta = f", eta: {datetime.timedelta(seconds=int(remain))}"
        parts = [f"{k}: {v.median:.4f}" for k, v in sorted(self.stats.items()) if k != "lr"]
        lr = self.stats["lr"].deque[-1] if self.stats["lr"].deque else 0.0
        print(
            f"[{self.model_name}] iter {iteration}"
            f"{'/' + str(self.max_iter) if self.max_iter else ''}, "
            f"lr: {lr:.6f}, "
            + ", ".join(parts)
            + f", iter_time: {self.iter_time.median:.3f}s, data_time: "
            f"{self.data_time.median:.3f}s{eta}",
            flush=True,
        )


class TestingLogger:
    """Inference timing split: `tic(name)` / `toc(name)` around each stage,
    `log(done, total)` prints each stage's windowed average and, once an
    'infer' stage has been timed, the ETA."""

    def __init__(self, model_name: str = "model", log_period: int = 100):
        self.model_name = model_name
        self.log_period = log_period
        self.timers = collections.defaultdict(SmoothedValue)
        self._tics = {}

    def tic(self, name: str):
        self._tics[name] = time.time()

    def toc(self, name: str):
        if name in self._tics:
            self.timers[name].update(time.time() - self._tics.pop(name))

    def log(self, done: int, total: int):
        parts = [f"{k}: {v.avg:.3f}s" for k, v in sorted(self.timers.items())]
        eta = ""
        if "infer" in self.timers and self.timers["infer"].count:
            per = sum(v.avg for v in self.timers.values())
            eta = f", eta: {datetime.timedelta(seconds=int((total - done) * per))}"
        print(f"[{self.model_name}] test {done}/{total}, " + ", ".join(parts) + eta, flush=True)
