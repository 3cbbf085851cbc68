"""The benchmark timer: counterpart of ``paddle_tpu/profiler/timer.py``
(the ``benchmark()`` singleton a training loop reports its step cost and
ips through). Host wall time between ``step()`` calls: on the card that
is the step's time only when the loop syncs before each ``step()``."""
from __future__ import annotations

import time
from typing import Optional


class _Stat:
    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.last = 0.0

    def add(self, v: float):
        self.count += 1
        self.total += v
        self.last = v

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


class Benchmark:
    def __init__(self):
        self.reset()

    def reset(self):
        self._step_t0: Optional[float] = None
        self._running = False
        self.step_cost = _Stat()
        self.samples = 0
        self._t_begin = None

    def begin(self):
        self._running = True
        self._t_begin = time.perf_counter()
        self._step_t0 = None

    def step(self, num_samples: Optional[int] = None):
        if not self._running:
            return
        now = time.perf_counter()
        if self._step_t0 is not None:
            self.step_cost.add(now - self._step_t0)
            if num_samples:
                self.samples += int(num_samples)
        self._step_t0 = now

    def end(self):
        self._running = False

    # -- reporting --
    def ips(self) -> float:
        """Instances/sec over recorded steps (0 if samples weren't
        reported)."""
        if self.step_cost.total <= 0:
            return 0.0
        return self.samples / self.step_cost.total

    def step_info(self, unit: str = "s") -> str:
        ips = self.ips()
        ips_part = f", ips: {ips:.3f} samples/s" if ips else ""
        return (f"avg batch_cost: {self.step_cost.avg:.5f} {unit}"
                f"{ips_part}")


_benchmark = Benchmark()


def benchmark() -> Benchmark:
    return _benchmark
