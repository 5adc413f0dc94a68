"""Run logging: multi-run best-by-valid statistics + streaming meters (copy
of ``vq_gnn_tpu/utils/logger.py``; numpy only).

Same reporting contract as the reference (``utils/logger.py:6-85``): per run
the (train, valid, test) triple per epoch; summary picks the epoch with the
best valid score and reports mean +/- std across runs.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


class Logger:
    def __init__(self, runs: int, info=None):
        self.info = info
        self.results: List[List[Tuple[float, float, float]]] = [[] for _ in range(runs)]

    def add_result(self, run: int, result):
        assert len(result) == 3
        self.results[run].append(tuple(float(v) for v in result))

    def statistics(self, run=None):
        if run is not None:
            if not self.results[run]:
                return {}
            r = 100 * np.asarray(self.results[run])
            best = int(np.argmax(r[:, 1]))
            return {
                "highest_train": float(r[:, 0].max()),
                "highest_valid": float(r[:, 1].max()),
                "final_train": float(r[best, 0]),
                "final_test": float(r[best, 2]),
            }
        best_results = []
        for rr in self.results:
            if not rr:
                continue
            r = 100 * np.asarray(rr)
            best = int(np.argmax(r[:, 1]))
            best_results.append(
                (r[:, 0].max(), r[:, 1].max(), r[best, 0], r[best, 2])
            )
        if not best_results:
            return {}
        b = np.asarray(best_results)
        def ms(col):
            return float(b[:, col].mean()), float(b[:, col].std(ddof=1)) if len(b) > 1 else 0.0
        return {
            "highest_train": ms(0),
            "highest_valid": ms(1),
            "final_train": ms(2),
            "final_test": ms(3),
        }

    def print_statistics(self, run=None):
        if run is not None:
            s = self.statistics(run)
            if not s:
                print(f"Run {run + 1:02d}: no results")
                return
            print(f"Run {run + 1:02d}:")
            print(f"Highest Train: {s['highest_train']:.2f}")
            print(f"Highest Valid: {s['highest_valid']:.2f}")
            print(f"  Final Train: {s['final_train']:.2f}")
            print(f"   Final Test: {s['final_test']:.2f}")
        else:
            s = self.statistics()
            if not s:
                print("All runs: no results")
                return
            print("All runs:")
            for name, key in [
                ("Highest Train", "highest_train"),
                ("Highest Valid", "highest_valid"),
                ("  Final Train", "final_train"),
                ("   Final Test", "final_test"),
            ]:
                m, sd = s[key]
                print(f"{name}: {m:.2f} ± {sd:.2f}")


class AverageValueMeter:
    """Streaming weighted mean/std meter (numerically stable accumulators).

    Reporting contract matches the reference meter: ``value()`` returns
    ``(mean, std)``; mean is NaN before any sample, std is NaN before any
    sample and +inf with a single sample (sample std, ddof=1).
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.sum = 0.0
        self.val = 0.0
        self._mean = 0.0
        self._m2 = 0.0  # weighted sum of squared deviations from the mean

    def add(self, value, n=1):
        if n <= 0:
            raise ValueError("meter weight must be positive")
        value = float(value)
        self.val = value
        self.sum += value * n
        total = self.n + n
        delta = value - self._mean
        self._mean += delta * n / total
        self._m2 += n * delta * (value - self._mean)
        self.n = total

    @property
    def mean(self):
        return self._mean if self.n else math.nan

    @property
    def std(self):
        if self.n == 0:
            return math.nan
        if self.n == 1:
            return math.inf
        return math.sqrt(self._m2 / (self.n - 1))

    def value(self):
        return self.mean, self.std
