"""Window arithmetic for end-to-end metrics.

A rate counts all the work of the window over all of its time: the window
closes when the first unit of work that finishes after ``seconds`` has
finished, so no unit in flight is dropped or counted in part. A tail takes
every sample of the window. The percentile is numpy's linear one, as
``scripts/real_robot_loop_torch.py`` computes its tick latencies.
"""

from __future__ import annotations

import statistics
import time

import numpy as np


class Window:
    """Times a measured window of units of work (steps, ticks).

    ``start()`` after set-up; ``done(n)`` after each unit has finished
    (after a device sync) with the work it held; ``open`` stays True until
    a unit finishes at or after ``seconds`` from the start."""

    def __init__(self, seconds: float, clock=time.perf_counter):
        self.seconds = float(seconds)
        self.clock = clock
        self.t0 = None
        self.t_end = None
        self.units = 0
        self.work = 0.0
        self.samples = []

    def start(self):
        self.t0 = self.clock()
        return self.t0

    def done(self, work: float = 1.0, sample: float = None):
        """Record one finished unit; returns whether the window is open."""
        now = self.clock()
        self.units += 1
        self.work += work
        if sample is not None:
            self.samples.append(sample)
        if now - self.t0 >= self.seconds:
            self.t_end = now
        return self.open

    @property
    def open(self) -> bool:
        return self.t_end is None

    @property
    def elapsed(self) -> float:
        end = self.t_end if self.t_end is not None else self.clock()
        return end - self.t0

    def rate(self) -> float:
        """All the work over all the time of the window."""
        return self.work / self.elapsed


def percentile(samples, q: float) -> float:
    """numpy's linear percentile of every sample (q in 0..100)."""
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


def spread(values) -> float:
    """The interquartile distance as a share of the median, with Python's
    ``statistics.quantiles(values, n=4)`` (the contract's measure)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
