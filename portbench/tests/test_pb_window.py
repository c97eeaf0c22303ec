"""Window arithmetic: a unit in flight counts whole; tails take every
sample."""

import numpy as np
import pytest

from portbench.lib.window import Window, percentile, spread


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_rate_counts_the_unit_in_flight_whole():
    clock = Clock()
    win = Window(10.0, clock)
    win.start()
    for _ in range(3):          # steps of 4 s: the third ends at 12 s
        clock.t += 4.0
        win.done(10)
    assert not win.open
    assert win.units == 3
    assert win.elapsed == pytest.approx(12.0)
    assert win.rate() == pytest.approx(30 / 12.0)


def test_window_stays_open_until_a_unit_ends_after_seconds():
    clock = Clock()
    win = Window(5.0, clock)
    win.start()
    clock.t += 4.999
    assert win.done(1)
    clock.t += 0.002
    assert not win.done(1)


def test_tail_takes_every_sample():
    clock = Clock()
    win = Window(1.0, clock)
    win.start()
    lat = [5.0, 1.0, 3.0, 2.0, 4.0, 100.0]
    for x in lat:
        win.done(1, sample=x)
    assert win.samples == lat
    assert percentile(win.samples, 50) == pytest.approx(np.percentile(lat, 50))
    assert percentile(win.samples, 95) == pytest.approx(
        np.percentile(lat, 95))
    assert percentile(win.samples, 95) > 4.0


def test_spread_is_the_interquartile_share_of_the_median():
    vals = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    # statistics.quantiles(n=4), 'exclusive': 1.75, 3.5, 5.25
    assert spread(vals) == pytest.approx((5.25 - 1.75) / 3.5)
