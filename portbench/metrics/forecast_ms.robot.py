"""Forecaster (diffusion/forecaster.predict_ret_best): milliseconds a tick,
from spans."""

from portbench.lib import layer


def read(data):
    return layer.span_ms(data, "forecast", "tick")
