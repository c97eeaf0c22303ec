"""Forecaster (diffusion/forecaster.predict_ret_best): milliseconds a
batched step of the circle-crossing cell, from spans."""

from portbench.lib import layer


def read(data):
    return layer.span_ms(data, "forecast", "step")
