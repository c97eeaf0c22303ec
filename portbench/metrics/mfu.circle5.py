"""Whole control step: counted operations of a batched step of the
circle-crossing cell over (its span time x the float32 peak)."""

from portbench.lib import layer


def read(data):
    return layer.step_mfu(data)
