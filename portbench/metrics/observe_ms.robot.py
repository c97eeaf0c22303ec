"""Streaming controller (realtime: the resample, the state build, one
pinned copy): milliseconds a tick, from spans."""

from portbench.lib import layer


def read(data):
    return layer.span_ms(data, "observe", "tick")
