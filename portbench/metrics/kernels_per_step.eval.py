"""Dispatch: device kernels in one profiled batched control step."""

from portbench.lib import layer


def read(data):
    return layer.kernels_per_unit(data)
