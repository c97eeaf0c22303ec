"""Dispatch: device kernels in one profiled tick."""

from portbench.lib import layer


def read(data):
    return layer.kernels_per_unit(data)
