"""Device: the share of a profiled batched step of the circle-crossing
cell with no device activity."""

from portbench.lib import layer


def read(data):
    return layer.idle_share(data)
