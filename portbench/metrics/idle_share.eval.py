"""Device: the share of a profiled batched step with no device activity."""

from portbench.lib import layer


def read(data):
    return layer.idle_share(data)
