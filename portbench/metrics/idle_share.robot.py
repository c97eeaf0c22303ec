"""Device: the share of a profiled tick with no device activity."""

from portbench.lib import layer


def read(data):
    return layer.idle_share(data)
