"""KDE kernel (ops/kde_cuda -> csrc/kde.cu): share of its roofline in a
profiled batched step of the circle-crossing cell."""

from portbench.lib import layer


def read(data):
    return layer.kde_roofline(data)
