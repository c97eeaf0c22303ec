"""KDE kernel (ops/kde_cuda -> csrc/kde.cu): share of its roofline in a
profiled batched step."""

from portbench.lib import layer


def read(data):
    return layer.kde_roofline(data)
