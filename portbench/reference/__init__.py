"""The plain reference that decides ``correct``.

``frozen/`` is a copy of the port's plain PyTorch modules, taken whole
from sicnav_tpu_torch at commit 07a5bd7 (see README.md for the edits), so
that no later change to the program moves the yardstick. It runs in
float64 against the program's float32 wherever it can, and imports
nothing of the program. ``compare.py`` reduces the two sides to the
numbers each cell's limits hold.
"""
