"""portbench: the benchmark of sicnav_tpu_torch, the PyTorch and CUDA port.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on the machine it is started on and
prints one JSON line. Cells, configurations, drivers and per-layer metric
readers are files found by name (see README.md).
"""
