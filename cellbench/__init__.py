"""cellbench: the benchmark of the PyTorch and CUDA renderer
(``gpcr_tpu_torch``). Run one cell with

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Cells, configurations, traffic mixes and metrics are files found by name
(``workloads/``, ``configs/``, ``traffic/``, ``metrics/``); the plain
reference that decides ``correct`` is in ``reference/``."""
