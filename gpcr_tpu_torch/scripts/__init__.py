"""The port's benchmark and demo entry points (twins of the repository's
``scripts/``), each run as ``python -m gpcr_tpu_torch.scripts.<name>``:
``bench_matrix``, ``bench_pcrender``, ``bench_train_step`` and
``train_demo``. The headline benchmark is ``gpcr_tpu_torch/bench.py``."""

import torch


def require_device(device) -> torch.device:
    """``device`` as a torch device; raises for CUDA without a card (an
    entry point runs on the card unless asked for the CPU, and never
    falls back to it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev
