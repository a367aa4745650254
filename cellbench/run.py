"""Run one benchmark cell on the card and print its result line:

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of stdout is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with the reference beside its limit); the last lines of stderr are the
same checks. Exits 2 without a result when no CUDA card (or fewer than
the cell asks for) is visible, and 3 when JAX or the JAX package was
loaded. Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache = os.path.join(REPO, ".cellbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from cellbench import harness

    import torch

    chips = harness.load_json(os.path.join(
        REPO, "BENCHMARK.json"))
    chips = next((w["chips"] for w in chips["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
              f"visible", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda")
    return harness.print_result(result)


if __name__ == "__main__":
    sys.exit(main())
