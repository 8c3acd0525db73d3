#!/usr/bin/env python3
"""The benchmark of the PyTorch port of Uruv (``repro_torch``), one run.

    python3 uruvbench/run.py --workload paper-fig9b-w16k --seed 7 \
        --seconds 40 --trace 0

Runs from the root of a checkout, on one NVIDIA GPU, and prints one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and
``checks`` (each number compared, beside its limit), which also end
standard error.  Without a card it exits 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "uruvbench" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from uruvbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"uruvbench: {cell.chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    line = harness.run(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=T_START,
                       log=lambda text: print(f"uruvbench: {text}",
                                              file=sys.stderr, flush=True))
    found = harness.blocked_modules()
    if found:
        print(f"uruvbench: the run loaded {', '.join(found)}, which the port "
              "may not load", file=sys.stderr)
        return 4
    print("\n".join(harness.checks_text(line)), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
