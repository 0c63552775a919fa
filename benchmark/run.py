"""Run one cell of ``BENCHMARK.json`` once on the card, from the root of a
checkout:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number ``correct`` compared with
its limit; the same numbers end standard error. The port builds its
kernels once into ``ihgnn_torch/build/`` inside the checkout, so only a
cell's first run there compiles. Without a CUDA card, or
with fewer cards than the cell asks for, or when JAX or the JAX package
was loaded, it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ihgnn_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness, spec
    cell = spec.cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", STARTED, ROOT)
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded {found} in the measuring process",
              file=sys.stderr)
        return 3
    rows = result.pop("_check_rows")
    phases = result.pop("_phases")
    print("set-up: " + ", ".join(f"{name} {t:.2f} s" for name, t in phases),
          file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for r in rows:
        print(f"check {r['name']}: {r['value']!r} <= {r['limit']!r} "
              f"({r['what']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
