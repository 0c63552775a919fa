"""The readings that a cell's limits are set from, on the card at the
cell's own size:

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,... \
        [--fault-seeds 3]

For each seed: the program as a run drives it (its first steps, or its
features and a run's sample of metric rows), the reference, and the
cell's lower-precision control (the configuration's ``control``: the
program with an option of its own switched on, or the reference computed
in a lower precision put in the program's place); and on the first
``--fault-seeds`` seeds each fault of ``faults.py`` planted in the
program. No window is timed. Prints one JSON line a reading and a summary:
each number's largest sound reading, smallest control reading and
smallest reading of each fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import compare, faults, generate, harness, program, spec
from benchmark.loops import rank, train
from benchmark.reference.precision import TF32, strict_f32


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _values(readings: dict) -> dict:
    return {k: v[0] for k, v in readings.items()}


def train_seed(run, control: dict, fault_names) -> list:
    data = train.inputs(run)
    want = None
    out = []
    sides = [("program", run.model, None)]
    if "program" in control:
        sides.append(("control", dict(run.model, **control["program"]),
                      None))
    sides += [(f"fault:{f}", run.model, f) for f in fault_names]
    batches = None
    graph = program.build_graph(run.model, run.sizes, data["uqi"])
    for side, model, fault in sides:
        # each side draws the same batches from a fresh copy of the streams
        fresh = dict(data, rngs=generate.streams(run.seed))
        with faults.planted("train", fault):
            prog = train.build(run, fresh, model, graph)
            got, got_batches = train.first_steps(run, prog)
            train.close_feed(prog)
            del prog
        run.free()
        batches = batches or got_batches
        if want is None:
            want = train.reference(run, data, batches)
        readings = compare.train_readings(got, want)
        if side == "program":
            readings["change_by_leaf"] = (0.0, json.dumps(compare.leaf_gaps(
                got["change_norms"], want["change_norms"])))
        out.append((side, readings))
        run.free()
    if control.get("reference") == "tf32":
        low = train.reference(run, data, batches, TF32)
        out.append(("control", compare.train_readings(low, want)))
    return out


def rank_seed(run, control: dict, fault_names) -> list:
    data = train.inputs(run)
    out = []
    sides = [("program", run.model, None)]
    if "program" in control:
        sides.append(("control", dict(run.model, **control["program"]),
                      None))
    sides += [(f"fault:{f}", run.model, f) for f in fault_names]
    graph = program.build_graph(run.model, run.sizes, data["uqi"])
    for side, model, fault in sides:
        # each side draws the same logs from a fresh copy of the streams
        fresh = dict(data, rngs=generate.streams(run.seed))
        with faults.planted("rank", fault):
            prog = rank.build(run, fresh, model, graph)
            logs = prog["logs"]
            n = logs["users"].shape[0]
            seen = rank.TruthScores(rank.sample(run, n))
            feats = prog["features_fn"]()
            rows = np.zeros(logs["truth"].shape[:2] + (4,), np.float32)
            with program.watch_scores(seen):
                for j in sorted(seen.picked):
                    seen.at = j
                    rows[j] = prog["metrics_fn"](
                        feats, *rank.batch(logs, j)).cpu().numpy()
            scores = seen.host()
            del prog, seen
        run.free()
        readings = rank.reference(run, data, logs, rows, scores, feats)
        del feats
        run.free()
        out.append((side, readings))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault-seeds", type=int, default=3)
    args = p.parse_args(argv)
    strict_f32()
    program.build_kernels(torch.device("cuda"))
    cell = spec.cell(args.workload)
    kind = cell["traffic"]["kind"]
    control = cell["config"].get("control", {})
    seeds = [int(s) for s in args.seeds.split(",")]
    summary: dict = {}
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, 0, False, torch.device("cuda"), t0)
        names = faults.FAULTS[kind] if k < args.fault_seeds else ()
        sides = (train_seed if kind == "train" else rank_seed)(
            run, control, names)
        for side, readings in sides:
            _emit({"workload": args.workload, "seed": seed, "side": side,
                   "readings": readings})
            for name, value in _values(readings).items():
                summary.setdefault(side, {}).setdefault(name, []).append(
                    value)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    out = {"workload": args.workload, "seeds": len(seeds)}
    for side, numbers in summary.items():
        pick = max if side == "program" else min
        out[side] = {name: pick(v) for name, v in numbers.items()}
    _emit({"summary": out})
    return 0


if __name__ == "__main__":
    sys.exit(main())
