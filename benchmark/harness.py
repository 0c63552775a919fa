"""One run of one cell: set-up, window, trace, check, result line.

``run_cell`` takes a resolved cell (``spec.cell``) and runs its loop
(``benchmark/loops/<kind>.py``), which returns the run's record: what
the metric readers read, and the numbers ``correct`` compares. The
loop builds the program, drives it through the cell's first steps,
measures ``seconds`` of steady work (nothing compiles inside), profiles
a bounded slice after the window when ``trace`` is on, reads the peak
memory, frees the program and then runs the reference.
"""

from __future__ import annotations

import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark import spec
from benchmark.reference.precision import strict_f32


class Run:
    """What a loop needs: the cell, the seed, the window, the device,
    the clock, and (for the fault tests) a fault to plant."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: torch.device, started: float,
                 fault: Optional[str] = None):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.started = started
        self.fault = fault
        config = cell["config"]
        self.model = config["model"]
        self.train = config.get("train", {})
        self.sizes = config["deployment"]
        self.traffic = cell["traffic"]
        self.limits = cell["limits"]
        self.phases = []

    def mark(self, phase: str) -> None:
        """Record the seconds since the process started at the end of a
        set-up phase (reported on standard error, not in the result)."""
        self.phases.append((phase, time.perf_counter() - self.started))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self) -> float:
        return time.perf_counter()

    def peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def reset_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def free(self) -> None:
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out.stdout.strip() if out.returncode == 0 else "not measured"


def device_info(run: Run, record: dict) -> dict:
    dev = run.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": run.cell["chips"],
            "memory_peak_bytes": record["memory_peak_bytes"]}
    if dev.type == "cuda":
        info["power_limit"] = power_limit()
    tr = record.get("trace")
    if run.trace and tr:
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
    return info


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device, started: float, root: Path = spec.ROOT,
             fault: Optional[str] = None) -> dict:
    """The result line's object, with ``checks`` last."""
    strict_f32()
    run = Run(cell, seed, seconds, trace, torch.device(device), started,
              fault)
    record = spec.loop(cell["traffic"]["kind"]).run(run)
    entries = cell["per_layer"] if trace else cell["end_to_end"]
    result = {"correct": record["correct"],
              "attempted": record["attempted"],
              "failed": record["failed"],
              "metrics": spec.read_metrics(entries, record, root),
              "device": device_info(run, record)}
    tr = record.get("trace")
    if trace and tr:
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["_phases"] = run.phases
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in record["checks"]}
    result["_check_rows"] = record["checks"]
    return result
