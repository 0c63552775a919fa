"""Quality check of the port: the ``rawgnn``, ``srrl`` and ``cikm`` runs of
``PARITY.json``, made through the port's CLI.

    python -m ihgnn_torch.quality_parity [--model rawgnn|srrl]
        [--set quality|cikm] [--dataset DIR] [--seeds N] [--epochs 60]
        [--emb 32] [--device cuda] [--out Results/quality_parity.json]

The quality set (``--set quality``, the default) is written by the port's
``write_synthetic_dataset`` (seed 7; 1500/800/3000 users/queries/items;
vocab 2000; 12,000 logs); ``--set cikm`` writes the CIKM-shaped raw files
and runs the port's Steps 1 and 3 on them
(``data/preprocess/synth_cikm.py``, ``tools/make_cikm_synth.py``'s
defaults). Either goes into a temporary directory unless ``--dataset``
names one. The script runs ``ihgnn_torch.cli.main`` with ``--model`` for
seeds 0 .. seeds-1 (default 5 for ``srrl``, 3 otherwise, as
``PARITY.json`` has them; evaluated every 5 epochs from epoch 5, as the
JAX package's runs were), and takes each run's test metrics at its best
valid NDCG@10 epoch. It prints a row a seed with the run's seconds per
epoch, the mean and std (population, as ``PARITY.json`` has them) over
seeds beside ``PARITY.json``'s "ours" summary of the section (``srrl``
for ``--model srrl``, ``cikm`` for ``--set cikm``, ``rawgnn`` else), and
for each metric whether the port's mean lies within
2 × max(port std, JAX std) of the JAX mean; it exits 1 if one does not.
``PARITY.json`` is read, never written; the JSON result goes to ``--out``.

Inits and negative draws differ between the packages (the port draws its
weights from a ``torch.Generator``), so the comparison is of seed spreads,
not of runs.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

from ihgnn_torch import cli
from ihgnn_torch.data.artifacts import write_synthetic_dataset
from ihgnn_torch.data.preprocess.synth_cikm import CIKM_SET, make_cikm_set

QUALITY_SET = dict(seed=7, user_count=1500, query_count=800, item_count=3000,
                   vocab_size=2000, log_count=12000)
METRICS = ("hr", "ndcg", "map", "mrr")
ROOT = pathlib.Path(__file__).resolve().parent.parent


def card_text(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them; the
    device's name otherwise."""
    if not device.startswith("cuda"):
        return device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi rc {smi.returncode}: "
                           f"{smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def parity_section(model: str, dataset_set: str) -> str:
    """The ``PARITY.json`` section a run is held against."""
    if dataset_set == "cikm":
        if model != "rawgnn":
            raise ValueError("PARITY.json's cikm runs are RawGnn's")
        return "cikm"
    return model


def run_seed(dataset: str, epochs: int, seed: int, emb: int, device: str,
             result_dir: str, model: str = "rawgnn") -> dict:
    """One CLI run; its best-valid-epoch test metrics and its times."""
    t0 = time.perf_counter()
    mc = cli.main(["--dataset", dataset, "--epoch_count", str(epochs),
                   "--epoch_start_test", "5", "--epoch_test_frequency", "5",
                   "--seed", str(seed), "--emb", str(emb), "--model", model,
                   "--result_dir", result_dir, "--device", device])
    run_s = time.perf_counter() - t0
    epoch, test, _ = mc.get_valid_best(lambda m: m.NDCG_at10)
    stats = mc.epoch_stats
    train_s = [s.train_s for s in stats]
    eval_s = [s.eval_s for s in stats if s.eval_s is not None]
    steps = stats[0].steps
    return {
        "seed": seed, "epoch": epoch,
        "test": dict(zip(METRICS, (test.HitRatio_at10, test.NDCG_at10,
                                   test.MAP_at10, test.MRR_at10))),
        "run_s": run_s, "first_epoch_s": train_s[0],
        "epoch_s_median": float(np.median(train_s)),
        "epoch_s_mean": float(np.mean(train_s)),
        "steps_per_epoch": steps, "kg_steps_per_epoch": stats[0].kg_steps,
        "steps_per_s": steps / float(np.median(train_s)),
        "eval_s_median": float(np.median(eval_s)),
        "final_loss": stats[-1].avg_loss,
    }


def summarize(runs) -> dict:
    return {k: [float(np.mean([r["test"][k] for r in runs])),
                float(np.std([r["test"][k] for r in runs]))]
            for k in METRICS}


def verdict(port: dict, jax: dict) -> dict:
    """Per metric: the port's mean within 2 × max(stds) of the JAX mean."""
    out = {}
    for k in METRICS:
        (pm, ps), (jm, js) = port[k], jax[k]
        limit = 2 * max(ps, js)
        out[k] = {"diff": pm - jm, "limit": limit,
                  "within": abs(pm - jm) <= limit}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ihgnn_torch.quality_parity")
    ap.add_argument("--model", default="rawgnn", choices=("rawgnn", "srrl"))
    ap.add_argument("--set", dest="dataset_set", default="quality",
                    choices=("quality", "cikm"))
    ap.add_argument("--dataset", default="",
                    help="an artifact directory (default: the --set, "
                         "written into a temporary directory)")
    ap.add_argument("--seeds", type=int, default=None,
                    help="default 5 for srrl, 3 otherwise")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--emb", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parity", default=str(ROOT / "PARITY.json"))
    ap.add_argument("--out",
                    default=str(ROOT / "Results" / "quality_parity.json"))
    args = ap.parse_args(argv)
    section = parity_section(args.model, args.dataset_set)
    seeds = args.seeds or (5 if args.model == "srrl" else 3)

    with open(args.parity, encoding="utf-8") as f:
        jax_summary = json.load(f)[section]["summary"]["ours"]
    card = card_text(args.device)
    print(card, flush=True)
    prep = None
    with tempfile.TemporaryDirectory() as tmp:
        dataset = args.dataset
        if not dataset:
            dataset = os.path.join(tmp, "parity_ds")
            if args.dataset_set == "cikm":
                prep = make_cikm_set(dataset, **CIKM_SET)
            else:
                write_synthetic_dataset(dataset, **QUALITY_SET)
        runs = []
        for seed in range(seeds):
            r = run_seed(dataset, args.epochs, seed, args.emb, args.device,
                         os.path.join(tmp, f"results_{seed}"), args.model)
            print(f"PARITY_SEED {json.dumps(r)}", flush=True)
            runs.append(r)

    port = summarize(runs)
    checks = verdict(port, jax_summary)
    default_set = CIKM_SET if args.dataset_set == "cikm" else QUALITY_SET
    result = {"card": card, "device": args.device, "model": args.model,
              "section": section, "epochs": args.epochs, "emb": args.emb,
              "dataset": args.dataset or default_set,
              "preprocess_s": prep, "runs": runs,
              "summary": {"port": port, "jax": jax_summary},
              "verdict": checks}
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=1)

    print(f"\n{card}")
    print("| seed | best epoch | HR@10 | NDCG@10 | MAP@10 | MRR@10 | "
          "s/epoch (median) | steps/s | eval s |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in runs:
        print(f"| {r['seed']} | {r['epoch']} | " + " | ".join(
            f"{r['test'][k]:.4f}" for k in METRICS)
            + f" | {r['epoch_s_median']:.3f} | {r['steps_per_s']:.1f} | "
              f"{r['eval_s_median']:.3f} |")
    for name, s in (("port", port),
                    (f"PARITY.json {section} ours", jax_summary)):
        print(f"| {name} | | " + " | ".join(
            f"{s[k][0]:.4f} ± {s[k][1]:.4f}" for k in METRICS) + " | | | |")
    print("| within 2 × max(std) | | " + " | ".join(
        f"{'yes' if checks[k]['within'] else 'NO'} "
        f"({checks[k]['diff']:+.4f} / {checks[k]['limit']:.4f})"
        for k in METRICS) + " | | | |")
    print(json.dumps({"quality_parity": checks}))
    return 0 if all(c["within"] for c in checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
