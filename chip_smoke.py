#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ihgnn_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --reference ROOT    # also time ROOT's build
    python3 chip_smoke.py --features [ROOT]   # serving forward times only
    python3 chip_smoke.py --k1_skew           # K1 on the zipf cell's hubs

Phases, each printing one JSON line; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``); TF32 off;
2. build the CUDA kernels from ``ihgnn_torch/csrc`` (one nvcc per source,
   in parallel);
3. check and time each kernel against its plain PyTorch twin at the
   shapes the serving and training paths give it, on a seeded graph of
   ``bench.py``'s shape (U/Q/I/V = 200k/100k/400k/100k, E = 2M, d = 32,
   4 words per query): K1 for the node update, the bag mean and the three
   backward sums, K2, K3 forward (its tensor-core form, with its f32-core
   form timed on the same inputs) and ``interact_bwd`` at orders 3 and 1;
4. the serving path: ``RawGnn`` at the default config (two IHGNN layers,
   orders 3 and 1, d = 32, seeded random weights) → ``make_eval_fns`` →
   one full-graph forward → ``evaluate`` over 4096 synthetic logs in
   batches of 256; every kernel of the path must have launched; then
   FEATURE_REPEATS more warm forwards, timed on the host and the device
   clock (medians and spreads);
5. one forward and one eval batch, each under ``torch.profiler`` (after
   a warm-up run): device time by kernel, the device's idle share, the
   costliest host operators, the port's spans;
6. the same model on a small graph, on the card and on the CPU (plain
   twins), must agree;
7. the train path: ``make_train_step`` with Adam on the same graph and
   model, batches of 1024 positives x 10 negatives built as ``bench.py``
   builds them; 2 warm steps, then 10 timed steps; every kernel of the
   path must have launched and every loss must be finite;
8. one warm train step under ``torch.profiler``; then
   ``repeatable_full_width``: two full-width train steps from the same
   seeded state and batch, compared bit for bit (loss, gradients,
   parameters);
9. three train steps on a small graph, on the card and on the CPU, from
   the same weights and batches, must agree: the losses, every
   parameter's step-0 gradient and the parameters after the last step; a
   second card run says whether the card repeats itself bit for bit;
10. the GAT serving path: ``RawGnn`` with two concat-head ``GATLayer``s
    (d = 32) over the uqi 2D graph of the same interactions (N = 700k,
    about 12M coalesced entries), one full-graph forward, then
    ``evaluate`` as in phase 4; K1, K4 and the scalar segment sum must
    have launched;
11. the GAT train path as in phase 7, on the 2D graph; K1, K4, the scalar
    sum and ``csr_edge_dot`` must have launched; then one warm GAT train
    step under ``torch.profiler``, and ``repeatable_gat_full_width``: two
    full-width GAT train steps from the same seeded state and batch,
    compared bit for bit as in phase 8 (reported, not held);
12. the layer zoo on a small graph, card against CPU as in phase 9: GCN,
    GAT (concat and product heads), HGCN on the hypergraph and on the log
    hypergraph, and IHGNN with phase-2 attention;
13. ``cli``: the training CLI as a user runs it, ``ihgnn_torch.cli.main``
    on the quality set of ``ihgnn_torch.quality_parity`` (written by the
    port's ``write_synthetic_dataset``): 4 epochs of the default model,
    tested from epoch 2 every 2, with ``--storecheckpoint --storemetrics``
    and epoch 2 under ``torch.profiler``; a ``--checkpoint latest`` resume
    for 2 more epochs; then ``--gnn gat`` for 1 tested epoch. It reports
    seconds per epoch, steps/s, eval seconds and the profiled epoch's
    device idle share and the port's spans, and fails unless the
    resume runs epochs 5 and 6 from exactly the saved state (parameters,
    Adam's moments and steps, the learning rate), the log and metrics
    files exist, the average loss falls over the first 4 epochs, the
    metrics are in [0, 1] and every kernel's launches equal the runs'
    steps and test forwards times the model's counts.

Phase 3 also times K1's node update on the ``ihgnn.train.zipf`` cell's
own graph, whose hubs K1 sums with a block each, beside the same launch
without its long segments (bit for bit; ``--k1_skew`` runs this row
alone). It also checks K4 ``csr_segment_max`` and the scalar
``csr_segment_sum`` at the GAT (12M entries → 700k) and phase-2 (6M →
700k) shapes and on a skewed CSR (a few segments of 10k-1M entries among
empty and short ones; the sum bit for bit in its order of adds,
``csr_segment_sum_ordered``), ``csr_edge_dot`` at the GAT backward's
shape (repeated bit for bit; beside its bound a model of its design's
bytes, ``b`` once a wave of blocks, and its time with the columns folded
into an L2-resident part of ``b``) and K1 at the GAT weighted sum's; and
the routed path's kernels on the routed pack of the 2M-edge graph
(``build_hypergraph(..., pack_kernels=True)``, grid [2048, 1024],
e_pad = 2,097,152): K2's single-index forms, the K6/K7 permute forms
(f32 and bf16), K5 forward (both forms) and backward at orders 3 and 1
with the σ-pad mask (the backward also bit for bit equal to
``interact_bwd`` on the pre-permuted inputs, which is timed beside it),
K1's three-region form, K8 on the node-update stream (and
``torch.sparse.mm`` beside it, timed in turns SCAN_REPEATS times each),
and K1 over one CSR spanning two such
edge-chunk streams (``csr_segment_sum3_multi``'s shape). Between phases
9 and 10 the routed path runs as the direct one did, with the same
weights and batches: ``routed_serving`` (its features within 1e-4 of the
direct path's, its metrics equal), ``routed_scan`` (the first layer's
node-update stream summed by K8, equal to K1's sum), ``routed_train``
(its step-0 loss within 1e-4 relative of the direct path's) and a
profiled routed train step, then ``small_routed_reference`` (the default
model, HGCN and phase 2 on a small packed graph, card against CPU as in
phase 9). Every launch count of a routed path is checked exactly.

The bf16 streams and remat (``ModelConfig.bf16_stream``, ``remat``):
phase 3 also holds each bf16 form against its twin at the full-width
shapes (K2 writing bf16 roles, K1 on bf16 rows for the node update, the
gather's and the scatter's backward, K3 and ``interact_bwd`` on bf16
roles at orders 3 and 1: no bf16 output element off by more than 1 bf16
ulp), timed beside bf16 bounds. After phase 5, ``bf16_serving`` runs the
default model with ``bf16_stream`` on the same graph, weights and logs as
``serving``; after phase 9, ``bf16_train`` trains it as ``train`` does,
``bf16_vs_f32`` holds its features within BF16_FEATURE_RTOL of the f32
features' largest value (the metrics and the step-0 losses reported side
by side), ``remat_train`` and ``remat_bf16_train`` train with remat (f32
and bf16), each followed by ``*_equals_no_remat``, a full-width step with
remat held bit for bit to the same step without it (loss, gradients,
parameters), and ``small_bf16_reference`` holds the bf16 + remat model's
train steps on the card to the CPU (BF16_SMALL_TOL). Phase ``cli`` ends
with one tested ``--bf16_stream --remat`` epoch. Every launch count of a
bf16 or remat path is checked exactly: a wrapper counts its f32 forms in
``launches`` and its bf16 forms in ``launches_bf16`` (``name_bf16`` in
the JSON rows).

The routed pack on bf16 streams (``bench.py``'s default path): phase 3
also holds the routed pack's bf16 forms at its full-width shapes
(``gather_rows[_t]`` writing bf16 rows, K1's three-region form on bf16
regions into f32 and into bf16, K5 forward and backward on bf16 roles at
orders 3 and 1, the backward bit for bit ``interact_bwd``'s bf16 form on
the pre-permuted inputs, K8 on a bf16 stream bit for bit the bf16
three-region K1; K6/K7's bf16 rows as ``name_bf16``). After
``small_routed_reference``: ``routed_bf16_serving`` (the default model
with ``bf16_stream`` on the routed pack), ``routed_bf16_scan`` (the
first layer's bf16 node-update stream, K8 bit for bit the bf16
three-region K1), ``routed_bf16_train`` and a profiled routed bf16 step,
``routed_bf16_vs_direct_bf16`` (features within BF16_FEATURE_RTOL of the
direct bf16 features' largest, step-0 losses within
ROUTED_BF16_LOSS_RTOL), ``small_routed_bf16_reference`` (the default
model and phase 2 on a small packed graph with bf16 streams, card against
CPU, BF16_SMALL_TOL) and ``routed_bf16_remat_equals_no_remat`` (a
full-width routed bf16 step with remat bit for bit the step without it).
Every launch count of a routed bf16 path is checked exactly. A profile
window runs its step twice, a warm-up the profiler discards, then the
recorded one, and lists the kernels of the exported trace beside the
profiler's events.

K1's bf16 forms have two lane widths (``bf16_form``): each row of the
16-byte lanes also times the same call on rows 8 bytes off a 16-byte
boundary, which take the 8-byte lanes (``eight_byte_ms``), and holds the
two bit for bit; the direct bf16 rows also time the same call with the
ids sorted (``sorted_ids_ms``: the same segment lengths, the rows read in
order). Phase 3 also holds K1's bf16 form over the two-chunk
spanning CSR (``csr_segment_sum3_multi``'s bf16 shape).

``--reference ROOT`` (another checkout, e.g. the parent unpacked with
``git archive``) ROOT's ``csrc/segsum.cu``, ``csrc/interact_bwd.cu`` and
``csrc/gather.cu`` are built beside this checkout's, and each row of
their bf16 forms (K1's, the backward's and K2's) and of the f32
backwards (``interact_bwd``'s, K5's) also carries ``parent_ms``: the same
call on the same inputs through ROOT's build. The
bf16 backward rows (``interact_bwd`` and K5's) time the fixed-order sum
over the chunks' partials alone (``reduce_ms``; the fused kernel takes
the rest); K2's bf16 row times the copy from a ready bf16 x
(``x_bf16_ms``) and the rounding of the f32 x alone (``round_ms``).

Srrl and preprocessing (no hand-written kernel runs on either; a Srrl
phase fails if one launched). Phase ``cli`` also runs ``--model srrl``
for CLI_SRRL_EPOCHS (tested, ``--storecheckpoint``) and its ``--checkpoint
latest`` resume, held to the saved state bit for bit. After it:
``srrl_data`` (a ``GraphData`` of one single-positive log a (u, q, i) of
the seeded 2M draw), ``srrl_serving`` (``Srrl``, the MLP scorer, d = 32,
seeded weights: ``all_features`` timed as ``run_serving`` times the
forward, ``evaluate`` over the serving logs in ``run_srrl``'s eval batch,
one eval batch under ``torch.profiler``), ``srrl_train`` (``MetaPaths``
over the 2M positives, KG steps of 1024 x 10 by mode and PS steps of
1024 x 10, CUDA-event and host-issue times; a KG step with its sampling
and a PS step under ``torch.profiler``), ``small_srrl_reference`` (tail,
head and query KG steps, then 3 PS steps on a small split, card against
CPU: losses, every step-0 gradient of both phases, the unused KG heads'
zero gradients included, and the parameters) and ``preprocess`` (the
port's CIKM writer at CIKM_SMALL through Steps 1 and 3 and one tested CLI
epoch on the card from those artifacts, launches exact; the Amazon
fixture through the three module CLIs; host seconds of each step).

The chunked pack and the routed 2D graph (after
``routed_bf16_remat_equals_no_remat``): ``chunked_data`` builds the JAX
package's stress graph (``STRESS_r05.json``: U/Q/I/V = 1M/500k/2M/200k,
E = 10M, d = 32, seeded) and its pack, ``ChunkedHyperPack`` of 5 chunks
(``pack_s``, each chunk's grid); phase 3's rows of
``csr_segment_sum3_multi`` (K1's three-region form over the CSR spanning
the 5 chunks, f32 and bf16) run at that shape; ``stress_serving`` and
``chunked_serving`` (the default model in f32, direct and chunked:
features within 1e-4, metrics equal, ``chunked_vs_direct``);
``stress_bf16_train`` and ``chunked_bf16_train`` (the stress
configuration's bf16 streams, 2 warm and 10 timed steps of 1024 x 10, a
profiled chunked step; ``chunked_bf16_vs_direct_bf16``: features within
2e-2 of the largest, step-0 losses within 1e-3); ``small_chunked_reference``
(a small graph chunked at ``chunk_rows_cap=16``, card against CPU). The
bench 2D graph is also built with ``pack_kernels=True``
(``routed_2d_data``: the role pack's grid and the GAT packs, split by
source region, with ``pack_s``); phase 3 adds K2's d = 1 form
``gather_scalars`` on a GAT pack's destination table and K2 at the routed
2D shapes; after ``repeatable_gat_full_width``: ``routed_gat_serving`` and
``routed_gat_train`` (two concat-head layers through ``RoutedGatConvFn``,
a profiled step; ``routed_gat_vs_direct``: features within 1e-4 of the
direct GAT's, step-0 loss within 1e-4), ``routed_gcn`` (two GCN layers,
one forward and 2 steps through ``RoutedSpmmFn`` against ``SpmmFn``) and
``small_routed_2d_reference`` (GCN, GAT with both heads and on a
``ChunkedGatPack``, card against CPU). Every launch count of these paths
is exact; on the chunked paths K1's three-region launches are
``csr_segment_sum3_multi``'s in the kernels line.

``fault_3_1`` (after the build): the interaction's step-0 dW at
FAULT31_EDGES edges of SMALL's nodes, direct (K3's ``interact_bwd``) and
chunked (K5's ``interact_bwd_absorb``), the f32 forwards' outputs (K3's
``interact_fwd``, K5's ``interact_fwd_absorb``, orders 3 and 1) and the
dW of ``interact_bwd``'s bf16 form on bf16 streams, the card's kernel and
the CPU's twin each against float64 on the same inputs; the card's f32
rows held at SMALL_GRAD_RTOL, the bf16 dW at 1e-2 (with ``--reference``,
the reference build's f32 backward reported beside it, and its time as
``parent_ms`` on the f32 backward rows of phase 3). ``small_chunked_scale`` is held at phase 9's limits.

Data parallelism over the edge axis (``ihgnn_torch/parallel``), after
``cli``: SHARDED_RANKS ranks, spawned processes that load the kernels
built above and share the card over gloo (NCCL refuses two ranks on one
GPU). ``sharded_small_reference`` (SMALL's nodes, padded edges, direct
and per-rank routed packs: card ranks against CPU ranks at phase 9's
limits and against one rank on the card within SHARDED_RTOL),
``sharded_train`` (the bench graph, E / SHARDED_RANKS edges a rank, f32
and then bf16 streams over the bf16 wire) and ``sharded_routed_train``
(per-rank routed packs), each against one rank on the card, every rank's
launches exact, the ranks' step and collective times and peak memory
reported (not a multi-card time: the ranks share the card), and
``cli_mesh`` (``torchrun -m ihgnn_torch.cli --mesh_data SHARDED_RANKS``
on the quality set and a resume, each rank's ``--run_record``, held
against phase cli's run; then ``--gnn gat`` for an epoch, its loss and
test metrics held to phase cli's GAT run). ``sharded_small_reference``
also runs GAT (both heads), phase 2 (direct and routed), the log
hypergraph and per-rank chunked packs; after ``sharded_train``,
``sharded_gat_train``, ``sharded_phase2_train`` (direct, then per-rank
routed packs), ``sharded_log_train`` and ``sharded_chunked_train`` (bf16
streams over the bf16 wire, per-rank packs in chunks) run at full width,
each against one rank on the card: features and step-0 gradients within
SHARDED_RTOL of scale, step-0 loss SHARDED_RTOL relative, each rank's
launches exact, its step, collective and scalar all-reduce times
reported. The kernels line counts the launches of every rank. Every
sharded phase prints one ``collective_stats`` line a step (rank 0's
counts and bytes of each collective kind, ``ihgnn_torch/utils/
collective_stats.py``) and holds every rank's every step to the counts
``expected_collectives`` predicts for its path and mesh.

The model axis (``ihgnn_torch/parallel/tables.py``: the embedding
tables' rows and their Adam moments over ranks), after the sharded
phases: ``sharded_model_small_reference`` (SMALL, card ranks against CPU
ranks and one rank as ``sharded_small_reference`` holds them, at (2, 2),
(1, 4) and (2, 2) with the rows over every rank, then at (2, 2) bf16
streams over the bf16 wire, per-rank routed packs and GAT),
``sharded_model_train`` (the bench graph at (2, 2), (1, 4), (2, 2) with
the rows over every rank, and (2, 2) bf16; features and step-0 gradients
within SHARDED_RTOL of scale with the tables assembled, the step-0 loss
within MODEL_LOSS_RTOL; step, collective and table-gather times, peak
memory and persistent parameter and Adam bytes a rank reported),
``dryrun`` (``ihgnn_torch.entry``: ``entry()``'s forward, then
``dryrun_multichip(SHARDED_RANKS)``); then ``cli_mesh`` resumes its
first run's checkpoint at ``--mesh_data 2 --mesh_model 2 --multihost``
as two torchrun nodes of 2 ranks on 127.0.0.1 (held equal to a one-rank
resume from the same file: loss within CLI_MESH_LOSS_RTOL, test metrics
equal) and runs ``--model srrl --mesh_data 2`` (held to phase cli's Srrl
run the same way). Every sharded phase's card ranks run in one spawn
(``run_sharded``).
``gather_scalars`` (one GAT pack) and ``gather_rows_t`` (the routed GCN's
grid) also carry the device time of their kernels alone and of
``index_select``, from the profiler (``device``, ``library_device``).

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

U, Q, I, VOCAB, E, D, WORDS = 200_000, 100_000, 400_000, 100_000, 2_000_000, 32, 4
EVAL_LOGS, EVAL_BATCH = 4096, 256
TRAIN_B, TRAIN_K, WARM_STEPS, TIMED_STEPS = 1024, 10, 2, 10
SMALL = dict(users=40, queries=25, items=60, vocab=30, edges=300)
SMALL_STEPS, SMALL_B = 3, 16
# card against CPU after SMALL_STEPS Adam steps: Adam moves an element by
# about lr (1e-3) whatever its gradient's size, so rounding in a tiny
# gradient shows in the parameter at lr scale
SMALL_LOSS_RTOL, SMALL_PARAM_ATOL = 1e-4, 1e-4
# step-0 gradients, card against CPU: each within this share of the
# tensor's largest value (f32 sums over a few hundred terms in another
# order). Adam all but ignores a gradient's scale, so the parameters alone
# would miss a backward that is off by a constant factor
SMALL_GRAD_RTOL = 1e-5
# features of the small graph, card against CPU (as phase 6)
SMALL_FEATURE_ATOL = 1e-4
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, dense TF32 and bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
WARMUP, REPS = 3, 20
# K8 and torch.sparse.mm, timed in turns this many times each
SCAN_REPEATS = 7
# warm serving forwards timed after a serving path's checks
FEATURE_REPEATS = 9
# csr_edge_dot is also timed with its columns folded into this many rows
# of b, a table that L2 holds
L2_RESIDENT_ROWS = 100_000


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``t_s``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(nbytes: float, flops: float, tf32_flops: float = 0.0,
          bf16_flops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and the
    operations' time: ``flops`` over the f32 rate, ``tf32_flops`` (the
    FLOPs of products run on the tensor cores in 3xTF32, three TF32
    products each) times 3 over the TF32 rate, and ``bf16_flops`` (bf16
    products on the tensor cores, one pass) over the bf16 rate; the pipes
    run side by side, so the operations take the longest of them."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS, 3 * tf32_flops / TF32_FLOPS,
                bf16_flops / BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_features(torch, features_fn) -> dict:
    """FEATURE_REPEATS warm calls of ``features_fn``: each call's host
    time until the card has run it, and its device time by CUDA events
    (ms; medians and spreads)."""
    host, device = [], []
    for _ in range(FEATURE_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        features_fn()
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        device.append(start.elapsed_time(end))
    return {"features_repeats_ms": host,
            "features_ms_median": float(np.median(host)),
            "features_ms_spread": max(host) - min(host),
            "features_device_repeats_ms": device,
            "features_device_ms_median": float(np.median(device))}


def time_ms(torch, fn) -> float:
    """Mean device time of ``fn`` over REPS launches, by CUDA events."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def kernel_device_ms(torch, fn, calls=20) -> dict:
    """The device time a call of ``fn`` takes in kernels, from a
    ``torch.profiler`` trace of ``calls`` warm calls: the sum of the
    trace's kernel spans over the calls (a wrapper's host issue between
    launches counts nothing), and the kernels by name with their launches
    a call."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calls.trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            spans = [e for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "kernel"]
    by_name = {}
    for e in spans:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    if not spans:
        return {"ms": "not measured: the trace has no kernel events"}
    return {"ms": sum(e["dur"] for e in spans) / 1e3 / calls,
            "kernels": [{"name": k[:70], "ms": ms / calls,
                         "launches": n / calls}
                        for k, (ms, n) in by_name.items()]}


# --reference ROOT: {stem: ROOT's build of csrc/<stem>.cu}
REFERENCE = {}
REFERENCE_STEMS = ("segsum", "interact_bwd", "gather")


def parent_ms(torch, stem, run) -> dict:
    """``{"parent_ms": t}``, the device time of ``run(builds, lib)`` with the
    reference checkout's build ``lib`` of ``csrc/<stem>.cu`` (``--reference``)
    and ``builds`` the module ``ihgnn_torch.compare_builds``, whose ``run_*``
    call a build's C entry points; ``{}`` without one."""
    lib = REFERENCE.get(stem)
    if lib is None:
        return {}
    from ihgnn_torch import compare_builds
    return {"parent_ms": time_ms(torch, lambda: run(compare_builds, lib))}


def reduce_ms(torch, w, edges):
    """The device time (ms) of ``reduce_partials_kernel`` alone over the
    partials of a backward of ``edges`` edges with weights ``w``: the
    backward's time less this is its fused kernel's."""
    import ctypes
    from ihgnn_torch.ops import _build
    from ihgnn_torch.ops.interact import CHUNK_EDGES
    chunks = -(-edges // CHUNK_EDGES)
    n = (w.shape[0] + 1) * w.shape[1]
    partial = torch.randn(chunks, n, device=w.device)
    out = torch.empty(n, device=w.device)
    fn = _build.function("interact_bwd", "ihgnn_reduce_partials",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                         + [ctypes.c_void_p])

    def run():
        _build.check("interact_bwd", "reduce_partials", fn(
            partial.data_ptr(), out.data_ptr(), chunks, n,
            _build.stream_ptr(w.device)))
    return time_ms(torch, run)


def rows_at(torch, x, offset_bytes):
    """A contiguous copy of ``x`` whose data begins ``offset_bytes`` past a
    16-byte boundary (a row view aligned to 8 bytes only, for 8)."""
    n = offset_bytes // x.element_size()
    buf = torch.empty(x.numel() + n, dtype=x.dtype, device=x.device)
    view = buf[n:].view(x.shape)
    view.copy_(x)
    return view


def _wrappers():
    """The kernel wrappers, whose ``launches`` counts the phases read."""
    from ihgnn_torch.ops.launches import wrappers
    return wrappers()


def _zero_launches():
    from ihgnn_torch.ops.launches import zero_launches
    zero_launches()


def _launch_counts():
    """Every wrapper's counts since ``_zero_launches``: ``name`` its f32
    forms' launches, ``name_bf16`` its bf16 forms' (the wrappers that have
    bf16 forms)."""
    from ihgnn_torch.ops.launches import launch_counts
    return launch_counts()


def _read_launches(path, expected):
    """Every count of ``_launch_counts``; fails when a kernel of
    ``expected`` was not launched on ``path``."""
    launches = _launch_counts()
    for name in expected:
        if launches[name] <= 0:
            fail(f"{name} was not launched on the {path} path")
    return launches


def random_graph(users, queries, items, edges, seed, pack_kernels=False):
    """(CPU ``HyperGraph``, its ``[E, 3]`` (u, q, i) rows); with
    ``pack_kernels`` the graph carries the routed pack."""
    from ihgnn_torch.graph import build_hypergraph
    rng = np.random.default_rng(seed)
    uqi = np.stack([rng.integers(0, users, edges),
                    rng.integers(0, queries, edges),
                    rng.integers(0, items, edges)], axis=1)
    return build_hypergraph(uqi, users + queries + items, users, queries,
                            pack_kernels=pack_kernels), uqi


def train_batch(uqi, items, batch, negs, seed):
    """A training batch as ``bench.py`` builds it: ``batch`` positives drawn
    from the graph's edges, each with ``negs`` uniform negative items."""
    from ihgnn_torch.data.dataset import Batch
    r = np.random.default_rng(seed)
    idx = r.integers(0, len(uqi), batch)
    rows = batch * (1 + negs)
    users = np.zeros(rows, np.int32)
    queries = np.zeros(rows, np.int32)
    its = np.zeros(rows, np.int32)
    flags = np.zeros(rows, np.float32)
    users[:batch] = uqi[idx, 0]
    queries[:batch] = uqi[idx, 1]
    its[:batch] = uqi[idx, 2]
    flags[:batch] = 1.0
    users[batch:] = np.repeat(users[:batch], negs)
    queries[batch:] = np.repeat(queries[:batch], negs)
    its[batch:] = r.integers(0, items, batch * negs)
    return Batch(users=users, queries=queries, items=its, flags=flags,
                 weight=np.ones(rows, np.float32))


def random_words(queries, vocab, seed):
    rng = np.random.default_rng(seed)
    qw = rng.integers(1, vocab + 1, size=(queries, WORDS)).astype(np.int32)
    return qw, np.full(queries, WORDS, np.int32)


def random_eval_logs(users, queries, items, count, seed):
    from ihgnn_torch.data.collections import SearchLogCollection
    from ihgnn_torch.data.dataset import EvalLogs
    from ihgnn_torch.data.schema import SearchLog
    rng = np.random.default_rng(seed)
    logs = SearchLogCollection()
    for n in range(count):
        k = int(rng.integers(1, 6))
        flags = [int(f) for f in rng.integers(0, 2, k)]
        flags[0] = 1
        logs.append(SearchLog(
            int(rng.integers(0, users)), int(rng.integers(0, queries)),
            f"t{n:08d}", [int(x) for x in rng.integers(0, items, k)],
            [1] * k, list(range(k)), flags, [f"t{n:08d}.{j}" for j in range(k)]))
    return EvalLogs(logs)


def record_row(torch, results, name, shape, err, tol, k_fn, p_fn, l_fn,
               nbytes, flops, lib_err=None, tf32_flops=0.0, bf16_flops=0.0,
               **extra):
    """Fails unless ``err <= tol``; times the kernel, its plain twin and the
    library call; emits one ``kernel_check`` row and keeps it in
    ``results[name]``. ``flops`` run on the f32 cores, ``tf32_flops`` on
    the tensor cores in 3xTF32 and ``bf16_flops`` on them in bf16 (see
    ``bound``)."""
    if not err <= tol:
        fail(f"{name} at {shape}: max error {err} > {tol}")
    b_ms, b_by = bound(nbytes, flops, tf32_flops, bf16_flops)
    if tf32_flops:
        extra.update(bound_bytes_ms=bound(nbytes, 0)[0],
                     bound_tf32_ms=3 * tf32_flops / TF32_FLOPS * 1e3,
                     bound_f32_cores_ms=(flops + tf32_flops)
                     / F32_FLOPS * 1e3)
    if bf16_flops:
        extra.update(bound_bytes_ms=bound(nbytes, 0)[0],
                     bound_bf16_ms=bf16_flops / BF16_FLOPS * 1e3)
    row = {"shape": shape, "max_abs_err": err, "tolerance": tol,
           "ms": time_ms(torch, k_fn), "plain_ms": time_ms(torch, p_fn),
           "library_ms": None if l_fn is None else time_ms(torch, l_fn),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops}
    if lib_err is not None:
        row["library_max_abs_err"] = lib_err
    row.update(extra)
    emit({"phase": "kernel_check", "kernel": name, **row})
    results.setdefault(name, []).append(row)


def skewed_rowptr(torch, dev, segments):
    """A skewed CSR over ``segments`` segments: half empty, the rest 1-30
    entries, and four of 1M, 250k, 50k and 10k entries among them (far
    longer than a block's shared-memory window of csrc/segmax.cu)."""
    rng = np.random.default_rng(2)
    counts = rng.integers(1, 31, segments)
    counts[rng.random(segments) < 0.5] = 0
    counts[rng.choice(segments, 4, replace=False)] = (1_000_000, 250_000,
                                                       50_000, 10_000)
    rowptr = np.zeros(segments + 1, np.int64)
    rowptr[1:] = np.cumsum(counts)
    return torch.from_numpy(rowptr.astype(np.int32)).to(dev)


def k1_skew_row(torch, dev, results):
    """K1's node update on the ``ihgnn.train.zipf`` cell's own graph
    (``benchmark/traffic/train.zipf.json`` over the deployment of
    ``benchmark/configs/ihgnn-o3o1-d32.json``, seed 0; every seed has the
    same hubs): with the graph's long segments (a block a hub) and without
    them (today's kernel alone), held bit for bit, and each segment within
    2e-6 a term of float64; timed beside its bound, the twin and
    ``torch.sparse.mm``, with the kernels of both launches by the
    profiler's names."""
    from benchmark import generate
    from ihgnn_torch.graph import build_hypergraph
    from ihgnn_torch.ops.segsum import csr_gather_sum, csr_gather_sum_plain
    root = pathlib.Path(__file__).resolve().parent / "benchmark"
    sizes = json.loads((root / "configs" / "ihgnn-o3o1-d32.json")
                       .read_text())["deployment"]
    traffic = json.loads((root / "traffic" / "train.zipf.json").read_text())
    uqi = generate.interactions(sizes, traffic,
                                generate.streams(0)["interactions"])
    n = sizes["users"] + sizes["queries"] + sizes["items"]
    graph = build_hypergraph(uqi, n, sizes["users"], sizes["queries"])
    graph = graph.to(dev)
    e = graph.edge_count
    edge = torch.randn(e, D, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    col, rowptr, hubs = graph.inc_edge, graph.rowptr, graph.long_segments
    k_out = csr_gather_sum(edge, col, rowptr, long_segments=hubs)
    if not torch.equal(k_out, csr_gather_sum(edge, col, rowptr)):
        fail("csr_gather_sum: the zipf node update with its long segments "
             "differs from the launch without them")
    lengths = (rowptr[1:] - rowptr[:-1]).double()
    err = (k_out.double() - csr_gather_sum_plain(edge.double(), col, rowptr)
           ).abs()
    if not (err <= 2e-6 * lengths[:, None] + 1e-6).all():
        fail("csr_gather_sum: a zipf node sum is off float64 by more than "
             "2e-6 a term")
    p_out = csr_gather_sum_plain(edge, col, rowptr)
    csr = torch.sparse_csr_tensor(rowptr, col, torch.ones(col.numel(),
                                  device=dev), size=(n, e))
    lib_err = (torch.sparse.mm(csr, edge) - p_out).abs().max().item()
    longest = int(lengths.max().item())
    record_row(
        torch, results, "csr_gather_sum",
        f"zipf node update [{col.numel()} entries of [{e}, {D}] -> [{n}, "
        f"{D}]]", err.max().item(), 2e-6 * longest + 1e-6,
        lambda: csr_gather_sum(edge, col, rowptr, long_segments=hubs),
        lambda: csr_gather_sum_plain(edge, col, rowptr),
        lambda: torch.sparse.mm(csr, edge),
        4 * (edge.numel() + col.numel() + rowptr.numel() + n * D
             + hubs.ids.numel()),
        col.numel() * D, lib_err,
        long_segments=hubs.ids.numel(), long_entries=hubs.entries,
        longest_segment=longest,
        without_list_ms=time_ms(torch, lambda: csr_gather_sum(edge, col,
                                                              rowptr)),
        device=kernel_device_ms(torch, lambda: csr_gather_sum(
            edge, col, rowptr, long_segments=hubs)),
        device_without_list=kernel_device_ms(
            torch, lambda: csr_gather_sum(edge, col, rowptr)))


def check_kernels(torch, dev, graph, bag, graph2d):
    """Phase 3: each kernel against its plain twin, timed beside its
    bound and one library call."""
    from ihgnn_torch.ops.gather import gather_roles, gather_roles_plain
    from ihgnn_torch.ops.interact import (ORDER_PARTS, interact_bwd,
                                          interact_bwd_plain, interact_fwd,
                                          interact_fwd_cores,
                                          interact_fwd_form,
                                          interact_fwd_plain)
    from ihgnn_torch.ops.segsum import csr_gather_sum, csr_gather_sum_plain
    from ihgnn_torch.ops.edgedot import (csr_edge_dot, csr_edge_dot_plain,
                                         resident_blocks)
    from ihgnn_torch.ops.segmax import (EMPTY_MAX, csr_segment_max,
                                        csr_segment_max_plain,
                                        csr_segment_sum,
                                        csr_segment_sum_ordered,
                                        csr_segment_sum_plain)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    results = {}

    def record(*args, **kwargs):
        record_row(torch, results, *args, **kwargs)

    # K1 node update: 3E entries of [E, d] edge rows → [N, d]
    n = graph.node_count
    edge = randn(E, D)
    col, rowptr = graph.inc_edge, graph.rowptr
    k_out = csr_gather_sum(edge, col, rowptr)
    p_out = csr_gather_sum_plain(edge, col, rowptr)
    csr = torch.sparse_csr_tensor(rowptr, col, torch.ones(col.numel(),
                                  device=dev), size=(n, E))
    lib_err = (torch.sparse.mm(csr, edge) - p_out).abs().max().item()
    record("csr_gather_sum", f"node update [{col.numel()} entries of [{E}, {D}]"
           f" -> [{n}, {D}]]", (k_out - p_out).abs().max().item(), 1e-4,
           lambda: csr_gather_sum(edge, col, rowptr),
           lambda: csr_gather_sum_plain(edge, col, rowptr),
           lambda: torch.sparse.mm(csr, edge),
           4 * (edge.numel() + col.numel() + rowptr.numel() + n * D),
           col.numel() * D, lib_err)
    del edge, k_out, p_out, csr

    # K1 word-bag mean: [V+1, d] vocab rows, weight 1/count → [Q, d]
    vocab = randn(VOCAB + 1, D)
    k_out = csr_gather_sum(vocab, bag.col, bag.rowptr, bag.weight)
    p_out = csr_gather_sum_plain(vocab, bag.col, bag.rowptr, bag.weight)
    csr = torch.sparse_csr_tensor(bag.rowptr, bag.col, bag.weight,
                                  size=(Q, VOCAB + 1))
    lib_err = (torch.sparse.mm(csr, vocab) - p_out).abs().max().item()
    record("csr_gather_sum", f"bag mean [{bag.col.numel()} entries of "
           f"[{VOCAB + 1}, {D}] -> [{Q}, {D}]]",
           (k_out - p_out).abs().max().item(), 1e-4,
           lambda: csr_gather_sum(vocab, bag.col, bag.rowptr, bag.weight),
           lambda: csr_gather_sum_plain(vocab, bag.col, bag.rowptr,
                                        bag.weight),
           lambda: torch.sparse.mm(csr, vocab),
           4 * (vocab.numel() + 2 * bag.col.numel() + bag.rowptr.numel()
                + Q * D),
           2 * bag.col.numel() * D, lib_err)
    del vocab, k_out, p_out, csr

    # K1 in the backward sums of the train step; each row has the bytes of
    # its inputs read once and its output written once (a fixed-width CSR,
    # width entries a segment, reads no rowptr)
    def backward_sum(label, x, col, rowptr, weight, lib_fn, width=None):
        s_out = rowptr.numel() - 1
        k_out = csr_gather_sum(x, col, rowptr, weight, width=width)
        p_out = csr_gather_sum_plain(x, col, rowptr, weight)
        lib_err = (lib_fn() - p_out).abs().max().item()
        per_entry = 2 if weight is not None else 1
        record("csr_gather_sum", f"{label} [{col.numel()} entries of "
               f"[{x.shape[0]}, {D}] -> [{s_out}, {D}]]",
               (k_out - p_out).abs().max().item(), 1e-4,
               lambda: csr_gather_sum(x, col, rowptr, weight, width=width),
               lambda: csr_gather_sum_plain(x, col, rowptr, weight), lib_fn,
               4 * (x.numel() + col.numel() * per_entry
                    + (0 if width else rowptr.numel()) + s_out * D),
               per_entry * col.numel() * D, lib_err,
               # the same sum through the CSR form, which reads rowptr
               **({} if width is None else {"csr_form_ms": time_ms(
                   torch, lambda: csr_gather_sum(x, col, rowptr, weight))}))

    # gather backward: the [3E, d] role cotangents into [N, d]
    cot3 = randn(3 * E, D)
    csr = torch.sparse_csr_tensor(rowptr, graph.inc_slot,
                                  torch.ones(graph.inc_slot.numel(),
                                             device=dev), size=(n, 3 * E))
    backward_sum("gather backward", cot3, graph.inc_slot, rowptr, None,
                 lambda: torch.sparse.mm(csr, cot3))
    del cot3, csr
    # scatter backward: E segments of the 3 node rows of each edge, in K1's
    # fixed-width form as the train step runs it
    cot_n = randn(n, D)
    i3_flat = graph.i3.view(-1)
    csr = torch.sparse_csr_tensor(graph.edge_rowptr, i3_flat,
                                  torch.ones(i3_flat.numel(), device=dev),
                                  size=(E, n))
    backward_sum("scatter backward", cot_n, i3_flat, graph.edge_rowptr, None,
                 lambda: torch.sparse.mm(csr, cot_n), width=3)
    del cot_n, csr
    # bag backward: the word-major transpose, [Q, d] into [V+1, d]
    cot_q = randn(Q, D)
    csr = torch.sparse_csr_tensor(bag.t_rowptr, bag.t_col, bag.t_weight,
                                  size=(VOCAB + 1, Q))
    backward_sum("bag backward", cot_q, bag.t_col, bag.t_rowptr,
                 bag.t_weight, lambda: torch.sparse.mm(csr, cot_q))
    del cot_q, csr

    # K2: [N, d] → 3 × [E, d], exact copy
    x = randn(n, D)
    i3 = graph.i3
    flat = i3.t().reshape(-1).long()
    k_out = gather_roles(x, i3)
    p_out = gather_roles_plain(x, i3)
    err = max((a - b).abs().max().item() for a, b in zip(k_out, p_out))
    if not all(torch.equal(a, b) for a, b in zip(k_out, p_out)):
        fail(f"gather_roles is not bitwise exact (max error {err})")
    record("gather_roles", f"[{n}, {D}] -> 3 x [{E}, {D}]", err, 0.0,
           lambda: gather_roles(x, i3), lambda: gather_roles_plain(x, i3),
           lambda: torch.index_select(x, 0, flat),
           4 * (x.numel() + i3.numel() + 3 * E * D), 0)
    del x, k_out, p_out, flat

    # K3 at orders 3 and 1 over [E, d] role rows; relative tolerance. The
    # product runs on the tensor cores in 3xTF32, the parts and the bias on
    # the f32 cores; K3's f32-core form is held and timed on the same inputs
    u, q, i = randn(E, D), randn(E, D), randn(E, D)
    for order in (3, 1):
        parts = ORDER_PARTS[order]
        w = randn(parts * D, D) / (parts * D) ** 0.5
        b = randn(D)
        form = interact_fwd_form(D, D, order)
        if form != "tensor_cores":
            fail(f"interact_fwd order {order} at d = {D} takes the {form} form")
        k_out = interact_fwd(u, q, i, w, b, order)
        p_out = interact_fwd_plain(u, q, i, w, b, order)
        c_out = interact_fwd_cores(u, q, i, w, b, order)
        err = (k_out - p_out).abs().max().item()
        cores_err = (c_out - p_out).abs().max().item()
        scale = p_out.abs().max().item()
        if not err <= 1e-4 * scale:
            fail(f"interact_fwd order {order}: max error {err} > 1e-4 x {scale}")
        if not cores_err <= 1e-4 * scale:
            fail(f"interact_fwd_cores order {order}: max error {cores_err} > "
                 f"1e-4 x {scale}")
        hadamard = {1: 0, 2: 3, 3: 4}[order] * D
        record("interact_fwd", f"order {order}, 3 x [{E}, {D}] -> [{E}, {D}]",
               err, 1e-4 * scale,
               lambda: interact_fwd(u, q, i, w, b, order),
               lambda: interact_fwd_plain(u, q, i, w, b, order), None,
               4 * (3 * E * D + w.numel() + b.numel() + E * D),
               E * (hadamard + D), tf32_flops=E * 2 * parts * D * D,
               form=form, cores_form_max_abs_err=cores_err,
               cores_form_ms=time_ms(
                   torch, lambda: interact_fwd_cores(u, q, i, w, b, order)))
        del k_out, p_out, c_out

    # interact_bwd at orders 3 and 1: each of du/dq/di/dW/db within 1e-4
    # of its largest value; dW and db sum 2M edges in another order than
    # the twin's matmuls
    cot = randn(E, D)
    names = ("du", "dq", "di", "dw", "db")
    for order in (3, 1):
        parts = ORDER_PARTS[order]
        w = randn(parts * D, D) / (parts * D) ** 0.5
        k_droles, *k_params = interact_bwd(u, q, i, w, cot, order)
        p_droles, *p_params = interact_bwd_plain(u, q, i, w, cot, order)
        errors = {}
        for nm, a, b_ in zip(names, (*k_droles, *k_params),
                             (*p_droles, *p_params)):
            err = (a - b_).abs().max().item()
            tol = 1e-4 * b_.abs().max().item()
            if not err <= tol:
                fail(f"interact_bwd order {order} {nm}: max error {err} > "
                     f"{tol}")
            errors[nm] = {"max_abs_err": err, "tolerance": tol}
        # product rule per edge and feature: 4 multiply-adds a product
        # pair at order 2+, 3 more terms at order 3; the hadamard parts
        hadamard = {1: 0, 2: 3, 3: 4}[order]
        product_rule = {1: 0, 2: 12, 3: 21}[order]
        worst = max(errors.values(),
                    key=lambda v: v["max_abs_err"] / max(v["tolerance"],
                                                         1e-30))
        # the two products (dparts and dW) run on the tensor cores in
        # 3xTF32; the parts, the product rule and db on the f32 cores
        record("interact_bwd", f"order {order}, 3 x [{E}, {D}] + cot "
               f"[{E}, {D}] -> [3, {E}, {D}], dW [{parts * D}, {D}], db",
               worst["max_abs_err"], worst["tolerance"],
               lambda: interact_bwd(u, q, i, w, cot, order),
               lambda: interact_bwd_plain(u, q, i, w, cot, order), None,
               4 * (3 * E * D + E * D + w.numel() + 3 * E * D + w.numel()
                    + D),
               E * (D * (hadamard + product_rule) + D),
               tf32_flops=E * 2 * 2 * parts * D * D, errors=errors,
               max_abs_err_all=max(v["max_abs_err"]
                                   for v in errors.values()),
               **parent_ms(torch, "interact_bwd",
                           lambda cb, ref: cb.run_bwd(
                               ref, False, u, q, i, None, w, cot, None,
                               None, order)))
        del k_droles, k_params, p_droles, p_params
    del u, q, i, cot

    # K4 and the scalar sum: the GAT softmax over the 2D graph's
    # destinations (12M entries -> 700k) and the phase-2 softmax over the
    # hypergraph's nodes (6M -> 700k); scores with a share at -1e30 as
    # masked entries give them. A skewed CSR times the block path of long
    # segments. The sum is held to its twin (1e-4; on the skewed CSR, whose
    # long sums reach 5e5, 1e-4 of the largest) and bit for bit to its
    # order of adds (csr_segment_sum_ordered)
    att = graph2d.attention
    for label, rowptr in (("GAT", att.dst_rowptr),
                          ("phase 2", graph.phase2.dst_rowptr),
                          ("skewed", skewed_rowptr(torch, dev, n))):
        k, s_out = int(rowptr[-1].item()), rowptr.numel() - 1
        offsets = rowptr.long()
        scores = randn(k) * 4
        scores[torch.rand(k, device=dev, generator=gen) < 0.01] = -1e30
        k_out = csr_segment_max(scores, rowptr)
        p_out = csr_segment_max_plain(scores, rowptr)
        if not torch.equal(k_out, p_out):
            fail(f"csr_segment_max ({label}) is not bitwise exact")
        lib = torch.segment_reduce(scores, "max", offsets=offsets,
                                   initial=EMPTY_MAX)
        record("csr_segment_max", f"{label} [{k} entries -> [{s_out}]]",
               0.0, 0.0, lambda: csr_segment_max(scores, rowptr),
               lambda: csr_segment_max_plain(scores, rowptr),
               lambda: torch.segment_reduce(scores, "max", offsets=offsets,
                                            initial=EMPTY_MAX),
               4 * (k + rowptr.numel() + s_out), k,
               (lib - p_out).abs().max().item())
        w = torch.rand(k, device=dev, generator=gen)
        k_out = csr_segment_sum(w, rowptr)
        p_out = csr_segment_sum_plain(w, rowptr)
        if not torch.equal(k_out, csr_segment_sum_ordered(w, rowptr)):
            fail(f"csr_segment_sum ({label}) differs from its order of adds")
        lib = torch.segment_reduce(w, "sum", offsets=offsets)
        tol = 1e-4 * (p_out.abs().max().item() if label == "skewed" else 1)
        record("csr_segment_sum", f"{label} [{k} entries -> [{s_out}]]",
               (k_out - p_out).abs().max().item(), tol,
               lambda: csr_segment_sum(w, rowptr),
               lambda: csr_segment_sum_plain(w, rowptr),
               lambda: torch.segment_reduce(w, "sum", offsets=offsets),
               4 * (k + rowptr.numel() + s_out), k,
               (lib - p_out).abs().max().item(), ordered_equal=True)
        del scores, w, k_out, p_out, lib

    # csr_edge_dot at the GAT backward: tt = <cot[dst], x[src]> over 12M
    # destination-sorted entries; the library call is cuSPARSE's SDDMM on
    # the same destination CSR. Beside the bound, a model of its design's
    # bytes (not measured): b read once a wave of blocks, a once, the
    # order (col and slot an entry, the chunk tables) and out
    n = graph2d.node_count
    k = att.entry_count
    cot_n, x = randn(n, D), randn(n, D)
    src, rowptr, order = att.src, att.dst_rowptr, att.dot_order
    k_out = csr_edge_dot(cot_n, x, order)
    if not torch.equal(k_out, csr_edge_dot(cot_n, x, order)):
        fail("csr_edge_dot does not repeat itself bit for bit")
    p_out = csr_edge_dot_plain(cot_n, x, src, rowptr)
    scale = p_out.abs().max().item()
    chunks = order.chunk_ptr.numel() - 1
    wave = (resident_blocks(D)
            * torch.cuda.get_device_properties(dev).multi_processor_count)
    waves = -(-chunks // wave)
    design_bytes = 4 * (waves * n * D + n * D + 3 * k
                        + order.chunk_ptr.numel() + order.chunk_segs.numel())
    # the same entries with their columns folded into b's first 100k rows
    # (12.8 MB, which L2 holds): the kernel's time when every row hits L2
    order_fold = dataclasses.replace(
        order, col=order.col % L2_RESIDENT_ROWS,
        sorted_col=order.sorted_col % L2_RESIDENT_ROWS)
    l2_ms = time_ms(torch, lambda: csr_edge_dot(cot_n, x, order_fold))
    del order_fold
    pattern = torch.sparse_csr_tensor(rowptr, src, torch.ones(k, device=dev),
                                      size=(n, n))
    x_t = x.t()
    lib = torch.sparse.sampled_addmm(pattern, cot_n, x_t, beta=0.0)
    record("csr_edge_dot", f"GAT backward [{k} entries of [{n}, {D}] x "
           f"[{n}, {D}] -> [{k}]]", (k_out - p_out).abs().max().item(),
           1e-5 * scale,
           lambda: csr_edge_dot(cot_n, x, order),
           lambda: csr_edge_dot_plain(cot_n, x, src, rowptr),
           lambda: torch.sparse.sampled_addmm(pattern, cot_n, x_t, beta=0.0),
           4 * (2 * n * D + k + rowptr.numel() + k), 2 * k * D,
           (lib.values() - p_out).abs().max().item(), repeatable=True,
           bound_design_ms=design_bytes / HBM_BYTES_PER_S * 1e3,
           design_bytes=design_bytes, chunks=chunks, wave_blocks=wave,
           waves=waves, l2_resident_ms=l2_ms)
    del k_out, p_out, lib, cot_n

    # K1 at the GAT weighted sum: α-weighted source rows into [N, d]
    alpha = torch.rand(k, device=dev, generator=gen)
    k_out = csr_gather_sum(x, src, rowptr, alpha)
    p_out = csr_gather_sum_plain(x, src, rowptr, alpha)
    csr = torch.sparse_csr_tensor(rowptr, src, alpha, size=(n, n))
    lib_err = (torch.sparse.mm(csr, x) - p_out).abs().max().item()
    record("csr_gather_sum", f"GAT weighted sum [{k} entries of [{n}, {D}]"
           f" -> [{n}, {D}]]", (k_out - p_out).abs().max().item(), 1e-4,
           lambda: csr_gather_sum(x, src, rowptr, alpha),
           lambda: csr_gather_sum_plain(x, src, rowptr, alpha),
           lambda: torch.sparse.mm(csr, x),
           4 * (x.numel() + 2 * k + rowptr.numel() + n * D), 2 * k * D,
           lib_err)
    del x, alpha, k_out, p_out, csr
    return results


def check_routed_kernels(torch, dev, kp, results):
    """Phase 3, the routed path: each of its kernels at the shapes of the
    routed pack of the 2M-edge graph (E padded to R x C), against its plain
    twin, timed beside its bound and one library call."""
    from ihgnn_torch.ops.gather import (gather_rows, gather_rows_plain,
                                        gather_rows_t)
    from ihgnn_torch.ops.interact import (ORDER_PARTS, interact_bwd,
                                          interact_bwd_absorb,
                                          interact_bwd_absorb_plain,
                                          interact_bwd_absorb_via_direct,
                                          interact_fwd_absorb,
                                          interact_fwd_absorb_cores,
                                          interact_fwd_absorb_plain,
                                          interact_fwd_form)
    from ihgnn_torch.ops.permute import (row_local_permute,
                                         row_local_permute_plain,
                                         transposed_local_permute,
                                         transposed_local_permute_plain)
    from ihgnn_torch.ops.segscan import csr_segment_scan, csr_segment_scan_plain
    from ihgnn_torch.ops.segsum import (csr_gather_sum, csr_gather_sum_plain,
                                        csr_segment_sum3,
                                        csr_segment_sum3_plain)

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def record(*args, **kwargs):
        record_row(torch, results, *args, **kwargs)

    n, e, rows, cols = kp.node_count, kp.edge_count, kp.rows, kp.cols
    e_pad = rows * cols
    grid = f"[{rows}, {cols}, {D}]"
    tgrid = f"[{cols}, {rows}, {D}]"

    # K2's single-index forms: the u expand and the q expand (transposed)
    x = randn(n, D)
    for kname, fn, idx, transposed, label in (
            ("gather_rows", gather_rows, kp.u.idx, False, f"u expand -> {grid}"),
            ("gather_rows_t", gather_rows_t, kp.q.idx, True,
             f"q expand -> {tgrid}")):
        flat = (idx.t() if transposed else idx).reshape(-1).long()
        k_out = fn(x, idx)
        if not torch.equal(k_out, gather_rows_plain(x, idx, transposed)):
            fail(f"{kname} is not bitwise exact")
        record(kname, f"{label}, [{n}, {D}] rows", 0.0, 0.0,
               lambda: fn(x, idx),
               lambda: gather_rows_plain(x, idx, transposed),
               lambda: torch.index_select(x, 0, flat),
               4 * (x.numel() + e_pad + e_pad * D), 0)
        del k_out, flat
    del x

    # K6/K7: each form on the grid of the chains that run it, exact; the
    # library call is one index_select of the composed source rows
    def perm_row(kname, label, x, p, pre=False):
        if kname == "row_local_permute":
            k_fn = lambda: row_local_permute(x, p)          # noqa: E731
            p_fn = lambda: row_local_permute_plain(x, p)    # noqa: E731
            plain = lambda v: row_local_permute_plain(v, p)  # noqa: E731
        else:
            k_fn = lambda: transposed_local_permute(x, p, pre)  # noqa: E731
            p_fn = lambda: transposed_local_permute_plain(x, p, pre)  # noqa
            plain = lambda v: transposed_local_permute_plain(  # noqa: E731
                v, p, pre)
        if not torch.equal(k_fn(), p_fn()):
            fail(f"{kname} ({label}) is not bitwise exact")
        # the source row of each output row, by the twin on row numbers
        src = plain(torch.arange(e_pad, device=dev).view(*x.shape[:2], 1))
        src = src.reshape(-1)
        flat = x.view(-1, x.shape[-1])
        if x.dtype == torch.bfloat16:
            kname += "_bf16"
        record(kname, label, 0.0, 0.0, k_fn, p_fn,
               lambda: torch.index_select(flat, 0, src),
               2 * x.numel() * x.element_size()
               + (0 if p is None else 4 * e_pad), 0,
               dtype=str(x.dtype).replace("torch.", ""))

    xg = randn(rows, cols, D)
    xt = randn(cols, rows, D)
    perm_row("row_local_permute", f"i stage 2, {grid} f32", xg, kp.i.p2)
    perm_row("row_local_permute", f"i stage 2, {grid} bf16",
             xg.bfloat16(), kp.i.p2)
    perm_row("transposed_local_permute",
             f"q stage 1 then transpose, {tgrid} -> {grid} f32", xt, kp.q.p1)
    perm_row("transposed_local_permute",
             f"transpose, q stage 1 inverse, transpose back, {grid} f32",
             xg, kp.q.p1_inv, pre=True)
    perm_row("transposed_local_permute",
             f"i stage 2 inverse then transpose, {grid} -> {tgrid} f32",
             xg, kp.i.p2_inv)
    perm_row("transposed_local_permute", f"transpose, {grid} -> {tgrid} f32",
             xg, None)
    perm_row("transposed_local_permute",
             f"q stage 1 then transpose, {tgrid} -> {grid} bf16",
             xt.bfloat16(), kp.q.p1)
    del xg, xt

    # K5 at orders 3 and 1, masked, over the grid's e_pad edges
    u, q, i_t1 = randn(e_pad, D), randn(e_pad, D), randn(e_pad, D)
    c1, c2 = randn(e_pad, D), randn(e_pad, D)
    pi, mask = kp.i.p2, kp.sig_mask
    names = ("du", "dq", "di_t1", "dw", "db")
    for order in (3, 1):
        parts = ORDER_PARTS[order]
        w = randn(parts * D, D) / (parts * D) ** 0.5
        b = randn(D)
        form = interact_fwd_form(D, D, order)
        if form != "tensor_cores":
            fail(f"interact_fwd_absorb order {order} takes the {form} form")
        k_out = interact_fwd_absorb(u, q, i_t1, pi, w, b, order)
        p_out = interact_fwd_absorb_plain(u, q, i_t1, pi, w, b, order)
        c_out = interact_fwd_absorb_cores(u, q, i_t1, pi, w, b, order)
        err = max((a - c).abs().max().item() for a, c in zip(k_out, p_out))
        cores_err = max((a - c).abs().max().item()
                        for a, c in zip(c_out, p_out))
        scale = p_out[0].abs().max().item()
        if not cores_err <= 1e-4 * scale:
            fail(f"interact_fwd_absorb_cores order {order}: max error "
                 f"{cores_err} > 1e-4 x {scale}")
        hadamard = {1: 0, 2: 3, 3: 4}[order]
        record("interact_fwd_absorb", f"order {order}, 3 x [{e_pad}, {D}] "
               f"-> 2 x [{e_pad}, {D}]", err, 1e-4 * scale,
               lambda: interact_fwd_absorb(u, q, i_t1, pi, w, b, order),
               lambda: interact_fwd_absorb_plain(u, q, i_t1, pi, w, b, order),
               None, 4 * (3 * e_pad * D + e_pad + w.numel() + D
                          + 2 * e_pad * D),
               e_pad * (hadamard * D + D),
               tf32_flops=e_pad * 2 * parts * D * D, form=form,
               cores_form_max_abs_err=cores_err,
               cores_form_ms=time_ms(torch, lambda: interact_fwd_absorb_cores(
                   u, q, i_t1, pi, w, b, order)))
        del k_out, p_out, c_out
        k_b = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, order)
        p_b = interact_bwd_absorb_plain(u, q, i_t1, pi, w, c1, c2, mask,
                                        order)
        # the identity: interact_bwd on the pre-permuted inputs (i_t1[e_pi],
        # the merged, masked cotangent), bit for bit; that kernel is timed
        # on them beside K5
        r_b = interact_bwd_absorb_via_direct(u, q, i_t1, pi, w, c1, c2,
                                             mask, order)
        bitwise = all(torch.equal(a, c) for a, c in zip(
            (*k_b[0], *k_b[1:]), (*r_b[0], *r_b[1:])))
        if not bitwise:
            fail(f"interact_bwd_absorb order {order} differs from "
                 "interact_bwd on the pre-permuted inputs")
        e_pi = (torch.arange(rows, device=dev)[:, None] * cols
                + pi.long()).view(-1)
        i_sig = i_t1[e_pi]
        cot = (c1 + c2[e_pi]) * mask[:, None]
        direct_ms = time_ms(torch, lambda: interact_bwd(u, q, i_sig, w, cot,
                                                        order))
        del r_b, e_pi, i_sig, cot
        errors = {}
        for nm, a, c in zip(names, (*k_b[0], *k_b[1:]), (*p_b[0], *p_b[1:])):
            errors[nm] = {"max_abs_err": (a - c).abs().max().item(),
                          "tolerance": 1e-4 * c.abs().max().item()}
            if not errors[nm]["max_abs_err"] <= errors[nm]["tolerance"]:
                fail(f"interact_bwd_absorb order {order} {nm}: {errors[nm]}")
        pads = mask == 0
        if not (k_b[0][0][pads] == 0).all():
            fail("interact_bwd_absorb: a sigma pad reached du")
        worst = max(errors.values(),
                    key=lambda v: v["max_abs_err"] / max(v["tolerance"],
                                                         1e-30))
        product_rule = {1: 0, 2: 12, 3: 21}[order]
        record("interact_bwd_absorb", f"order {order}, 3 x [{e_pad}, {D}] + "
               f"2 cot [{e_pad}, {D}] + mask -> [3, {e_pad}, {D}], dW, db",
               worst["max_abs_err"], worst["tolerance"],
               lambda: interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask,
                                           order),
               lambda: interact_bwd_absorb_plain(u, q, i_t1, pi, w, c1, c2,
                                                 mask, order), None,
               4 * (3 * e_pad * D + e_pad + w.numel() + 2 * e_pad * D
                    + e_pad + 3 * e_pad * D + w.numel() + D),
               # the hadamard parts, the product rule, db and the merged
               # cotangent (an add and a mask a value) on the f32 cores; the
               # two products on the tensor cores in 3xTF32
               e_pad * (D * (hadamard + product_rule) + D + 2 * D),
               tf32_flops=e_pad * 2 * 2 * parts * D * D,
               errors=errors, max_abs_err_all=max(
                   v["max_abs_err"] for v in errors.values()),
               bitwise_equal=bitwise, direct_on_permuted_ms=direct_ms,
               **parent_ms(torch, "interact_bwd",
                           lambda cb, ref: cb.run_bwd(
                               ref, True, u, q, i_t1, pi, w, c1, c2, mask,
                               order)))
        del k_b, p_b
    del u, q, i_t1, c1, c2

    # K1's three-region form and K8, on the routed node-update stream: the
    # [u | q | i] regions of 3 e_pad rows, 3E of them real
    regions = [randn(e_pad, D) for _ in range(3)]
    stream = torch.cat(regions)
    col, rowptr = kp.seg_col, kp.seg_rowptr
    k1 = csr_segment_sum3(*regions, col, rowptr)
    p1 = csr_segment_sum3_plain(*regions, col, rowptr)
    csr = torch.sparse_csr_tensor(rowptr, col, torch.ones(col.numel(),
                                  device=dev), size=(n, 3 * e_pad))
    lib_err = (torch.sparse.mm(csr, stream) - p1).abs().max().item()
    sum_bytes = 4 * (3 * e * D + 3 * e + rowptr.numel() + n * D)
    record("csr_segment_sum3", f"routed node update [3 x [{e_pad}, {D}] "
           f"regions, {3 * e} entries -> [{n}, {D}]]",
           (k1 - p1).abs().max().item(), 1e-4,
           lambda: csr_segment_sum3(*regions, col, rowptr),
           lambda: csr_segment_sum3_plain(*regions, col, rowptr),
           lambda: torch.sparse.mm(csr, stream), sum_bytes, 3 * e * D,
           lib_err, single_table_ms=time_ms(
               torch, lambda: csr_gather_sum(stream, col, rowptr)))
    k8 = csr_segment_scan(stream, kp.scan)
    p8 = csr_segment_scan_plain(stream, kp.scan)
    if not torch.equal(k8, csr_gather_sum(stream, col, rowptr)):
        fail("csr_segment_scan differs from K1 over the same entries")
    if not torch.equal(k8, k1):
        fail("csr_segment_scan differs from K1's three-region form")
    # K8 against torch.sparse.mm in turns, SCAN_REPEATS times each: the
    # median and the spread (largest less smallest) of each
    k8_ms, lib_ms = [], []
    for _ in range(SCAN_REPEATS):
        k8_ms.append(time_ms(torch, lambda: csr_segment_scan(stream, kp.scan)))
        lib_ms.append(time_ms(torch, lambda: torch.sparse.mm(csr, stream)))
    record("csr_segment_scan", f"routed node update [{3 * e_pad} entries, "
           f"{3 * e} real, block-sorted -> [{n}, {D}]]",
           (k8 - p8).abs().max().item(), 1e-4,
           lambda: csr_segment_scan(stream, kp.scan),
           lambda: csr_segment_scan_plain(stream, kp.scan),
           lambda: torch.sparse.mm(csr, stream),
           4 * (3 * e * D + n * D + kp.scan.pos.numel()
                + kp.scan.rowptr.numel() + kp.scan.block_seg.numel()),
           3 * e * D, lib_err,
           equal_to_k1=True, repeats_ms=k8_ms, library_repeats_ms=lib_ms,
           ms_median=float(np.median(k8_ms)),
           ms_spread=max(k8_ms) - min(k8_ms),
           library_ms_median=float(np.median(lib_ms)),
           library_ms_spread=max(lib_ms) - min(lib_ms))
    del regions, k1, p1, k8, p8, csr

    # csr_segment_sum3_multi's shape (segsum.py:686): K1 over one CSR that
    # spans two edge-chunk streams, each the [u | q | i] regions of an e_pad
    # grid (ChunkedHyperPack begins past 2048 x 1024 edges). Each chunk
    # holds the routed node-update entries of the 2M-edge pack, so a node
    # sums its entries of chunk 0, then those of chunk 1
    chunks = torch.cat([stream, randn(3 * e_pad, D)])
    del stream
    seg = torch.repeat_interleave(torch.arange(n, device=dev),
                                  (rowptr[1:] - rowptr[:-1]).long())
    order = torch.sort(torch.cat([seg, seg]), stable=True).indices
    col2 = torch.cat([col, col + 3 * e_pad])[order].int()
    rowptr2 = 2 * rowptr
    del seg, order
    k_out = csr_gather_sum(chunks, col2, rowptr2)
    p_out = csr_gather_sum_plain(chunks, col2, rowptr2)
    csr = torch.sparse_csr_tensor(rowptr2, col2,
                                  torch.ones(col2.numel(), device=dev),
                                  size=(n, chunks.shape[0]))
    lib_err = (torch.sparse.mm(csr, chunks) - p_out).abs().max().item()
    record("csr_gather_sum", f"two-chunk node update [2 x 3 x [{e_pad}, {D}] "
           f"chunk regions, {col2.numel()} entries -> [{n}, {D}]]",
           (k_out - p_out).abs().max().item(), 1e-4,
           lambda: csr_gather_sum(chunks, col2, rowptr2),
           lambda: csr_gather_sum_plain(chunks, col2, rowptr2),
           lambda: torch.sparse.mm(csr, chunks),
           4 * (col2.numel() * D + col2.numel() + rowptr2.numel() + n * D),
           col2.numel() * D, lib_err,
           replaces="ihgnn_tpu/ops/pallas/segsum.py:686")
    del chunks, col2, rowptr2, k_out, p_out, csr


def check_routed_bf16_kernels(torch, dev, kp, results):
    """Phase 3, the routed pack's bf16 forms at the shapes of the routed
    bf16 serving and training paths: ``gather_rows[_t]`` from the f32 node
    rows to bf16 (the u and q expands), K1's three-region form on bf16
    regions into f32 (the node update) and into bf16 (the gather's
    backward), K5 forward and backward on bf16 roles at orders 3 and 1
    with the σ mask (the backward also bit for bit ``interact_bwd``'s bf16
    form on the pre-permuted inputs, timed beside it), K8 on a bf16
    node-update stream (bit for bit the bf16 three-region K1), and K1's
    bf16 form over the two-chunk spanning CSR of ``check_routed_kernels``
    (``csr_segment_sum3_multi`` on bf16 chunk streams). Held and bounded
    as ``check_bf16_kernels``; the library calls are ``index_select`` of
    a bf16 copy and ``torch.sparse.mm`` in bf16."""
    from ihgnn_torch.ops.gather import (gather_rows, gather_rows_plain,
                                        gather_rows_t)
    from ihgnn_torch.ops.interact import (ORDER_PARTS, interact_bwd,
                                          interact_bwd_absorb,
                                          interact_bwd_absorb_plain,
                                          interact_bwd_absorb_via_direct,
                                          interact_fwd_absorb,
                                          interact_fwd_absorb_plain)
    from ihgnn_torch.ops.segscan import (csr_segment_scan,
                                         csr_segment_scan_plain)
    from ihgnn_torch.ops.segsum import (csr_gather_sum, csr_gather_sum_plain,
                                        csr_segment_sum3,
                                        csr_segment_sum3_plain)

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def record(*args, **kwargs):
        record_row(torch, results, *args, **kwargs)

    n, e, rows, cols = kp.node_count, kp.edge_count, kp.rows, kp.cols
    e_pad = rows * cols
    grid = f"[{rows}, {cols}, {D}]"
    tgrid = f"[{cols}, {rows}, {D}]"

    # gather_rows[_t]: f32 [N, d] -> bf16 rows, rounded in the copy
    x = randn(n, D)
    x16 = x.to(bf16)
    for kname, fn, idx, transposed, label in (
            ("gather_rows_bf16", gather_rows, kp.u.idx, False,
             f"u expand -> {grid} bf16"),
            ("gather_rows_t_bf16", gather_rows_t, kp.q.idx, True,
             f"q expand -> {tgrid} bf16")):
        flat = (idx.t() if transposed else idx).reshape(-1).long()
        k_out = fn(x, idx, dtype=bf16)
        if not torch.equal(k_out, gather_rows_plain(x, idx, transposed,
                                                    bf16)):
            fail(f"{kname} is not bitwise its twin")
        record(kname, f"{label}, [{n}, {D}] f32 rows", 0.0, 0.0,
               lambda: fn(x, idx, dtype=bf16),
               lambda: gather_rows_plain(x, idx, transposed, bf16),
               lambda: torch.index_select(x16, 0, flat),
               4 * x.numel() + 4 * e_pad + 2 * e_pad * D, 0,
               library_note="index_select of a bf16 copy of x")
        del k_out, flat
    del x, x16

    # K1's three-region form on bf16 regions: f32 out (the node update) and
    # bf16 out (the gather's backward); K8 on the same stream. Beside each
    # three-region row, K1's single-table bf16 form over the concatenated
    # regions with the same CSR (single_table_ms), the same sums read
    # through one base pointer
    regions = [randn(e_pad, D).to(bf16) for _ in range(3)]
    stream = torch.cat(regions)
    col, rowptr = kp.seg_col, kp.seg_rowptr
    csr = torch.sparse_csr_tensor(rowptr, col, torch.ones(
        col.numel(), device=dev, dtype=bf16), size=(n, 3 * e_pad))
    try:
        lib_out = torch.sparse.mm(csr, stream).float()
        torch.cuda.synchronize()
        l_fn = lambda: torch.sparse.mm(csr, stream)     # noqa: E731
    except (RuntimeError, NotImplementedError) as exc:
        lib_out, l_fn = None, None
        lib_note = f"none: {type(exc).__name__}: {str(exc)[:160]}"

    def library(want):
        if lib_out is None:
            return {"library_note": lib_note}
        return {"library_max_abs_err":
                (lib_out - want.float()).abs().max().item()}

    regions8 = [rows_at(torch, r, 8) for r in regions]
    k1 = None
    for out_dtype, use in ((None, "node update"), (bf16, "gather backward")):
        k_out = csr_segment_sum3(*regions, col, rowptr, out_dtype)
        p_out = csr_segment_sum3_plain(*regions, col, rowptr, out_dtype)
        if not torch.equal(k_out, csr_segment_sum3(*regions8, col, rowptr,
                                                   out_dtype)):
            fail(f"csr_segment_sum3 bf16 {use}: the 16-byte lanes differ "
                 "from the 8-byte lanes")
        if out_dtype is None:
            k1 = k_out
            err, tol = (k_out - p_out).abs().max().item(), 1e-4
        else:
            err, tol = bf16_held(torch, "csr_segment_sum3 bf16 -> bf16",
                                 k_out, p_out)
            if not torch.equal(k_out, k1.to(bf16)):
                fail("csr_segment_sum3 bf16 -> bf16 is not its f32 sums "
                     "rounded once")
        record("csr_segment_sum3_bf16",
               f"routed {use} [3 x [{e_pad}, {D}] bf16 regions, {3 * e} "
               f"entries -> [{n}, {D}] {'bf16' if out_dtype else 'f32'}]",
               err, tol,
               lambda: csr_segment_sum3(*regions, col, rowptr, out_dtype),
               lambda: csr_segment_sum3_plain(*regions, col, rowptr,
                                              out_dtype), l_fn,
               2 * 3 * e * D + 4 * (3 * e + rowptr.numel())
               + (2 if out_dtype else 4) * n * D, 3 * e * D,
               single_table_ms=time_ms(torch, lambda: csr_gather_sum(
                   stream, col, rowptr, out_dtype=out_dtype)),
               eight_byte_ms=time_ms(torch, lambda: csr_segment_sum3(
                   *regions8, col, rowptr, out_dtype)),
               **parent_ms(
                   torch, "segsum",
                   lambda cb, ref: cb.run_k1_three_bf16(
                       ref, *regions, col, rowptr,
                       out_dtype or torch.float32)),
               **library(p_out))
        del k_out, p_out
    del regions8
    k8 = csr_segment_scan(stream, kp.scan)
    if not torch.equal(k8, k1):
        fail("csr_segment_scan bf16 differs from the bf16 three-region K1")
    p8 = csr_segment_scan_plain(stream, kp.scan)
    record("csr_segment_scan_bf16", f"routed node update [{3 * e_pad} bf16 "
           f"entries, {3 * e} real, block-sorted -> [{n}, {D}] f32]",
           (k8 - p8).abs().max().item(), 1e-4,
           lambda: csr_segment_scan(stream, kp.scan),
           lambda: csr_segment_scan_plain(stream, kp.scan),
           l_fn, 2 * 3 * e * D + 4 * (n * D + kp.scan.pos.numel()
                                      + kp.scan.rowptr.numel()
                                      + kp.scan.block_seg.numel()),
           3 * e * D, equal_to_k1=True, **library(p8))
    del regions, csr, k1, k8, p8, lib_out

    # csr_segment_sum3_multi's bf16 form (segsum.py:686 on bf16 chunk
    # streams): K1's bf16 form over the two-chunk spanning CSR of the f32
    # row (check_routed_kernels), with the same seeded layout
    chunks = torch.cat([stream, randn(3 * e_pad, D).to(bf16)])
    del stream
    seg = torch.repeat_interleave(torch.arange(n, device=dev),
                                  (rowptr[1:] - rowptr[:-1]).long())
    order = torch.sort(torch.cat([seg, seg]), stable=True).indices
    col2 = torch.cat([col, col + 3 * e_pad])[order].int()
    rowptr2 = 2 * rowptr
    del seg, order
    k_out = csr_gather_sum(chunks, col2, rowptr2)
    p_out = csr_gather_sum_plain(chunks, col2, rowptr2)
    csr2 = torch.sparse_csr_tensor(rowptr2, col2, torch.ones(
        col2.numel(), device=dev, dtype=bf16), size=(n, chunks.shape[0]))
    try:
        lib2 = {"library_max_abs_err": (torch.sparse.mm(csr2, chunks).float()
                                        - p_out).abs().max().item()}
        torch.cuda.synchronize()
        l2_fn = lambda: torch.sparse.mm(csr2, chunks)   # noqa: E731
    except (RuntimeError, NotImplementedError) as exc:
        lib2, l2_fn = {"library_note": f"none: {type(exc).__name__}: "
                       f"{str(exc)[:160]}"}, None
    record("csr_gather_sum_bf16", f"two-chunk node update [2 x 3 x [{e_pad}, "
           f"{D}] bf16 chunk regions, {col2.numel()} entries -> [{n}, {D}] "
           f"f32]", (k_out - p_out).abs().max().item(), 1e-4,
           lambda: csr_gather_sum(chunks, col2, rowptr2),
           lambda: csr_gather_sum_plain(chunks, col2, rowptr2), l2_fn,
           2 * col2.numel() * D + 4 * (col2.numel() + rowptr2.numel()
                                       + n * D),
           col2.numel() * D, replaces="ihgnn_tpu/ops/pallas/segsum.py:686",
           **lib2)
    del chunks, col2, rowptr2, k_out, p_out, csr2

    # K5 on bf16 roles at orders 3 and 1, masked
    u, q, i_t1 = (randn(e_pad, D).to(bf16) for _ in range(3))
    c1, c2 = randn(e_pad, D).to(bf16), randn(e_pad, D).to(bf16)
    pi, mask = kp.i.p2, kp.sig_mask
    e_pi = (torch.arange(rows, device=dev)[:, None] * cols
            + pi.long()).view(-1)
    for order in (3, 1):
        parts = ORDER_PARTS[order]
        w = randn(parts * D, D) / (parts * D) ** 0.5
        b = randn(D)
        hadamard = {1: 0, 2: 3, 3: 4}[order]
        o1, o2 = interact_fwd_absorb(u, q, i_t1, pi, w, b, order)
        p1, p2 = interact_fwd_absorb_plain(u, q, i_t1, pi, w, b, order)
        name = f"interact_fwd_absorb bf16 order {order}"
        err, tol = bf16_held(torch, name, o1, p1)
        bf16_held(torch, f"{name} o2", o2, p2)
        if not torch.equal(o2[e_pi], o1):
            fail("interact_fwd_absorb bf16: o2 is not rho(o1)")
        record("interact_fwd_absorb_bf16", f"order {order}, 3 x [{e_pad}, "
               f"{D}] bf16 -> 2 x [{e_pad}, {D}] bf16", err, tol,
               lambda: interact_fwd_absorb(u, q, i_t1, pi, w, b, order),
               lambda: interact_fwd_absorb_plain(u, q, i_t1, pi, w, b,
                                                 order), None,
               2 * 3 * e_pad * D + 4 * (e_pad + w.numel() + D)
               + 2 * 2 * e_pad * D, e_pad * (hadamard + 1) * D,
               bf16_flops=e_pad * 2 * parts * D * D)
        del o1, o2, p1, p2
        k_b = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, order)
        p_b = interact_bwd_absorb_plain(u, q, i_t1, pi, w, c1, c2, mask,
                                        order)
        r_b = interact_bwd_absorb_via_direct(u, q, i_t1, pi, w, c1, c2,
                                             mask, order)
        bitwise = all(torch.equal(a, c) for a, c in zip(
            (*k_b[0], *k_b[1:]), (*r_b[0], *r_b[1:])))
        if not bitwise:
            fail(f"interact_bwd_absorb bf16 order {order} differs from "
                 "interact_bwd's bf16 form on the pre-permuted inputs")
        i_sig = i_t1[e_pi]
        cot = ((c1 + c2[e_pi]) * mask[:, None].to(bf16)).contiguous()
        direct_ms = time_ms(torch, lambda: interact_bwd(u, q, i_sig, w, cot,
                                                        order))
        del r_b, i_sig, cot
        errors = {}
        for nm, a, c in zip(("du", "dq", "di_t1"), k_b[0], p_b[0]):
            e_, t_ = bf16_held(
                torch, f"interact_bwd_absorb bf16 order {order} {nm}", a, c)
            errors[nm] = {"max_abs_err": e_, "tolerance": t_}
        for nm, a, c in zip(("dw", "db"), k_b[1:], p_b[1:]):
            e_, t_ = (a - c).abs().max().item(), 1e-4 * c.abs().max().item()
            if not e_ <= t_:
                fail(f"interact_bwd_absorb bf16 order {order} {nm}: max "
                     f"error {e_} > {t_}")
            errors[nm] = {"max_abs_err": e_, "tolerance": t_}
        if not (k_b[0][0][mask == 0] == 0).all():
            fail("interact_bwd_absorb bf16: a sigma pad reached du")
        worst = max(errors.values(),
                    key=lambda v: v["max_abs_err"] / max(v["tolerance"],
                                                         1e-30))
        product_rule = {1: 0, 2: 12, 3: 21}[order]
        record("interact_bwd_absorb_bf16", f"order {order}, 3 x [{e_pad}, "
               f"{D}] + 2 cot [{e_pad}, {D}] bf16 + mask -> [3, {e_pad}, "
               f"{D}] bf16, dW, db f32", worst["max_abs_err"],
               worst["tolerance"],
               lambda: interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask,
                                           order),
               lambda: interact_bwd_absorb_plain(u, q, i_t1, pi, w, c1, c2,
                                                 mask, order), None,
               2 * (3 * e_pad * D + 2 * e_pad * D + 3 * e_pad * D)
               + 4 * (2 * e_pad + 2 * w.numel() + D),
               e_pad * (D * (hadamard + product_rule) + D + 2 * D),
               bf16_flops=e_pad * 2 * 2 * parts * D * D, errors=errors,
               max_abs_err_all=max(v["max_abs_err"]
                                   for v in errors.values()),
               bitwise_equal=bitwise, direct_on_permuted_ms=direct_ms,
               reduce_ms=reduce_ms(torch, w, e_pad),
               **parent_ms(
                   torch, "interact_bwd",
                   lambda cb, ref: cb.run_bwd_bf16(
                       ref, True, u, q, i_t1, pi, w, c1, c2, mask, order)))
        del k_b, p_b
    del u, q, i_t1, c1, c2, e_pi


def bf16_ulp_check(torch, got, want):
    """(max abs error, elements off by more than 1 bf16 ulp of the larger
    of the two values plus 1e-5 of the largest ``want``): the rule the bf16
    forms are held to against their twins, which round at the same points
    but sum in another order (a value at a rounding boundary may round the
    other way)."""
    a, b = got.float(), want.float()
    larger = torch.maximum(a.abs(), b.abs())
    _, e = torch.frexp(larger)
    ulp = torch.where(larger == 0, torch.zeros_like(a),
                      torch.ldexp(torch.ones_like(a), e - 8))
    diff = (a - b).abs()
    bad = int((diff > ulp + 1e-5 * b.abs().max()).sum().item())
    return diff.max().item(), bad


def bf16_held(torch, name, got, want):
    """(max error, the row's tolerance) of a bf16 output held to its twin
    by ``bf16_ulp_check``; fails the run when an element is off by more
    than 1 bf16 ulp. The tolerance, 2^-6 of the largest value, is what
    that rule implies."""
    err, bad = bf16_ulp_check(torch, got, want)
    if bad:
        fail(f"{name}: {bad} elements off the twin by more than 1 bf16 "
             f"ulp (max error {err})")
    return err, 2.0 ** -6 * want.float().abs().max().item()


def check_bf16_kernels(torch, dev, graph, results):
    """Phase 3, the bf16 forms (``ModelConfig.bf16_stream``) at the shapes
    of the bf16 serving and training paths: K2 from the f32 node rows to
    bf16 roles, K1 on bf16 rows (the node update and the gather's backward
    into f32, the scatter's backward in the fixed-width form into bf16), K3
    and ``interact_bwd`` on bf16 roles at orders 3 and 1. A bf16 output
    fails the run when an element is off its twin's by more than 1 bf16
    ulp (``bf16_ulp_check``); its row's tolerance is 2^-6 of the largest
    value, which that rule implies. bf16 bytes over the HBM rate, bf16
    products over the dense bf16 rate."""
    from ihgnn_torch.ops.gather import (gather_roles, gather_roles_plain,
                                        round_bf16)
    from ihgnn_torch.ops.interact import (ORDER_PARTS, interact_bwd,
                                          interact_bwd_plain, interact_fwd,
                                          interact_fwd_plain)
    from ihgnn_torch.ops.segsum import csr_gather_sum, csr_gather_sum_plain

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def record(*args, **kwargs):
        record_row(torch, results, *args, **kwargs)

    def library(fn, want):
        """(fn, its max error against ``want``) when the library call runs
        in bf16 on the card, else (None, the reason)."""
        try:
            out = fn()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:
            return None, f"none: {type(e).__name__}: {str(e)[:160]}"
        return fn, (out.float() - want.float()).abs().max().item()

    n = graph.node_count
    i3 = graph.i3

    # K2: [N, d] f32 -> 3 x [E, d] bf16, each value rounded in the copy; the
    # library call gathers the same rows from a bf16 copy of x
    x = randn(n, D)
    x16 = x.to(bf16)
    flat = i3.t().reshape(-1).long()
    k_out = gather_roles(x, i3, bf16)
    if not torch.equal(k_out, gather_roles_plain(x, i3, bf16)):
        fail("gather_roles bf16 is not bitwise its twin")
    if not torch.equal(gather_roles(x16, i3, bf16), k_out):
        fail("gather_roles bf16 from a bf16 x differs from rounding x")
    record("gather_roles_bf16", f"[{n}, {D}] f32 -> 3 x [{E}, {D}] bf16",
           0.0, 0.0, lambda: gather_roles(x, i3, bf16),
           lambda: gather_roles_plain(x, i3, bf16),
           lambda: torch.index_select(x16, 0, flat),
           4 * x.numel() + 4 * i3.numel() + 2 * 3 * E * D, 0,
           library_note="index_select of a bf16 copy of x",
           x_bf16_ms=time_ms(torch, lambda: gather_roles(x16, i3, bf16)),
           round_ms=time_ms(torch, lambda: round_bf16(x)),
           **parent_ms(torch, "gather",
                       lambda cb, ref: cb.run_roles(ref, x, i3, bf16)))
    del x, x16, k_out, flat

    # K1 on bf16 rows: the node update and the gather's backward into f32,
    # 1e-4 of the f32 rows' sums as the f32 form; the library call is
    # torch.sparse.mm on bf16 values where the card runs it
    def sum_bf16(label, rows, col, rowptr, width=None):
        s_out = rowptr.numel() - 1
        out16 = width is not None
        out_dtype = bf16 if out16 else None
        k_out = csr_gather_sum(rows, col, rowptr, width=width,
                               out_dtype=out_dtype)
        p_out = csr_gather_sum_plain(rows, col, rowptr, out_dtype=out_dtype)
        rows8 = rows_at(torch, rows, 8)
        # the same segment lengths with the ids in ascending order: the
        # rows are read in order, so its time is what the random rows cost;
        # with every id 0 one row is read from L1, which leaves the ids, the
        # warps' own work and the stores; the output's memset is the
        # stores' floor
        sorted_col = torch.sort(col).values
        zero_col = torch.zeros_like(col)
        out_like = torch.empty_like(k_out)
        if not torch.equal(k_out, csr_gather_sum(rows8, col, rowptr,
                                                 width=width,
                                                 out_dtype=out_dtype)):
            fail(f"csr_gather_sum bf16 {label}: the 16-byte lanes differ "
                 "from the 8-byte lanes")
        if out16:
            err, tol = bf16_held(torch, f"csr_gather_sum bf16 {label}",
                                 k_out, p_out)
        else:
            err, tol = (k_out - p_out).abs().max().item(), 1e-4
        ones = torch.ones(col.numel(), device=dev, dtype=bf16)
        csr = torch.sparse_csr_tensor(rowptr, col, ones,
                                      size=(s_out, rows.shape[0]))
        l_fn, lib = library(lambda: torch.sparse.mm(csr, rows), p_out)
        record("csr_gather_sum_bf16",
               f"{label} [{col.numel()} entries of [{rows.shape[0]}, {D}] "
               f"bf16 -> [{s_out}, {D}] {'bf16' if out16 else 'f32'}]",
               err, tol,
               lambda: csr_gather_sum(rows, col, rowptr, width=width,
                                      out_dtype=bf16 if out16 else None),
               lambda: csr_gather_sum_plain(
                   rows, col, rowptr, out_dtype=bf16 if out16 else None),
               l_fn, 2 * rows.numel() + 4 * col.numel()
               + (0 if width else 4 * rowptr.numel())
               + (2 if out16 else 4) * s_out * D, col.numel() * D,
               lib if l_fn is not None else None,
               eight_byte_ms=time_ms(torch, lambda: csr_gather_sum(
                   rows8, col, rowptr, width=width, out_dtype=out_dtype)),
               sorted_ids_ms=time_ms(torch, lambda: csr_gather_sum(
                   rows, sorted_col, rowptr, width=width,
                   out_dtype=out_dtype)),
               same_row_ms=time_ms(torch, lambda: csr_gather_sum(
                   rows, zero_col, rowptr, width=width,
                   out_dtype=out_dtype)),
               output_memset_ms=time_ms(torch, out_like.zero_),
               **parent_ms(
                   torch, "segsum",
                   lambda cb, ref: cb.run_k1_bf16(
                       ref, rows, col, rowptr, width or 0,
                       out_dtype or torch.float32)),
               **({} if l_fn is not None else {"library_note": lib}))
        del rows8, sorted_col, zero_col, out_like

    edge = randn(E, D).to(bf16)
    sum_bf16("node update", edge, graph.inc_edge, graph.rowptr)
    del edge
    cot3 = randn(3 * E, D).to(bf16)
    sum_bf16("gather backward", cot3, graph.inc_slot, graph.rowptr)
    del cot3
    cot_n = randn(n, D).to(bf16)
    sum_bf16("scatter backward", cot_n, i3.view(-1), graph.edge_rowptr,
             width=3)
    del cot_n

    # K3 and interact_bwd on bf16 roles, orders 3 and 1
    u, q, i = (randn(E, D).to(bf16) for _ in range(3))
    cot = randn(E, D).to(bf16)
    for order in (3, 1):
        parts = ORDER_PARTS[order]
        w = randn(parts * D, D) / (parts * D) ** 0.5
        b = randn(D)
        hadamard = {1: 0, 2: 3, 3: 4}[order]
        k_out = interact_fwd(u, q, i, w, b, order)
        err, tol = bf16_held(torch, f"interact_fwd bf16 order {order}",
                             k_out, interact_fwd_plain(u, q, i, w, b, order))
        record("interact_fwd_bf16", f"order {order}, 3 x [{E}, {D}] bf16 -> "
               f"[{E}, {D}] bf16", err, tol,
               lambda: interact_fwd(u, q, i, w, b, order),
               lambda: interact_fwd_plain(u, q, i, w, b, order), None,
               2 * 3 * E * D + 4 * (w.numel() + D) + 2 * E * D,
               E * (hadamard + 1) * D, bf16_flops=E * 2 * parts * D * D)
        del k_out
        k_droles, *k_params = interact_bwd(u, q, i, w, cot, order)
        p_droles, *p_params = interact_bwd_plain(u, q, i, w, cot, order)
        errors = {}
        for nm, a, c in zip(("du", "dq", "di"), k_droles, p_droles):
            e_, t_ = bf16_held(
                torch, f"interact_bwd bf16 order {order} {nm}", a, c)
            errors[nm] = {"max_abs_err": e_, "tolerance": t_}
        for nm, a, c in zip(("dw", "db"), k_params, p_params):
            e_, t_ = (a - c).abs().max().item(), 1e-4 * c.abs().max().item()
            if not e_ <= t_:
                fail(f"interact_bwd bf16 order {order} {nm}: max error "
                     f"{e_} > {t_}")
            errors[nm] = {"max_abs_err": e_, "tolerance": t_}
        worst = max(errors.values(),
                    key=lambda v: v["max_abs_err"] / max(v["tolerance"],
                                                         1e-30))
        product_rule = {1: 0, 2: 12, 3: 21}[order]
        record("interact_bwd_bf16", f"order {order}, 3 x [{E}, {D}] + cot "
               f"[{E}, {D}] bf16 -> [3, {E}, {D}] bf16, dW [{parts * D}, "
               f"{D}], db f32", worst["max_abs_err"], worst["tolerance"],
               lambda: interact_bwd(u, q, i, w, cot, order),
               lambda: interact_bwd_plain(u, q, i, w, cot, order), None,
               2 * (3 * E * D + E * D + 3 * E * D)
               + 4 * (2 * w.numel() + D),
               E * (D * (hadamard + product_rule) + D),
               bf16_flops=E * 2 * 2 * parts * D * D, errors=errors,
               max_abs_err_all=max(v["max_abs_err"]
                                   for v in errors.values()),
               reduce_ms=reduce_ms(torch, w, E),
               **parent_ms(
                   torch, "interact_bwd",
                   lambda cb, ref: cb.run_bwd_bf16(
                       ref, False, u, q, i, None, w, cot, None, None, order)))
        del k_droles, k_params, p_droles, p_params
    del u, q, i, cot


IHGNN_SERVING = ("csr_gather_sum", "gather_roles", "interact_fwd")
IHGNN_TRAIN = IHGNN_SERVING + ("interact_bwd",)
GAT_SERVING = ("csr_gather_sum", "csr_segment_max", "csr_segment_sum")
GAT_TRAIN = GAT_SERVING + ("csr_edge_dot",)
# the kernels' launches of one GAT forward and of one GAT train step: every
# [K, d] row stream of the attention is one of these kernels, so any other
# count means a row stream went elsewhere. A forward: K1 for the bag and
# for each layer's weighted sum, K4 and one sum (denominators) a layer. A
# step adds the bag's backward and, a layer, K1 for dx, csr_edge_dot for tt
# and three sums (tsum, gd, gs)
GAT_FORWARD_LAUNCHES = {"csr_gather_sum": 3, "csr_segment_max": 2,
                        "csr_segment_sum": 2}
GAT_STEP_LAUNCHES = {"csr_gather_sum": 6, "csr_segment_max": 2,
                     "csr_segment_sum": 8, "csr_edge_dot": 2}
# the product head's step: csr_edge_dot for a layer's scores too, and its
# backward's two K1 (g · x[dst] by source, g · x[src] by destination) in
# place of the concat head's two sums
GAT_PRODUCT_STEP_LAUNCHES = {"csr_gather_sum": 10, "csr_segment_max": 2,
                             "csr_segment_sum": 4, "csr_edge_dot": 4}
# the same for the default model on the direct path: a forward runs K1 for
# the bag and, a layer, K2, K3 and K1's node update; a step adds the bag's
# backward and, a layer, the node update's and the gather's backward (K1)
# and interact_bwd
IHGNN_FORWARD_LAUNCHES = {"csr_gather_sum": 3, "gather_roles": 2,
                          "interact_fwd": 2}
IHGNN_STEP_LAUNCHES = {"csr_gather_sum": 8, "gather_roles": 2,
                       "interact_fwd": 2, "interact_bwd": 2}
# with remat a step runs each layer's forward kernels once more in the
# backward: K2, K3 and the node update's K1 twice a layer
IHGNN_STEP_LAUNCHES_REMAT = {"csr_gather_sum": 10, "gather_roles": 4,
                             "interact_fwd": 4, "interact_bwd": 2}
# IHGNN with phase-2 attention, direct: a layer's gather (K2) and K3, then
# the attention over [x' | edge] in place of the node update (K4, a sum,
# K1); a step adds the bag's backward and, a layer, interact_bwd, the
# gather's backward (K1) and the attention's backward (csr_edge_dot, K1,
# three sums)
PHASE2_TRAIN = IHGNN_TRAIN + ("csr_segment_max", "csr_segment_sum",
                              "csr_edge_dot")
PHASE2_STEP_LAUNCHES = {"csr_gather_sum": 8, "gather_roles": 2,
                        "interact_fwd": 2, "interact_bwd": 2,
                        "csr_segment_max": 2, "csr_segment_sum": 8,
                        "csr_edge_dot": 2}
# phase 2 on a routed pack: the routed gather (u expand; q and i expands
# and stage-1 permutes, i's stage 2), K3 unabsorbed, the edge rows put back
# in edge order (K6), the attention; a step adds the σ permute's backward
# (K6), interact_bwd, the gather's backward (three inverse permutes and
# the three-region K1) and the attention's backward
PHASE2_ROUTED_TRAIN = ("csr_gather_sum", "gather_rows", "gather_rows_t",
                       "transposed_local_permute", "row_local_permute",
                       "csr_segment_sum3", "interact_fwd", "interact_bwd",
                       "csr_segment_max", "csr_segment_sum", "csr_edge_dot")
PHASE2_ROUTED_STEP_LAUNCHES = {
    "csr_gather_sum": 6, "gather_rows": 2, "gather_rows_t": 4,
    "transposed_local_permute": 10, "row_local_permute": 6,
    "csr_segment_sum3": 2, "interact_fwd": 2, "interact_bwd": 2,
    "csr_segment_max": 2, "csr_segment_sum": 8, "csr_edge_dot": 2,
    "gather_roles": 0, "interact_fwd_absorb": 0, "interact_bwd_absorb": 0}
# HGCN on the log hypergraph: K1 for the bag and, a layer, the edge sums
# and the node sums, each the other's backward
LOG_TRAIN = ("csr_gather_sum",)
LOG_STEP_LAUNCHES = {"csr_gather_sum": 10, "gather_roles": 0,
                     "csr_segment_sum3": 0, "interact_fwd": 0}
# the default model on bf16 streams: the same kernels in their bf16 forms
# (name_bf16), but for the bag's K1 (f32 rows) both ways; the f32 forms of
# K2, K3 and interact_bwd must not run
IHGNN_SERVING_BF16 = ("csr_gather_sum", "csr_gather_sum_bf16",
                      "gather_roles_bf16", "interact_fwd_bf16")
IHGNN_TRAIN_BF16 = IHGNN_SERVING_BF16 + ("interact_bwd_bf16",)
IHGNN_FORWARD_LAUNCHES_BF16 = {"csr_gather_sum": 1, "csr_gather_sum_bf16": 2,
                               "gather_roles": 0, "gather_roles_bf16": 2,
                               "interact_fwd": 0, "interact_fwd_bf16": 2}
IHGNN_STEP_LAUNCHES_BF16 = {"csr_gather_sum": 2, "csr_gather_sum_bf16": 6,
                            "gather_roles": 0, "gather_roles_bf16": 2,
                            "interact_fwd": 0, "interact_fwd_bf16": 2,
                            "interact_bwd": 0, "interact_bwd_bf16": 2}
IHGNN_STEP_LAUNCHES_BF16_REMAT = {"csr_gather_sum": 2,
                                  "csr_gather_sum_bf16": 8,
                                  "gather_roles": 0, "gather_roles_bf16": 4,
                                  "interact_fwd": 0, "interact_fwd_bf16": 4,
                                  "interact_bwd": 0, "interact_bwd_bf16": 2}
# bf16 streams against f32 at full width: the features within this share
# of the f32 features' largest value (a node sums bf16-rounded edge rows,
# 2^-9 relative each, through two layers); the JAX package's own test of
# its bf16 path against f32 (tests/test_bf16_stream.py) uses 2e-2
BF16_FEATURE_RTOL = 2e-2
# card against CPU on the small graph with bf16 streams (and remat): twins
# and kernels round at the same points, but an f32 sum in another order
# can round an edge row the other way by a bf16 ulp (2^-8 relative), which
# reaches the features, the losses and the gradients; Adam moves a
# parameter by up to lr (1e-3) a step whatever its gradient's size, so
# three steps move a parameter whose tiny gradient flips sign by up to 6e-3
BF16_SMALL_TOL = dict(feature_atol=1e-2, loss_rtol=1e-3, grad_rtol=1e-2,
                      param_atol=1e-2)


def _describe(cfg, graph):
    """The model and graph fields of a path's JSON row."""
    from ihgnn_torch.config import V
    row = {"gnn": cfg.gnn, "nodes": graph.node_count,
           "layers": cfg.gnn_layer_count, "d": cfg.embedding_size}
    if cfg.gnn == V.IHGNN:
        row.update(edges=graph.edge_count,
                   orders=[cfg.layer_order(k)
                           for k in range(cfg.gnn_layer_count)],
                   routed=graph.kp is not None)
        if graph.kp is not None:
            row.update(grids=[[pk.rows, pk.cols] for pk in graph.kp.packs],
                       e_pad=graph.kp.e_pad)
    else:
        row.update(entries=graph.nnz, head=cfg.gat_head,
                   routed=graph.pk_role is not None)
        if cfg.gnn == V.GAT and graph.gat_pk is not None:
            row["gat_packs"] = len(graph.gat_pk.packs)
    return row


def _check_counts(path, launches, per_unit, units):
    """Fails unless each kernel of ``per_unit`` launched ``units`` times its
    count there."""
    if per_unit is None:
        return
    want = {k: v * units for k, v in per_unit.items()}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"{path}: kernel launches {got}, expected {want}")


def run_serving(torch, dev, cfg, graph, qw, qc, path, expected,
                per_forward=None, sizes=None):
    """Phases 4 and 10: a serving path at full width; returns the launch
    counts and what the profile phase reuses. ``sizes``: (U, Q, I, V), the
    bench shape's when None."""
    from ihgnn_torch.config import TrainConfig
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.train.eval import evaluate, make_eval_fns

    users, queries, items, vocab = sizes or (U, Q, I, VOCAB)
    model = RawGnn(cfg, users, queries, items, vocab,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    model.eval()
    logs = random_eval_logs(users, queries, items, EVAL_LOGS, seed=2)
    features_fn, metrics_fn = make_eval_fns(model, graph, qw, qc,
                                            device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.perf_counter()
    features = features_fn()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    features = features_fn()
    torch.cuda.synchronize()
    features_ms = (time.perf_counter() - t0) * 1e3
    # the first evaluate carries the libraries' one-time set-up (cuBLAS
    # handle, top-k workspaces); the second is the warm rate
    timings = []
    for _ in range(2):
        metrics, rows, eval_s = evaluate(
            features_fn, metrics_fn, logs, TrainConfig().eval_batch_size,
            collect_rows=True, features=features)
        timings.append(eval_s)
    launches = _read_launches(path, expected)
    _check_counts(path, launches, per_forward, 2)
    repeats = time_features(torch, features_fn)

    n = graph.node_count
    if tuple(features.shape) != (n, cfg.output_feature_size):
        fail(f"{path}: features shape {tuple(features.shape)}")
    if not torch.isfinite(features).all():
        fail(f"{path}: non-finite features")
    with torch.inference_mode():
        scores = model.score_all_items(
            features, torch.as_tensor(logs.users[:EVAL_BATCH]).to(dev),
            torch.as_tensor(logs.queries[:EVAL_BATCH]).to(dev))
    if tuple(scores.shape) != (EVAL_BATCH, items) \
            or not torch.isfinite(scores).all():
        fail(f"{path}: bad scores {tuple(scores.shape)}")
    row = metrics.as_row()
    if rows.shape != (logs.count, 4) or not np.isfinite(rows).all() \
            or not all(0.0 <= v <= 1.0 for v in row):
        fail(f"{path}: bad metrics {row}")
    emit({"phase": path, **_describe(cfg, graph), "forwards": 2,
          "first_features_ms": first_ms, "features_ms": features_ms,
          **repeats, "eval_logs": logs.count, "eval_batch": EVAL_BATCH,
          "first_eval_s": timings[0], "eval_s": timings[1],
          "eval_pairs_per_s": logs.count / timings[1],
          "metrics": dict(zip(["HR@10", "NDCG@10", "MAP@10", "MRR@10"], row)),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "launches": launches})
    return launches, (features_fn, metrics_fn, features, logs), row


def _trace_events(path):
    """The complete events of a ``torch.profiler`` Chrome trace."""
    with open(path, encoding="utf-8") as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def _window_summary(events):
    """Device busy time and idle share of a trace's complete events
    (``benchmark/trace.py`` ``summarize``: the union of its kernel, copy
    and set spans over the span of all its events), its longest idle
    gaps, and its annotations (``benchmark/spans.py`` ``attribute``: the
    port's spans and the profiler's own, each name's count and host,
    self, device and idle ms)."""
    from benchmark.spans import attribute
    from benchmark.trace import summarize
    s = summarize(events)
    if not s:
        return {"device_time": "not measured: the trace has no device "
                               "events"}
    by = attribute(events)
    return {"window_ms": s["window_s"] * 1e3,
            "device_busy_ms": s["busy_s"] * 1e3,
            "device_idle_share": 1.0 - s["busy_s"] / s["window_s"],
            "idle_gaps": s["idle_gaps"],
            "spans": {name: {(k if k == "count" else k[:-2] + "_ms"):
                             (v if k == "count" else v * 1e3)
                             for k, v in r.items()}
                      for name, r in by.get("by_name", {}).items()}}


def profile_window(torch, label, fn):
    """One JSON row for ``fn()`` run under ``torch.profiler``: device time
    by kernel, the device's busy time and idle share of the window, and
    the host operators that took the most CPU time. ``fn`` runs twice, a
    warm-up step the profiler discards and the recorded one: without the
    warm-up the first kernels of the window went missing from the record
    (a bf16 step listed one of its two K2 launches). The busy time and
    the window come from the exported Chrome trace (``_window_summary``);
    the profiler's GPU annotations (``ProfilerStep*``, ``Optimizer.step``),
    which span the gaps between kernels, count as no device time. The
    port's tracing is on, so ``spans`` gives each phase's host, device and
    idle ms. ``top_kernels`` lists the trace's kernels by name with their
    calls, which the launch counts of the window can be held against."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    from ihgnn_torch.utils import tracing
    recorded = {}

    def ready(prof):
        prof.export_chrome_trace(recorded["path"])
        recorded["host"] = list(prof.key_averages())

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        recorded["path"] = os.path.join(tmp, "window.trace.json")
        tracing.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=ready) as prof:
                for _ in range(2):
                    fn()
                    torch.cuda.synchronize()
                    prof.step()
        finally:
            tracing.disable()
        events = _trace_events(recorded["path"])
    summary = _window_summary(events)
    traced = [e for e in events if e.get("cat") == "kernel"]
    by_trace = {}
    for e in traced:
        ms, n = by_trace.get(e["name"], (0.0, 0))
        by_trace[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    top = [{"name": k[:90], "ms": ms, "calls": n} for k, (ms, n) in
           sorted(by_trace.items(), key=lambda kv: -kv[1][0])[:14]]
    host = sorted(recorded["host"], key=lambda a: -a.self_cpu_time_total)
    row = {"phase": "profile", "window": label,
           "trace_kernel_events": len(traced), "top_kernels": top}
    row.update(summary)
    row["top_host_ops"] = [{"name": a.key[:60],
                            "self_cpu_ms": a.self_cpu_time_total / 1e3,
                            "calls": a.count} for a in host[:8]]
    return row


def profile_serving(torch, features_fn, metrics_fn, features, logs):
    """Phase 5: one warm full-graph forward, then one warm eval batch, each
    under ``torch.profiler``."""
    users, queries, truth, counts, _ = next(logs.batches(EVAL_BATCH))
    emit(profile_window(torch, "features_fn", features_fn))
    emit(profile_window(torch, f"one eval batch of {EVAL_BATCH}",
                        lambda: metrics_fn(features, users, queries, truth,
                                           counts).cpu()))


def check_small(torch, dev):
    """Phase 6: the model on the card against the same model on the CPU."""
    import copy

    from ihgnn_torch.config import ModelConfig
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.train.eval import evaluate, make_eval_fns

    s = SMALL
    graph, _ = random_graph(s["users"], s["queries"], s["items"],
                            s["edges"], 5)
    qw, qc = random_words(s["queries"], s["vocab"], 6)
    logs = random_eval_logs(s["users"], s["queries"], s["items"], 64, 7)
    model = RawGnn(ModelConfig(), s["users"], s["queries"], s["items"],
                   s["vocab"], generator=torch.Generator().manual_seed(3))
    out = {}
    for name, m in (("cpu", model), ("cuda", copy.deepcopy(model).to(dev))):
        f_fn, m_fn = make_eval_fns(m, graph, qw, qc, device=name if name ==
                                   "cpu" else dev)
        feats = f_fn()
        metrics, _, _ = evaluate(f_fn, m_fn, logs, 16, features=feats)
        out[name] = (feats.cpu(), metrics.as_row())
    err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
    m_err = max(abs(a - b) for a, b in zip(out["cpu"][1], out["cuda"][1]))
    emit({"phase": "small_reference", "features_max_abs_err": err,
          "metrics_max_abs_err": m_err, "tolerance": 1e-4})
    if not err <= 1e-4 or not m_err <= 1e-4:
        fail(f"card and CPU disagree on the small graph ({err}, {m_err})")


def run_train(torch, dev, cfg, graph, uqi, qw, qc, path, expected,
              per_step=None, sizes=None):
    """Phases 7 and 11: a train path at full width; returns the launch
    counts and the step the profile phase reuses. ``sizes``: (U, Q, I, V),
    the bench shape's when None."""
    from ihgnn_torch.config import TrainConfig, V
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.train.train import make_optimizer, make_train_step

    users, queries, items, vocab = sizes or (U, Q, I, VOCAB)
    tcfg = TrainConfig(batch_size=TRAIN_B,
                       random_negative_sample_size=TRAIN_K)
    model = RawGnn(cfg, users, queries, items, vocab,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(model.parameters(), tcfg)
    step = make_train_step(model, graph, qw, qc, opt, device=dev)
    batches = [train_batch(uqi, items, TRAIN_B, TRAIN_K, seed) for seed in
               range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    losses = [step(batches[k % 4]) for k in range(WARM_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(TIMED_STEPS):
        losses.append(step(batches[(WARM_STEPS + k) % 4]))
    # the steps queue work without waiting for the card: the host's time
    # to issue them, against the time until the card has run them all
    issue_s = (time.perf_counter() - t0) / TIMED_STEPS
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = _read_launches(path, expected)
    steps = WARM_STEPS + TIMED_STEPS
    _check_counts(path, launches, per_step, steps)
    losses = [x.item() for x in losses]
    if not all(np.isfinite(losses)):
        fail(f"{path}: non-finite train losses {losses}")
    row = {"phase": path, **_describe(cfg, graph),
           "rows": TRAIN_B * (1 + TRAIN_K), "warm_steps": WARM_STEPS,
           "timed_steps": TIMED_STEPS, "train_step_ms": step_s * 1e3,
           "host_issue_ms": issue_s * 1e3}
    if cfg.gnn == V.IHGNN:
        row["hyperedge_aggregations_per_s"] = \
            graph.edge_count * cfg.gnn_layer_count / step_s
    else:
        row["entry_aggregations_per_s"] = \
            graph.nnz * cfg.gnn_layer_count / step_s
    row.update({"losses": losses,
                "max_memory_allocated_bytes":
                    torch.cuda.max_memory_allocated(dev),
                "launches": launches,
                "launches_per_step": {k: v / steps
                                      for k, v in launches.items()}})
    emit(row)
    return launches, lambda: step(batches[0]), losses


def check_repeatable_full_width(torch, dev, cfg, graph_cpu, uqi, qw, qc,
                                phase="repeatable_full_width", cfg_b=None):
    """Phase ``phase``: two train steps at full width, the first of
    ``cfg``, the second of ``cfg_b`` (``cfg`` when None), each from the
    same seeded model and optimizer on the same batch, compared bit for
    bit: the loss, every gradient and every parameter after the step.
    Returns whether they agree."""
    from ihgnn_torch.config import TrainConfig
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.train.train import make_optimizer, make_train_step

    tcfg = TrainConfig(batch_size=TRAIN_B,
                       random_negative_sample_size=TRAIN_K)
    batch = train_batch(uqi, I, TRAIN_B, TRAIN_K, seed=0)
    runs = []
    for run_cfg in (cfg, cfg_b or cfg):
        model = RawGnn(run_cfg, U, Q, I, VOCAB,
                       generator=torch.Generator().manual_seed(0)).to(dev)
        step = make_train_step(model, graph_cpu, qw, qc,
                               make_optimizer(model.parameters(), tcfg),
                               device=dev)
        loss = step(batch).item()
        # the step leaves its gradients in .grad until the next one
        runs.append((loss,
                     {k: p.grad.detach().clone()
                      for k, p in model.named_parameters()},
                     {k: v.detach().clone()
                      for k, v in model.state_dict().items()}))
        del model, step
    (loss_a, grads_a, params_a), (loss_b, grads_b, params_b) = runs
    grads_differ = sorted(k for k in grads_a
                          if not torch.equal(grads_a[k], grads_b[k]))
    params_differ = sorted(k for k in params_a
                           if not torch.equal(params_a[k], params_b[k]))
    same = loss_a == loss_b and not grads_differ and not params_differ
    emit({"phase": phase, phase: same,
          "configs": [{"bf16_stream": c.bf16_stream, "remat": c.remat}
                      for c in (cfg, cfg_b or cfg)],
          "losses": [loss_a, loss_b], "grads_differ": grads_differ,
          "params_differ": params_differ,
          "grad_max_abs_diff": {k: (grads_a[k] - grads_b[k]).abs().max()
                                .item() for k in grads_differ},
          "param_max_abs_diff": {k: (params_a[k] - params_b[k]).abs().max()
                                 .item() for k in params_differ}})
    return same


def grad_scale(name, grads):
    """The largest value of gradient ``name``, or for an attention score
    head (``*.feature_aggregate.*``) the largest gradient of its layer: the
    softmax ignores a shift of all scores of a destination, so the head's
    bias gradient (and the concat head's destination half) sum terms that
    cancel but for the LeakyReLU's two slopes, and where a layer's slopes
    are alike their own largest value is f32 rounding noise."""
    if ".feature_aggregate." in name:
        layer = name.split(".")[:2]
        return max(g.abs().max().item() for k, g in grads.items()
                   if k.split(".")[:2] == layer)
    return max(grads[name].abs().max().item(), 1e-30)


def train_card_vs_cpu(torch, dev, cfg, graph, uqi, qw, qc, seed, tol=None):
    """SMALL_STEPS train steps of ``RawGnn(cfg)`` on ``graph``, on the card
    and on the CPU (plain twins), from the same weights and batches, then
    the card once more. Returns the JSON fields of the comparison and
    whether it holds the limits: SMALL_FEATURE_ATOL, SMALL_LOSS_RTOL,
    SMALL_GRAD_RTOL and SMALL_PARAM_ATOL, or those of ``tol``
    (``feature_atol``, ``loss_rtol``, ``grad_rtol``, ``param_atol``)."""
    tol = dict(dict(feature_atol=SMALL_FEATURE_ATOL,
                    loss_rtol=SMALL_LOSS_RTOL, grad_rtol=SMALL_GRAD_RTOL,
                    param_atol=SMALL_PARAM_ATOL), **(tol or {}))
    import copy

    from ihgnn_torch.config import TrainConfig
    from ihgnn_torch.models.embedding import make_word_bag
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.train.train import make_optimizer, make_train_step

    s = SMALL
    model = RawGnn(cfg, s["users"], s["queries"], s["items"], s["vocab"],
                   generator=torch.Generator().manual_seed(seed))
    batches = [train_batch(uqi, s["items"], SMALL_B, TRAIN_K, seed + 1 + k)
               for k in range(SMALL_STEPS)]
    bag = make_word_bag(qw, qc, s["vocab"] + 1)

    def train(device):
        m = copy.deepcopy(model).to(device)
        with torch.no_grad():
            feats = m.all_features(graph.to(device), bag.to(device)).cpu()
        opt = make_optimizer(m.parameters(), TrainConfig())
        step = make_train_step(m, graph, qw, qc, opt, device=device)
        losses, grads0 = [], None
        for b in batches:
            losses.append(step(b).item())
            if grads0 is None:
                # the step leaves its gradients in .grad until the next one
                grads0 = {k: p.grad.detach().cpu().clone()
                          for k, p in m.named_parameters()}
        return feats, losses, grads0, {k: v.detach().cpu() for k, v in
                                       m.state_dict().items()}

    cpu_feats, cpu_losses, cpu_grads, cpu_params = train("cpu")
    card_feats, card_losses, card_grads, card_params = train(dev)
    _, again_losses, _, again_params = train(dev)
    feat_err = (card_feats - cpu_feats).abs().max().item()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                       cpu_losses))
    grad_err = {k: (card_grads[k] - g).abs().max().item() /
                grad_scale(k, cpu_grads) for k, g in cpu_grads.items()}
    param_errs = {k: (card_params[k] - cpu_params[k]).abs().max().item()
                  for k in cpu_params}
    # a score head's parameters are left out of the parameter limit: their
    # gradients are rounding noise of about Adam's eps (see grad_scale), and
    # Adam turns noise of either sign into moves of up to lr; their step-0
    # gradients are held above
    param_err = max(v for k, v in param_errs.items()
                    if ".feature_aggregate." not in k)
    head_errs = {k: v for k, v in param_errs.items()
                 if ".feature_aggregate." in k}
    repeatable = again_losses == card_losses and all(
        torch.equal(again_params[k], card_params[k]) for k in card_params)
    bad_grads = {k: v for k, v in grad_err.items()
                 if not v <= tol["grad_rtol"]}
    ok = (feat_err <= tol["feature_atol"] and loss_err <= tol["loss_rtol"]
          and not bad_grads and param_err <= tol["param_atol"])
    row = {"steps": SMALL_STEPS, "features_max_abs_err": feat_err,
           "features_atol": tol["feature_atol"],
           "card_losses": card_losses, "cpu_losses": cpu_losses,
           "loss_max_rel_err": loss_err, "loss_rtol": tol["loss_rtol"],
           "grad0_rel_err": grad_err, "grad0_rtol": tol["grad_rtol"],
           "param_max_abs_err": param_err, "param_atol": tol["param_atol"],
           "repeatable": repeatable}
    if head_errs:
        row["score_head_param_abs_err"] = head_errs
    return row, ok


def check_small_train(torch, dev):
    """Phase 9: the default model's train steps, card against CPU."""
    from ihgnn_torch.config import ModelConfig

    s = SMALL
    graph, uqi = random_graph(s["users"], s["queries"], s["items"],
                              s["edges"], 8)
    qw, qc = random_words(s["queries"], s["vocab"], 9)
    row, ok = train_card_vs_cpu(torch, dev, ModelConfig(), graph, uqi, qw,
                                qc, 10)
    emit({"phase": "small_train_reference", **row})
    if not ok:
        fail(f"card and CPU training disagree on the small graph: {row}")


def check_small_bf16(torch, dev):
    """Phase ``small_bf16_reference``: the default model on bf16 streams
    with remat, train steps card against CPU on a small graph, held to
    BF16_SMALL_TOL."""
    from ihgnn_torch.config import ModelConfig

    s = SMALL
    graph, uqi = random_graph(s["users"], s["queries"], s["items"],
                              s["edges"], 60)
    qw, qc = random_words(s["queries"], s["vocab"], 61)
    row, ok = train_card_vs_cpu(torch, dev,
                                ModelConfig(bf16_stream=True, remat=True),
                                graph, uqi, qw, qc, 62, tol=BF16_SMALL_TOL)
    emit({"phase": "small_bf16_reference", **row})
    if not ok:
        fail(f"card and CPU disagree on the small graph with bf16 streams "
             f"and remat: {row}")


def small_log_graph(users, queries, items, logs, seed):
    """A CPU ``LogHyperGraph`` of ``log_edges``' logs."""
    from ihgnn_torch.graph import log_hypergraph_from_edges
    return log_hypergraph_from_edges(*log_edges(users, queries, items, logs,
                                                seed),
                                     users + queries + items)


def log_edges(users, queries, items, logs, seed):
    """``logs`` random {u, q, 1-3 distinct items} logs: ``(member ids,
    sizes)`` for ``TrainJob.log_edges`` (global ids, each log's u, q, then
    its items)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 4, logs) + 2
    picks = rng.integers(0, items, (logs, 3))
    while True:
        # a log's picks that repeat an earlier one are drawn again
        dup = ((picks[:, 1] == picks[:, 0])
               | ((picks[:, 2] == picks[:, 0]) | (picks[:, 2] == picks[:, 1]))
               & (sizes == 5))
        dup &= sizes >= 4
        if not dup.any():
            break
        picks[dup, 1:] = rng.integers(0, items, (int(dup.sum()), 2))
    rows = np.column_stack([rng.integers(0, users, logs),
                            users + rng.integers(0, queries, logs),
                            users + queries + picks])
    keep = np.arange(5)[None, :] < sizes[:, None]
    return rows[keep].astype(np.int64), sizes


def check_small_zoo(torch, dev):
    """Phase 12: every layer type of the zoo, card against CPU on a small
    graph: features, SMALL_STEPS losses, every step-0 gradient and the
    parameters after the last step. A tenth of the 2D graph's flags are 0,
    so GAT also masks entries."""
    from ihgnn_torch.config import ModelConfig, V
    from ihgnn_torch.graph import build_graph2d

    s = SMALL
    hyper, uqi = random_graph(s["users"], s["queries"], s["items"],
                              s["edges"], 20)
    flags = (np.random.default_rng(21).random(len(uqi)) > 0.1).astype(
        np.int64)
    graph2d = build_graph2d(np.column_stack([uqi, flags]),
                            hyper.node_count, s["users"], s["queries"])
    log_graph = small_log_graph(s["users"], s["queries"], s["items"], 150,
                                22)
    qw, qc = random_words(s["queries"], s["vocab"], 23)
    cases = {
        "gcn": (ModelConfig(gnn=V.GCN), graph2d),
        "gat": (ModelConfig(gnn=V.GAT), graph2d),
        "gat_product": (ModelConfig(gnn=V.GAT, gat_head=V.PRODUCT), graph2d),
        "hgcn": (ModelConfig(gnn=V.HGCN), hyper),
        "hgcn_log": (ModelConfig(gnn=V.HGCN, use_log_hypergraph=True),
                     log_graph),
        "phase2": (ModelConfig(phase2_attention=True), hyper),
    }
    failed = []
    for j, (case, (cfg, graph)) in enumerate(cases.items()):
        row, ok = train_card_vs_cpu(torch, dev, cfg, graph, uqi, qw, qc,
                                    30 + 10 * j)
        emit({"phase": "small_zoo_reference", "case": case, **row})
        if not ok:
            failed.append(case)
    if failed:
        fail(f"card and CPU disagree on the small zoo cases {failed}")


# the routed path's launches a forward of the default model: K1 for the bag;
# a layer: the u expand, the q and i expands (transposed), stage 1 of q and
# of i, K5, the two inverse chains' first steps and K1's three-region sum.
# A train step adds the bag's backward and, a layer, the scatter's
# backward (three expands, two stage-1 permutes), K5's backward and the
# gather's backward (two inverse permutes and a three-region sum). A kernel
# at 0 must not run on the path
ROUTED_SERVING = ("csr_gather_sum", "gather_rows", "gather_rows_t",
                  "transposed_local_permute", "csr_segment_sum3",
                  "interact_fwd_absorb")
ROUTED_TRAIN = ROUTED_SERVING + ("interact_bwd_absorb",)
ROUTED_FORWARD_LAUNCHES = {"csr_gather_sum": 1, "gather_rows": 2,
                           "gather_rows_t": 4, "transposed_local_permute": 8,
                           "csr_segment_sum3": 2, "interact_fwd_absorb": 2,
                           "row_local_permute": 0, "gather_roles": 0,
                           "interact_fwd": 0, "csr_segment_scan": 0}
ROUTED_STEP_LAUNCHES = {"csr_gather_sum": 2, "gather_rows": 4,
                        "gather_rows_t": 8, "transposed_local_permute": 16,
                        "csr_segment_sum3": 4, "interact_fwd_absorb": 2,
                        "interact_bwd_absorb": 2, "row_local_permute": 0,
                        "gather_roles": 0, "interact_fwd": 0,
                        "interact_bwd": 0, "csr_segment_scan": 0}
# the first layer's node update, its sum by K8: the bag, the layer's
# gather and K5, the two inverse chains' first steps, then K8
ROUTED_SCAN_LAUNCHES = {"csr_gather_sum": 1, "gather_rows": 1,
                        "gather_rows_t": 2, "transposed_local_permute": 4,
                        "interact_fwd_absorb": 1, "csr_segment_scan": 1,
                        "csr_segment_sum3": 0}
# the routed path against the direct one at full width: features (a
# node's rows summed in another order) and the step-0 loss
ROUTED_FEATURE_ATOL, ROUTED_LOSS_RTOL = 1e-4, 1e-4
# the routed path on bf16 streams: the same launches in the bf16 forms
# (name_bf16), but for the bag's K1 (f32 rows) both ways; no f32 form of a
# routed kernel, and no kernel of the direct or phase-2 paths, may run
_ROUTED_BF16_ZERO = {k: 0 for k in (
    "gather_rows", "gather_rows_t", "transposed_local_permute",
    "row_local_permute", "row_local_permute_bf16", "csr_segment_sum3",
    "interact_fwd_absorb", "interact_bwd_absorb", "gather_roles",
    "gather_roles_bf16", "interact_fwd", "interact_fwd_bf16",
    "interact_bwd", "interact_bwd_bf16", "csr_segment_scan",
    "csr_segment_scan_bf16", "csr_gather_sum_bf16")}
ROUTED_SERVING_BF16 = ("csr_gather_sum", "gather_rows_bf16",
                       "gather_rows_t_bf16", "transposed_local_permute_bf16",
                       "csr_segment_sum3_bf16", "interact_fwd_absorb_bf16")
ROUTED_TRAIN_BF16 = ROUTED_SERVING_BF16 + ("interact_bwd_absorb_bf16",)
ROUTED_FORWARD_LAUNCHES_BF16 = dict(
    _ROUTED_BF16_ZERO, csr_gather_sum=1, gather_rows_bf16=2,
    gather_rows_t_bf16=4, transposed_local_permute_bf16=8,
    csr_segment_sum3_bf16=2, interact_fwd_absorb_bf16=2,
    interact_bwd_absorb_bf16=0)
ROUTED_STEP_LAUNCHES_BF16 = dict(
    _ROUTED_BF16_ZERO, csr_gather_sum=2, gather_rows_bf16=4,
    gather_rows_t_bf16=8, transposed_local_permute_bf16=16,
    csr_segment_sum3_bf16=4, interact_fwd_absorb_bf16=2,
    interact_bwd_absorb_bf16=2)
ROUTED_SCAN_LAUNCHES_BF16 = dict(
    _ROUTED_BF16_ZERO, csr_gather_sum=1, gather_rows_bf16=1,
    gather_rows_t_bf16=2, transposed_local_permute_bf16=4,
    interact_fwd_absorb_bf16=1, csr_segment_scan_bf16=1,
    csr_segment_sum3_bf16=0)
# the routed bf16 path against the direct bf16 path at full width: the
# features within BF16_FEATURE_RTOL of the largest (the bf16 bound above),
# the step-0 losses within this
ROUTED_BF16_LOSS_RTOL = 1e-3


def run_routed_scan(torch, dev, cfg, graph_cpu, qw, qc,
                    path="routed_scan", expected=ROUTED_SCAN_LAUNCHES):
    """Phase ``routed_scan`` (``routed_bf16_scan`` for a ``cfg`` with bf16
    streams): the first layer's routed node-update stream (the
    interaction's σ-ordered output and the q and i inverse chains' first
    steps, 3 e_pad rows, f32 or bf16) summed by K8, which must equal the
    layer's own K1 three-region sum bit for bit."""
    from ihgnn_torch.models.embedding import make_word_bag
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.ops.hyperagg import make_hyper_ops
    from ihgnn_torch.ops.permute import transposed_local_permute
    from ihgnn_torch.ops.segscan import csr_segment_scan
    from ihgnn_torch.ops.segsum import csr_segment_sum3

    model = RawGnn(cfg, U, Q, I, VOCAB,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    graph = graph_cpu.to(dev)
    kp = graph.kp
    bag = make_word_bag(qw, qc, VOCAB + 1).to(dev)
    gather, _ = make_hyper_ops(graph, bf16_stream=cfg.bf16_stream,
                               absorb=True)
    layer = model.gnns[0]
    torch.cuda.synchronize()
    _zero_launches()
    with torch.no_grad():
        x = layer.feature_transform(model.embeddings.all_features(bag))
        o1, o2 = layer.interactor(gather(x), absorb=kp)
        rq = transposed_local_permute(o1.view(kp.rows, kp.cols, -1),
                                      kp.q.p1_inv, pre=True)
        ri = transposed_local_permute(o2.view(kp.rows, kp.cols, -1),
                                      kp.i.p1_inv, pre=True)
        stream = torch.cat([o1, rq.view(kp.e_pad, -1), ri.view(kp.e_pad, -1)])
        scan = csr_segment_scan(stream, kp.scan)
        torch.cuda.synchronize()
        launches = _read_launches(path, [k for k, v in expected.items()
                                         if v > 0])
        _check_counts(path, launches, expected, 1)
        k1 = csr_segment_sum3(*stream.view(3, kp.e_pad, -1), kp.seg_col,
                              kp.seg_rowptr)
    equal = torch.equal(scan, k1)
    emit({"phase": path, "stream_rows": stream.shape[0],
          "stream_dtype": str(stream.dtype).replace("torch.", ""),
          "nodes": kp.node_count, "equal_to_k1": equal,
          "max_abs_diff": (scan - k1).abs().max().item(),
          "finite": bool(torch.isfinite(scan).all().item()),
          "launches": launches})
    if not equal:
        fail(f"{path}: K8 and K1 disagree on the node-update stream")
    return launches


def check_small_routed(torch, dev):
    """Phase ``small_routed_reference``: the routed path on a small packed
    graph (E = 300 on a 16384-slot grid, so most σ positions are pads),
    card against CPU as in phase 9, for the default model, HGCN and IHGNN
    with phase 2; returns the card's launches (two card runs a case)."""
    from ihgnn_torch.config import ModelConfig, V

    s = SMALL
    graph, uqi = random_graph(s["users"], s["queries"], s["items"],
                              s["edges"], 40, pack_kernels=True)
    qw, qc = random_words(s["queries"], s["vocab"], 41)
    cases = {"ihgnn": ModelConfig(), "hgcn": ModelConfig(gnn=V.HGCN),
             "phase2": ModelConfig(phase2_attention=True)}
    failed = []
    _zero_launches()
    for j, (case, cfg) in enumerate(cases.items()):
        row, ok = train_card_vs_cpu(torch, dev, cfg, graph, uqi, qw, qc,
                                    50 + 10 * j)
        emit({"phase": "small_routed_reference", "case": case, **row})
        if not ok:
            failed.append(case)
    if failed:
        fail(f"card and CPU disagree on the small routed cases {failed}")
    # HGCN and phase 2 run the chains without the absorbed interaction:
    # the i role's stage 2 and phase 2's relabelling to edge order
    return _read_launches("small_routed_reference",
                          ROUTED_TRAIN + ("row_local_permute", "interact_fwd",
                                          "interact_bwd"))


def check_small_routed_bf16(torch, dev):
    """Phase ``small_routed_bf16_reference``: the routed path on bf16
    streams on a small packed graph, card against CPU, for the default
    model (``GatherPreFn`` → K5 → ``Scatter2Fn``) and IHGNN with phase 2
    (``RoutedGatherFn`` → K3 → ``SigmaToEdgeFn``), held to BF16_SMALL_TOL;
    returns the card's launches (two card runs a case)."""
    from ihgnn_torch.config import ModelConfig

    s = SMALL
    graph, uqi = random_graph(s["users"], s["queries"], s["items"],
                              s["edges"], 70, pack_kernels=True)
    qw, qc = random_words(s["queries"], s["vocab"], 71)
    cases = {"ihgnn": ModelConfig(bf16_stream=True),
             "phase2": ModelConfig(bf16_stream=True, phase2_attention=True)}
    failed = []
    _zero_launches()
    for j, (case, cfg) in enumerate(cases.items()):
        row, ok = train_card_vs_cpu(torch, dev, cfg, graph, uqi, qw, qc,
                                    72 + 10 * j, tol=BF16_SMALL_TOL)
        emit({"phase": "small_routed_bf16_reference", "case": case, **row})
        if not ok:
            failed.append(case)
    if failed:
        fail(f"card and CPU disagree on the small routed bf16 cases {failed}")
    return _read_launches("small_routed_bf16_reference",
                          ROUTED_TRAIN_BF16 + ("row_local_permute_bf16",
                                               "interact_fwd_bf16",
                                               "interact_bwd_bf16"))


# ---------------------------------------------------------------------------
# the chunked hypergraph pack at the JAX package's stress shape, and the
# routed 2D graph
# ---------------------------------------------------------------------------

# STRESS_r05.json's configuration: U/Q/I/V and E (d = 32, two IHGNN layers
# of orders 3 and 1, bf16 streams), whose routed pack has 5 chunks
STRESS_SIZES = (1_000_000, 500_000, 2_000_000, 200_000)
STRESS_E, STRESS_CHUNKS = 10_000_000, 5
# the small chunked graph: SMALL's graph in chunks of 2 rows of 128 (2
# chunks, 256 and 44 edges, each on a 128 x 128 grid, so both pad); and,
# held beside it, 3000 edges of SMALL's nodes in chunks of 16 rows (2048
# and 952 edges)
SMALL_CHUNK_CAP = 2
SCALE_EDGES, SCALE_CHUNK_CAP = 3_000, 16
# fault_3_1: the interaction's step-0 dW on SMALL's nodes at these edge
# counts (chunked at SCALE_CHUNK_CAP, and direct), card and CPU twin each
# against float64 on the same inputs, held at SMALL_GRAD_RTOL of the
# float64 dW's largest value
FAULT31_EDGES = (300, 3_000, 17_000)
# a chunked pack runs its expands and permutes once a chunk, and K1's node
# sum (csr_segment_sum3_multi's counterpart) and K5 once over all chunks
_PER_CHUNK = ("gather_rows", "gather_rows_t", "transposed_local_permute")
# the paths on chunked packs: their K1 three-region launches are
# csr_segment_sum3_multi's in the kernels line, the others csr_segment_sum3's
CHUNKED_PATHS = ("chunked_serving", "chunked_bf16_train",
                 "small_chunked_reference", "sharded_chunked_train",
                 "sharded_small_reference_chunked")
# the routed GAT: a layer runs, a pack, the source expand (K2 transposed,
# K7, K6), three scalar expands by destination (K2's d = 1 form), K4, the
# denominators' scalar sum and K1's weighted sum; its backward, a pack,
# the cotangent's expand by destination (K2), the tt and gd scalar sums,
# the tsum expand (d = 1) and the source sums (two K7 and K1). The bag's K1
# once each way; csr_edge_dot never
ROUTED_GAT_SERVING = ("csr_gather_sum", "gather_rows_t",
                      "transposed_local_permute", "row_local_permute",
                      "gather_scalars", "csr_segment_max", "csr_segment_sum")
ROUTED_GAT_TRAIN = ROUTED_GAT_SERVING + ("gather_rows",)
# the routed GCN: a layer runs the role forward (K2 transposed, K7, K6) and
# K1's weighted sum, its backward the same
ROUTED_GCN = ("csr_gather_sum", "gather_rows_t", "transposed_local_permute",
              "row_local_permute")
ROUTED_GCN_STEPS = 2
# the chunked path against the direct one at the stress shape: f32
# features (absolute, as ROUTED_FEATURE_ATOL) and metrics equal; bf16
# features within BF16_FEATURE_RTOL of the direct bf16 features' largest
# value, step-0 losses within ROUTED_BF16_LOSS_RTOL. The routed 2D graph
# against the direct one: features within 1e-4, losses within 1e-4
# relative
ROUTED_2D_ATOL, ROUTED_2D_LOSS_RTOL = 1e-4, 1e-4


def per_chunk(counts, chunks):
    """A routed path's launch counts on a pack of ``chunks`` chunks."""
    return {k: v * chunks if k.removesuffix("_bf16") in _PER_CHUNK else v
            for k, v in counts.items()}


def routed_gat_launches(packs, step, layers=2):
    """The routed GAT's launches of one forward (``step`` False) or one
    train step of ``layers`` concat-head layers over ``packs`` packs."""
    per = dict(gather_rows_t=1, transposed_local_permute=1,
               row_local_permute=1, gather_scalars=3, csr_segment_max=1,
               csr_segment_sum=1, csr_gather_sum=1, gather_rows=0,
               csr_edge_dot=0)
    if step:
        for k, v in dict(gather_rows=1, csr_segment_sum=2, gather_scalars=1,
                         transposed_local_permute=2,
                         csr_gather_sum=1).items():
            per[k] += v
    out = {k: v * packs * layers for k, v in per.items()}
    out["csr_gather_sum"] += 2 if step else 1
    return out


def routed_gcn_launches(steps, layers=2):
    """The routed GCN's launches of one forward and ``steps`` train
    steps."""
    spmm = (1 + 2 * steps) * layers
    return dict(gather_rows_t=spmm, transposed_local_permute=spmm,
                row_local_permute=spmm,
                csr_gather_sum=spmm + 1 + 2 * steps, csr_edge_dot=0)


def features_of(torch, dev, cfg, graph_cpu, qw, qc, sizes):
    """The full-graph features (on the CPU) of ``RawGnn(cfg)`` at ``sizes``
    with the seeded weights of ``run_serving``."""
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.train.eval import make_eval_fns
    model = RawGnn(cfg, *sizes,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    model.eval()
    features_fn, _ = make_eval_fns(model, graph_cpu, qw, qc, device=dev)
    return features_fn().cpu()


def check_multi_kernels(torch, dev, kp, results):
    """Phase 3 at the stress shape: K1's three-region form over the CSR
    spanning the 5 chunks of the stress graph's pack
    (``csr_segment_sum3_multi``'s shape, ``segsum.py:686``: the chunks' u,
    q and i regions of ``e_pad`` rows, 3E entries), f32 and bf16 regions,
    against the twin, timed beside its bound and ``torch.sparse.mm`` over
    the concatenated regions."""
    from ihgnn_torch.ops.segsum import csr_segment_sum3, csr_segment_sum3_plain

    gen = torch.Generator(device=dev).manual_seed(3)
    m, n, e = kp.e_pad, kp.node_count, kp.edge_count
    col, rowptr = kp.seg_col, kp.seg_rowptr
    shape = (f"{len(kp.packs)} chunks, 3 x [{m}, {D}] regions, "
             f"{col.numel()} entries -> [{n}, {D}]")
    for dtype, name in ((torch.float32, "csr_segment_sum3_multi"),
                        (torch.bfloat16, "csr_segment_sum3_multi_bf16")):
        u, q, i = (torch.randn(m, D, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        k_out = csr_segment_sum3(u, q, i, col, rowptr)
        p_out = csr_segment_sum3_plain(u, q, i, col, rowptr)
        stream = torch.cat([u, q, i])
        csr = torch.sparse_csr_tensor(rowptr, col, torch.ones(
            col.numel(), device=dev, dtype=dtype), size=(n, 3 * m))
        lib_err = (torch.sparse.mm(csr, stream).float()
                   - p_out).abs().max().item()
        size = stream.element_size()
        record_row(torch, results, name, shape,
                   (k_out - p_out).abs().max().item(), 1e-4,
                   lambda: csr_segment_sum3(u, q, i, col, rowptr),
                   lambda: csr_segment_sum3_plain(u, q, i, col, rowptr),
                   lambda: torch.sparse.mm(csr, stream),
                   3 * e * D * size + 4 * (3 * e + n + 1 + n * D),
                   3 * e * D, lib_err,
                   replaces="ihgnn_tpu/ops/pallas/segsum.py:686",
                   chunks=len(kp.packs))
        del u, q, i, k_out, p_out, stream, csr


def check_routed_2d_kernels(torch, dev, graph2d, results):
    """Phase 3 at the routed 2D graph's shapes: K2's d = 1 form on the
    first GAT pack's destination table (the scalar expands), against its
    twin and ``index_select``; K2 on the routed GCN's expand (the
    ``pk_role`` grid) and on the GAT's cotangent expand by destination."""
    from ihgnn_torch.ops.gather import (gather_rows, gather_rows_plain,
                                        gather_rows_t, gather_scalars,
                                        gather_scalars_plain)

    gen = torch.Generator(device=dev).manual_seed(4)
    n = graph2d.node_count
    pk = graph2d.gat_pk.packs[0]
    x = torch.randn(n, device=dev, generator=gen)
    idx = pk.dst_idx
    flat = idx.view(-1)
    k_out = gather_scalars(x, idx)
    lib_err = (x.index_select(0, flat).view(idx.shape)
               - k_out).abs().max().item()
    # device time in kernels alone (the profiler's spans), beside the
    # events' time, which holds the wrapper's host issue
    record_row(torch, results, "gather_scalars",
               f"GAT scalar expand [{n}] -> {list(idx.shape)}",
               (k_out - gather_scalars_plain(x, idx)).abs().max().item(), 0.0,
               lambda: gather_scalars(x, idx),
               lambda: gather_scalars_plain(x, idx),
               lambda: x.index_select(0, flat), 4 * (2 * flat.numel() + n),
               0, lib_err,
               device=kernel_device_ms(torch, lambda: gather_scalars(x, idx)),
               library_device=kernel_device_ms(
                   torch, lambda: x.index_select(0, flat)))
    # a call over one pack's 2M entries issues faster on the card than the
    # host issues the wrapper: the same expand over every pack's table at
    # once (a layer's work, 12M entries) times the kernel itself
    every = torch.cat([p.dst_idx.view(-1) for p in graph2d.gat_pk.packs])
    k_out = gather_scalars(x, every)
    record_row(torch, results, "gather_scalars",
               f"every GAT pack's scalar expand [{n}] -> [{every.numel()}]",
               (k_out - gather_scalars_plain(x, every)).abs().max().item(),
               0.0, lambda: gather_scalars(x, every),
               lambda: gather_scalars_plain(x, every),
               lambda: x.index_select(0, every),
               4 * (2 * every.numel() + n), 0,
               (x.index_select(0, every) - k_out).abs().max().item())
    rows = torch.randn(n, D, device=dev, generator=gen)
    rp = graph2d.pk_role
    for kname, fn, table, transposed, label in (
            ("gather_rows_t", gather_rows_t, rp.idx, True,
             f"GCN x[col] expand -> [{rp.cols}, {rp.rows}, {D}]"),
            ("gather_rows", gather_rows, idx, False,
             f"GAT cotangent expand -> [{pk.rows}, {pk.cols}, {D}]")):
        cells = table.numel()
        ids = (table.t() if transposed else table).reshape(-1).long()
        k_rows = fn(rows, table)
        record_row(torch, results, kname, label,
                   (k_rows - gather_rows_plain(rows, table, transposed))
                   .abs().max().item(), 0.0,
                   lambda: fn(rows, table),
                   lambda: gather_rows_plain(rows, table, transposed),
                   lambda: rows.index_select(0, ids),
                   4 * (n * D + cells + cells * D), 0,
                   (rows.index_select(0, ids).view(k_rows.shape)
                    - k_rows).abs().max().item(),
                   device=kernel_device_ms(torch, lambda: fn(rows, table)),
                   library_device=kernel_device_ms(
                       torch, lambda: rows.index_select(0, ids)))
    del x, rows


def run_chunked(torch, dev, results):
    """The chunked pack at the JAX package's stress shape (STRESS_SIZES,
    STRESS_E edges, 5 chunks of the 2048 x 1024 grid): phases
    ``chunked_data`` (the pack's host build), the kernel rows of
    ``check_multi_kernels``, ``stress_serving`` and ``chunked_serving``
    (the default model in f32 on the direct path and on the chunked pack,
    features within ROUTED_FEATURE_ATOL and metrics equal:
    ``chunked_vs_direct``), then the stress configuration's own precision:
    the bf16 features of both paths, ``stress_bf16_train`` and
    ``chunked_bf16_train`` (2 warm and 10 timed steps of 1024 x 10, a
    profiled chunked step) and ``chunked_bf16_vs_direct_bf16`` (features
    within BF16_FEATURE_RTOL of the largest, step-0 losses within
    ROUTED_BF16_LOSS_RTOL). Returns the launches by path."""
    from ihgnn_torch.config import ModelConfig
    from ihgnn_torch.ops.packing import (ChunkedHyperPack,
                                         build_hyper_kernel_pack)

    su, sq, si, sv = STRESS_SIZES
    t0 = time.perf_counter()
    direct_cpu, uqi = random_graph(su, sq, si, STRESS_E, seed=100)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kp = build_hyper_kernel_pack(direct_cpu.i3.numpy(),
                                 direct_cpu.node_count)
    pack_s = time.perf_counter() - t0
    qw, qc = random_words(sq, sv, seed=101)
    if not isinstance(kp, ChunkedHyperPack) or len(kp.packs) != \
            STRESS_CHUNKS or not kp.absorbs:
        fail(f"the stress graph packed as {type(kp).__name__}, not "
             f"{STRESS_CHUNKS} chunks of one grid width")
    chunks = len(kp.packs)
    emit({"phase": "chunked_data", "edges": STRESS_E,
          "nodes": direct_cpu.node_count, "unpacked_build_s": build_s,
          "pack_s": pack_s, "chunks": chunks,
          "grids": [[pk.rows, pk.cols] for pk in kp.packs],
          "chunk_edges": [pk.edge_count for pk in kp.packs],
          "e_pad": kp.e_pad, "sigma_pads": kp.e_pad - kp.edge_count,
          "node_update_entries": int(kp.seg_col.numel())})
    chunked_cpu = dataclasses.replace(direct_cpu, kp=kp)
    with torch.no_grad():
        check_multi_kernels(torch, dev, kp.to(dev), results)
    torch.cuda.synchronize()

    ihgnn = ModelConfig()
    ihgnn16 = dataclasses.replace(ihgnn, bf16_stream=True)
    launches = {}
    launches["stress_serving"], serving, direct_metrics = run_serving(
        torch, dev, ihgnn, direct_cpu, qw, qc, "stress_serving",
        IHGNN_SERVING, IHGNN_FORWARD_LAUNCHES, sizes=STRESS_SIZES)
    direct_features = serving[2].cpu()
    del serving
    launches["chunked_serving"], serving, chunked_metrics = run_serving(
        torch, dev, ihgnn, chunked_cpu, qw, qc, "chunked_serving",
        ROUTED_SERVING, per_chunk(ROUTED_FORWARD_LAUNCHES, chunks),
        sizes=STRESS_SIZES)
    feature_err = (serving[2].cpu() - direct_features).abs().max().item()
    del serving, direct_features
    emit({"phase": "chunked_vs_direct", "features_max_abs_err": feature_err,
          "features_atol": ROUTED_FEATURE_ATOL,
          "metrics_chunked": chunked_metrics,
          "metrics_direct": direct_metrics})
    if not feature_err <= ROUTED_FEATURE_ATOL:
        fail(f"chunked features differ from the direct path's by "
             f"{feature_err}")
    if chunked_metrics != direct_metrics:
        fail(f"chunked metrics {chunked_metrics} != direct {direct_metrics}")

    direct16 = features_of(torch, dev, ihgnn16, direct_cpu, qw, qc,
                           STRESS_SIZES)
    chunked16 = features_of(torch, dev, ihgnn16, chunked_cpu, qw, qc,
                            STRESS_SIZES)
    launches["stress_bf16_train"], _, direct16_losses = run_train(
        torch, dev, ihgnn16, direct_cpu, uqi, qw, qc, "stress_bf16_train",
        IHGNN_TRAIN_BF16, IHGNN_STEP_LAUNCHES_BF16, sizes=STRESS_SIZES)
    launches["chunked_bf16_train"], warm_step, chunked16_losses = run_train(
        torch, dev, ihgnn16, chunked_cpu, uqi, qw, qc, "chunked_bf16_train",
        ROUTED_TRAIN_BF16, per_chunk(ROUTED_STEP_LAUNCHES_BF16, chunks),
        sizes=STRESS_SIZES)
    emit(profile_window(torch, "one warm chunked bf16 train step",
                        warm_step))
    del warm_step
    scale = direct16.abs().max().item()
    feature_err = (chunked16 - direct16).abs().max().item()
    loss_err = (abs(chunked16_losses[0] - direct16_losses[0])
                / abs(direct16_losses[0]))
    emit({"phase": "chunked_bf16_vs_direct_bf16",
          "features_max_abs_err": feature_err, "features_scale": scale,
          "features_rtol": BF16_FEATURE_RTOL,
          "step0_loss_chunked_bf16": chunked16_losses[0],
          "step0_loss_direct_bf16": direct16_losses[0],
          "step0_loss_rel_err": loss_err,
          "loss_rtol": ROUTED_BF16_LOSS_RTOL})
    if not feature_err <= BF16_FEATURE_RTOL * scale:
        fail(f"chunked bf16 features differ from the direct bf16 features "
             f"by {feature_err} (scale {scale})")
    if not loss_err <= ROUTED_BF16_LOSS_RTOL:
        fail(f"chunked bf16 step-0 loss differs from the direct bf16 one "
             f"by {loss_err}")
    return launches


def run_routed_gcn(torch, dev, graph2d_cpu, uqi, qw, qc):
    """Phase ``routed_gcn``: ``RawGnn`` with two GCN layers at full width on
    the packed 2D graph (``RoutedSpmmFn``) and on the same graph without
    its packs (``SpmmFn``), from the same seeded weights: one forward and
    ROUTED_GCN_STEPS train steps each; features within ROUTED_2D_ATOL and
    every loss within ROUTED_2D_LOSS_RTOL; the routed launches exact.
    Returns the routed launches."""
    from ihgnn_torch.config import ModelConfig, TrainConfig, V
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.ops.hyperagg import strip_kernel_packing
    from ihgnn_torch.train.eval import make_eval_fns
    from ihgnn_torch.train.train import make_optimizer, make_train_step

    cfg = ModelConfig(gnn=V.GCN)
    batches = [train_batch(uqi, I, TRAIN_B, TRAIN_K, seed) for seed in
               range(ROUTED_GCN_STEPS)]
    out = {}
    for path, graph in (("direct", strip_kernel_packing(graph2d_cpu)),
                        ("routed", graph2d_cpu)):
        model = RawGnn(cfg, U, Q, I, VOCAB,
                       generator=torch.Generator().manual_seed(0)).to(dev)
        features_fn, _ = make_eval_fns(model, graph, qw, qc, device=dev)
        opt = make_optimizer(model.parameters(), TrainConfig(
            batch_size=TRAIN_B, random_negative_sample_size=TRAIN_K))
        step = make_train_step(model, graph, qw, qc, opt, device=dev)
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        features = features_fn().cpu()
        losses = [step(b).item() for b in batches]
        seconds = time.perf_counter() - t0
        out[path] = (features, losses, _launch_counts(), seconds)
        del model, features_fn, step, opt
    launches = out["routed"][2]
    _check_counts("routed_gcn", launches,
                  routed_gcn_launches(ROUTED_GCN_STEPS), 1)
    feature_err = (out["routed"][0] - out["direct"][0]).abs().max().item()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(out["routed"][1],
                                                      out["direct"][1]))
    emit({"phase": "routed_gcn", "entries": graph2d_cpu.nnz,
          "grid": [graph2d_cpu.pk_role.rows, graph2d_cpu.pk_role.cols],
          "steps": ROUTED_GCN_STEPS,
          "features_max_abs_err": feature_err,
          "features_atol": ROUTED_2D_ATOL,
          "losses_routed": out["routed"][1],
          "losses_direct": out["direct"][1],
          "loss_max_rel_err": loss_err, "loss_rtol": ROUTED_2D_LOSS_RTOL,
          "seconds_routed": out["routed"][3],
          "seconds_direct": out["direct"][3], "launches": launches})
    if not feature_err <= ROUTED_2D_ATOL:
        fail(f"routed GCN features differ from the direct ones by "
             f"{feature_err}")
    if not loss_err <= ROUTED_2D_LOSS_RTOL:
        fail(f"routed GCN losses differ from the direct ones by {loss_err}")
    return launches


def check_small_chunked(torch, dev):
    """Phase ``small_chunked_reference``: the chunked pack on SMALL's graph
    (``build_hypergraph(..., pack_kernels=True,
    chunk_rows_cap=SMALL_CHUNK_CAP)``: 2 chunks, both padded), card
    against CPU as in phase 9, for the default model (absorbed), HGCN,
    IHGNN with phase 2 (limits of phase 9) and the default model on bf16
    streams (BF16_SMALL_TOL). Then ``small_chunked_scale``, held at the
    same limits: the default model on SCALE_EDGES edges of SMALL's nodes,
    chunked at SCALE_CHUNK_CAP and on the direct path, card against CPU.
    Returns the card's launches of the first cases."""
    from ihgnn_torch.config import ModelConfig, V
    from ihgnn_torch.graph import build_hypergraph
    from ihgnn_torch.ops.hyperagg import strip_kernel_packing

    s = SMALL
    nodes = s["users"] + s["queries"] + s["items"]
    _, uqi = random_graph(s["users"], s["queries"], s["items"], s["edges"],
                          90)
    graph = build_hypergraph(uqi, nodes, s["users"], s["queries"],
                             pack_kernels=True,
                             chunk_rows_cap=SMALL_CHUNK_CAP)
    if len(graph.kp.packs) < 2 or not graph.kp.absorbs:
        fail("the small chunked graph did not pack in chunks of one width")
    qw, qc = random_words(s["queries"], s["vocab"], 91)
    cases = {"ihgnn": (ModelConfig(), None),
             "hgcn": (ModelConfig(gnn=V.HGCN), None),
             "phase2": (ModelConfig(phase2_attention=True), None),
             "ihgnn_bf16": (ModelConfig(bf16_stream=True), BF16_SMALL_TOL)}
    failed = []
    _zero_launches()
    for j, (case, (cfg, tol)) in enumerate(cases.items()):
        row, ok = train_card_vs_cpu(torch, dev, cfg, graph, uqi, qw, qc,
                                    92 + 10 * j, tol=tol)
        emit({"phase": "small_chunked_reference", "case": case,
              "chunks": len(graph.kp.packs), **row})
        if not ok:
            failed.append(case)
    if failed:
        fail(f"card and CPU disagree on the small chunked cases {failed}")
    launches = _read_launches("small_chunked_reference",
                              ROUTED_TRAIN + ROUTED_TRAIN_BF16
                              + ("row_local_permute",))

    _, uqi = random_graph(s["users"], s["queries"], s["items"], SCALE_EDGES,
                          93)
    scaled = build_hypergraph(uqi, nodes, s["users"], s["queries"],
                              pack_kernels=True,
                              chunk_rows_cap=SCALE_CHUNK_CAP)
    grads, failed = {}, []
    for path, g in (("chunked", scaled), ("direct",
                                          strip_kernel_packing(scaled))):
        row, ok = train_card_vs_cpu(torch, dev, ModelConfig(), g, uqi, qw,
                                    qc, 94)
        grads[path] = row["grad0_rel_err"]
        if not ok:
            failed.append((path, row))
    emit({"phase": "small_chunked_scale", "edges": SCALE_EDGES,
          "chunks": len(scaled.kp.packs), "held": True,
          "grad0_rel_err_max": {k: max(v.values()) for k, v in
                                grads.items()},
          "grad0_rel_err": grads})
    if failed:
        fail(f"card and CPU disagree on {SCALE_EDGES} edges: {failed}")
    return launches


def _interaction_inputs(torch, cfg, graph, uqi, qw, qc, seed):
    """The arguments of every ``interact_bwd`` and ``interact_bwd_absorb``
    call of one CPU train step of ``RawGnn(cfg)`` (weights from ``seed``)
    on ``graph``, with the f32 twin's dW of each: ``[(absorb, args,
    dw)]``."""
    return [("absorb" in kernel, args, out) for kernel, args, out in
            _interaction_calls(torch, cfg, graph, uqi, qw, qc, seed)
            if "bwd" in kernel]


def _interaction_calls(torch, cfg, graph, uqi, qw, qc, seed):
    """The arguments of every call of the interaction's kernels (K3's
    ``interact_fwd`` and ``interact_bwd``, K5's ``interact_fwd_absorb``
    and ``interact_bwd_absorb``) in one CPU train step of ``RawGnn(cfg)``
    (weights from ``seed``) on ``graph``, with the twin's result of each
    (a forward's output, a backward's dW): ``[(kernel, args, out)]``."""
    from ihgnn_torch.config import TrainConfig
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.ops import interact as ops_interact
    from ihgnn_torch.train.train import make_optimizer, make_train_step

    s = SMALL
    calls = []
    names = ("interact_fwd", "interact_bwd", "interact_fwd_absorb",
             "interact_bwd_absorb")
    saved = {n: getattr(ops_interact, n) for n in names}

    def recorder(fn, name):
        def record(*args):
            out = fn(*args)
            # copies: the step's Adam update changes W and b in place
            calls.append((name, [a.detach().clone() if torch.is_tensor(a)
                                 else a for a in args],
                          _checked_result(name, out)))
            return out
        return record

    for n in names:
        setattr(ops_interact, n, recorder(saved[n], n))
    try:
        model = RawGnn(cfg, s["users"], s["queries"], s["items"], s["vocab"],
                       generator=torch.Generator().manual_seed(seed))
        step = make_train_step(model, graph, qw, qc,
                               make_optimizer(model.parameters(),
                                              TrainConfig()), device="cpu")
        step(train_batch(uqi, s["items"], SMALL_B, TRAIN_K, seed + 1))
    finally:
        for n in names:
            setattr(ops_interact, n, saved[n])
    return calls


def _checked_result(kernel, out):
    """What ``fault_3_1`` compares of an interaction kernel's result: a
    backward's dW, K5's o1 (o2 is its permuted copy), K3's output."""
    if "bwd" in kernel:
        return out[1]
    return out[0] if "absorb" in kernel else out


def _bf16_dw_f64(torch, u, q, i, cot, order):
    """float64 dW of the bf16 contract on bf16 ``u``, ``q``, ``i``,
    ``cot``: its parts (each product rounded to bf16, exact in f32)
    widened, times the widened cotangent, summed in float64."""
    from ihgnn_torch.ops.interact import interact_parts_bf16
    cot = cot.double()
    return torch.cat([p.double().t() @ cot
                      for p in interact_parts_bf16(u, q, i, order)])


def check_fault_3_1(torch, dev):
    """Phase ``fault_3_1``: the interaction's kernels against float64 at
    each of FAULT31_EDGES on SMALL's nodes, from the inputs of a CPU train
    step, direct and on the chunked pack: the step-0 dW of the f32
    backward (K3's ``interact_bwd``, K5's ``interact_bwd_absorb``), the f32
    forward's output (K3's ``interact_fwd`` and K5's
    ``interact_fwd_absorb``, orders 3 and 1), and on bf16 streams
    (direct) the dW of ``interact_bwd``'s bf16 form against the float64
    sum of its bf16 contract's parts. The card's kernel and the CPU's twin
    each against float64 on the same inputs, of the float64 result's
    largest value. With ``--reference`` the reference build's f32
    backward is measured on the same inputs (reported). Held: the card's
    f32 rows at SMALL_GRAD_RTOL, its bf16 dW at BF16_SMALL_TOL's
    ``grad_rtol``; the twin is reported."""
    from ihgnn_torch.config import ModelConfig
    from ihgnn_torch.graph import build_hypergraph
    from ihgnn_torch.ops import interact as ops_interact
    from ihgnn_torch.ops.hyperagg import strip_kernel_packing

    s = SMALL
    nodes = s["users"] + s["queries"] + s["items"]
    qw, qc = random_words(s["queries"], s["vocab"], 91)
    ref_lib = REFERENCE.get("interact_bwd")
    bf16_rtol = BF16_SMALL_TOL["grad_rtol"]
    rows = []
    torch.set_grad_enabled(False)
    for edges in FAULT31_EDGES:
        _, uqi = random_graph(s["users"], s["queries"], s["items"], edges, 93)
        graph = build_hypergraph(uqi, nodes, s["users"], s["queries"],
                                 pack_kernels=True,
                                 chunk_rows_cap=SCALE_CHUNK_CAP)
        direct = strip_kernel_packing(graph)
        for path, g, cfg in (
                ("chunked", graph, ModelConfig()),
                ("direct", direct, ModelConfig()),
                ("direct", direct, ModelConfig(bf16_stream=True))):
            with torch.enable_grad():
                calls = _interaction_calls(torch, cfg, g, uqi, qw, qc, 94)
            for kernel, args, twin in calls:
                bf16 = args[0].dtype == torch.bfloat16
                if bf16 and "fwd" in kernel:
                    continue      # the bf16 forward rounds its output
                order = args[-1]
                on_card = [a.to(dev) if torch.is_tensor(a) else a
                           for a in args]
                got = _checked_result(
                    kernel, getattr(ops_interact, kernel)(*on_card))
                if bf16:
                    u, q, i, _, cot = args[:5]
                    want = _bf16_dw_f64(torch, u, q, i, cot, order)
                else:
                    f64 = [a.double() if torch.is_tensor(a) and
                           a.is_floating_point() else a for a in args]
                    want = _checked_result(kernel, getattr(
                        ops_interact, kernel + "_plain")(*f64))
                scale = want.abs().max().item()
                card_err = (got.cpu().double() - want).abs().max().item()
                twin_err = (twin.double() - want).abs().max().item()
                row = {"edges": edges, "path": path, "order": order,
                       "kernel": kernel + ("_bf16" if bf16 else ""),
                       "result": "dW" if "bwd" in kernel else "out",
                       "stream_edges": int(args[0].shape[0]),
                       "card_rel_err": card_err / scale,
                       "twin_rel_err": twin_err / scale,
                       "rtol": bf16_rtol if bf16 else SMALL_GRAD_RTOL}
                if ref_lib is not None and "bwd" in kernel and not bf16:
                    from ihgnn_torch.compare_builds import run_bwd
                    u, q, i, *rest = on_card
                    if kernel == "interact_bwd_absorb":
                        pi, w, c1, c2, mask = rest[:5]
                        ref = run_bwd(ref_lib, True, u, q, i, pi, w, c1, c2,
                                      mask if mask is not None else
                                      torch.ones(u.shape[0], device=dev),
                                      order)
                    else:
                        w, cot = rest[:2]
                        ref = run_bwd(ref_lib, False, u, q, i, None, w, cot,
                                      None, None, order)
                    ref_dw = ref[1][:w.shape[0]].cpu().double()
                    row["reference_rel_err"] = ((ref_dw - want).abs().max()
                                                .item() / scale)
                rows.append(row)
    torch.set_grad_enabled(True)
    worst = {}
    for r in rows:
        worst[r["kernel"]] = max(worst.get(r["kernel"], 0.0),
                                 r["card_rel_err"])
    missed = sorted({r["kernel"] for r in rows
                     if not r["card_rel_err"] <= r["rtol"]})
    emit({"phase": "fault_3_1", "rtol": SMALL_GRAD_RTOL,
          "bf16_rtol": bf16_rtol, "held": True,
          "card_rel_err_max": worst,
          "twin_rel_err_max": max(r["twin_rel_err"] for r in rows
                                  if "bf16" not in r["kernel"]),
          "cases": rows})
    if missed:
        fail(f"fault_3_1: the card's {missed} miss float64 beyond their "
             f"limits ({worst})")


def check_small_routed_2d(torch, dev):
    """Phase ``small_routed_2d_reference``: the routed 2D graph on a small
    graph (``build_graph2d(..., pack_kernels=True)``, a tenth of the flags
    0), card against CPU as in phase 9: GCN (``RoutedSpmmFn``), GAT with
    both heads on the graph's one pack, and GAT on a ``ChunkedGatPack`` of
    the same entries (``build_gat_pack`` at ``cols=128,
    chunk_rows_cap=4``, split by source region); returns the card's
    launches."""
    from ihgnn_torch.config import ModelConfig, V
    from ihgnn_torch.graph import build_graph2d
    from ihgnn_torch.ops.gatpack import ChunkedGatPack, build_gat_pack

    s = SMALL
    _, uqi = random_graph(s["users"], s["queries"], s["items"], s["edges"],
                          100)
    flags = (np.random.default_rng(101).random(len(uqi)) > 0.1).astype(
        np.int64)
    graph = build_graph2d(np.column_stack([uqi, flags]),
                          s["users"] + s["queries"] + s["items"], s["users"],
                          s["queries"], pack_kernels=True)
    att = graph.attention
    chunked = dataclasses.replace(graph, gat_pk=build_gat_pack(
        att.src.numpy(), att.dst.numpy(), graph.node_count,
        live=graph.val[graph.dst_order.long()].numpy(), cols=128,
        chunk_rows_cap=4, src_cuts=(s["users"], s["users"] + s["queries"])))
    if graph.pk_role is None or graph.gat_pk is None or not isinstance(
            chunked.gat_pk, ChunkedGatPack):
        fail("the small 2D graph did not pack")
    qw, qc = random_words(s["queries"], s["vocab"], 102)
    cases = {"gcn": (ModelConfig(gnn=V.GCN), graph),
             "gat": (ModelConfig(gnn=V.GAT), graph),
             "gat_product": (ModelConfig(gnn=V.GAT, gat_head=V.PRODUCT),
                             graph),
             "gat_chunked": (ModelConfig(gnn=V.GAT), chunked)}
    failed = []
    _zero_launches()
    for j, (case, (cfg, g)) in enumerate(cases.items()):
        row, ok = train_card_vs_cpu(torch, dev, cfg, g, uqi, qw, qc,
                                    103 + 10 * j)
        emit({"phase": "small_routed_2d_reference", "case": case,
              "gat_packs": len(g.gat_pk.packs), **row})
        if not ok:
            failed.append(case)
    if failed:
        fail(f"card and CPU disagree on the small routed 2D cases {failed}")
    return _read_launches("small_routed_2d_reference",
                          ROUTED_GAT_TRAIN)


KERNELS = {
    "csr_gather_sum": ("ihgnn_torch/csrc/segsum.cu",
                       "ihgnn_tpu/ops/pallas/segsum.py:403"),
    "gather_roles": ("ihgnn_torch/csrc/gather.cu",
                     "ihgnn_tpu/ops/pallas/gather.py:188"),
    "interact_fwd": ("ihgnn_torch/csrc/interact.cu",
                     "ihgnn_tpu/ops/pallas/interact.py:319"),
    "interact_bwd": ("ihgnn_torch/csrc/interact_bwd.cu",
                     "ihgnn_tpu/ops/pallas/interact.py:340"),
    "csr_segment_max": ("ihgnn_torch/csrc/segmax.cu",
                        "ihgnn_tpu/ops/pallas/segsum.py:848"),
    # K1's csr_segment_sum_t on a scalar stream
    "csr_segment_sum": ("ihgnn_torch/csrc/segmax.cu",
                        "ihgnn_tpu/ops/pallas/segsum.py:458"),
    # no TPU kernel of its own: it folds the K2 windowed_gather expansions
    # and the XLA multiply-reduce of the attention's per-entry dots
    "csr_edge_dot": ("ihgnn_torch/csrc/edgedot.cu",
                     "ihgnn_tpu/ops/gatconv.py:256"),
    # the routed path
    "gather_rows": ("ihgnn_torch/csrc/gather.cu",
                    "ihgnn_tpu/ops/pallas/gather.py:188"),
    "gather_rows_t": ("ihgnn_torch/csrc/gather.cu",
                      "ihgnn_tpu/ops/pallas/gather.py:374"),
    "csr_segment_sum3": ("ihgnn_torch/csrc/segsum.cu",
                         "ihgnn_tpu/ops/pallas/segsum.py:403"),
    "row_local_permute": ("ihgnn_torch/csrc/permute.cu",
                          "ihgnn_tpu/ops/pallas/permute.py:114"),
    "transposed_local_permute": ("ihgnn_torch/csrc/permute.cu",
                                 "ihgnn_tpu/ops/pallas/permute.py:289"),
    "interact_fwd_absorb": ("ihgnn_torch/csrc/interact.cu",
                            "ihgnn_tpu/ops/pallas/interact.py:397"),
    "interact_bwd_absorb": ("ihgnn_torch/csrc/interact_bwd.cu",
                            "ihgnn_tpu/ops/pallas/interact.py:422"),
    "csr_segment_scan": ("ihgnn_torch/csrc/segscan.cu",
                         "ihgnn_tpu/ops/pallas/segscan.py:294"),
    # the bf16 forms (bf16 streams, the direct path): K1's vector forms on
    # bf16 rows (the Pallas segment sums' bf16 values, segsum.py:403 and
    # :458), K2 writing bf16 roles, K3 and interact_bwd on bf16 roles
    "csr_gather_sum_bf16": ("ihgnn_torch/csrc/segsum.cu",
                            "ihgnn_tpu/ops/pallas/segsum.py:403"),
    "gather_roles_bf16": ("ihgnn_torch/csrc/gather.cu",
                          "ihgnn_tpu/ops/pallas/gather.py:188"),
    "interact_fwd_bf16": ("ihgnn_torch/csrc/interact.cu",
                          "ihgnn_tpu/ops/pallas/interact.py:319"),
    "interact_bwd_bf16": ("ihgnn_torch/csrc/interact_bwd.cu",
                          "ihgnn_tpu/ops/pallas/interact.py:340"),
    # the routed pack's bf16 forms (bf16 streams on the routed path):
    # the windowed expands' bf16 bodies (gather.py:162, :263; their int8
    # byte-plane bodies :82, :308 copy bf16 rows exactly), the three-region
    # sum, K5 and K8 on bf16 values, and K6/K7 on bf16 rows
    "gather_rows_bf16": ("ihgnn_torch/csrc/gather.cu",
                         "ihgnn_tpu/ops/pallas/gather.py:188"),
    "gather_rows_t_bf16": ("ihgnn_torch/csrc/gather.cu",
                           "ihgnn_tpu/ops/pallas/gather.py:374"),
    "csr_segment_sum3_bf16": ("ihgnn_torch/csrc/segsum.cu",
                              "ihgnn_tpu/ops/pallas/segsum.py:403"),
    "interact_fwd_absorb_bf16": ("ihgnn_torch/csrc/interact.cu",
                                 "ihgnn_tpu/ops/pallas/interact.py:397"),
    "interact_bwd_absorb_bf16": ("ihgnn_torch/csrc/interact_bwd.cu",
                                 "ihgnn_tpu/ops/pallas/interact.py:422"),
    "csr_segment_scan_bf16": ("ihgnn_torch/csrc/segscan.cu",
                              "ihgnn_tpu/ops/pallas/segscan.py:294"),
    "row_local_permute_bf16": ("ihgnn_torch/csrc/permute.cu",
                               "ihgnn_tpu/ops/pallas/permute.py:114"),
    "transposed_local_permute_bf16": ("ihgnn_torch/csrc/permute.cu",
                                      "ihgnn_tpu/ops/pallas/permute.py:289"),
    # the chunked pack: csr_segment_sum3_multi's node sum is K1's
    # three-region form over the CSR spanning the chunks (f32 and bf16
    # chunk streams), counted on the chunked paths
    "csr_segment_sum3_multi": ("ihgnn_torch/csrc/segsum.cu",
                               "ihgnn_tpu/ops/pallas/segsum.py:686"),
    "csr_segment_sum3_multi_bf16": ("ihgnn_torch/csrc/segsum.cu",
                                    "ihgnn_tpu/ops/pallas/segsum.py:686"),
    # the routed GAT's [1, N] expands: K2's d = 1 form
    "gather_scalars": ("ihgnn_torch/csrc/gather.cu",
                       "ihgnn_tpu/ops/pallas/gather.py:188"),
}
# kernel rows whose launches a wrapper counts under another name
COUNTED_AS = {"csr_segment_sum3_multi": "csr_segment_sum3",
              "csr_segment_sum3_multi_bf16": "csr_segment_sum3_bf16"}


# phase cli: the quality set of ihgnn_torch.quality_parity, trained for
# CLI_EPOCHS (tested from epoch 2 every 2), resumed for CLI_RESUME_EPOCHS,
# then --gnn gat for CLI_GAT_EPOCHS (tested), then --bf16_stream --remat
# for CLI_BF16_EPOCHS (tested)
CLI_EPOCHS, CLI_RESUME_EPOCHS, CLI_GAT_EPOCHS = 4, 2, 1
CLI_BF16_EPOCHS = 1
# then --model srrl for CLI_SRRL_EPOCHS (tested at the last, stored), and
# its --checkpoint latest resume for CLI_SRRL_RESUME_EPOCHS
CLI_SRRL_EPOCHS, CLI_SRRL_RESUME_EPOCHS = 2, 1


def _cli_expected(runs):
    """The launches of the cli phase's runs: each run's train steps and
    test-epoch forwards times the counts of its model's step and forward;
    every other kernel 0."""
    expected = {k: 0 for k in _launch_counts()}
    for stats, (per_step, per_forward) in runs:
        steps = sum(s.steps for s in stats)
        forwards = sum(s.eval_s is not None for s in stats)
        for counts, units in ((per_step, steps), (per_forward, forwards)):
            for k, v in counts.items():
                expected[k] += v * units
    return expected


def run_cli(torch, dev):
    """Phase ``cli``: the training CLI (``ihgnn_torch.cli.main``) on the
    card, as a user runs it, on the quality set of
    ``ihgnn_torch.quality_parity`` written by the port's
    ``write_synthetic_dataset``: CLI_EPOCHS epochs of the default model
    with ``--storecheckpoint --storemetrics`` (epoch 2 under
    ``torch.profiler``), a ``--checkpoint latest`` resume for
    CLI_RESUME_EPOCHS more, then ``--gnn gat`` for CLI_GAT_EPOCHS, then
    ``--bf16_stream --remat`` for CLI_BF16_EPOCHS, then ``--model srrl``
    for CLI_SRRL_EPOCHS with ``--storecheckpoint`` and its ``--checkpoint
    latest`` resume for CLI_SRRL_RESUME_EPOCHS. Fails
    unless each resume renumbers from the next epoch from exactly the
    saved state, the log and metrics files exist, the average loss falls
    over the first run, the metrics are finite and every launch count is
    exact (Srrl launches none). Returns the launches."""
    import copy
    import os
    import tempfile

    from ihgnn_torch import cli
    from ihgnn_torch.data.artifacts import write_synthetic_dataset
    from ihgnn_torch.quality_parity import QUALITY_SET
    from ihgnn_torch.train import srrl_loop

    def snapshot(model, opt):
        return ({k: v.detach().clone() for k, v in
                 model.state_dict().items()}, copy.deepcopy(opt.state_dict()))

    save, restore = cli.save_checkpoint, cli.restore_checkpoint

    def spies(saved, restored):
        def spy_save(result_dir, epoch, model, opt, **kw):
            saved[epoch] = snapshot(model, opt)
            return save(result_dir, epoch, model, opt, **kw)

        def spy_restore(result_dir, name, model, opt, **kw):
            epoch = restore(result_dir, name, model, opt, **kw)
            restored[epoch] = snapshot(model, opt)
            return epoch
        return spy_save, spy_restore

    saved, restored, srrl_saved, srrl_restored = {}, {}, {}, {}

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "quality_ds")
        t0 = time.perf_counter()
        write_synthetic_dataset(data_dir, **QUALITY_SET)
        write_s = time.perf_counter() - t0
        results, prof_dir = os.path.join(tmp, "results"), os.path.join(
            tmp, "profile")
        base = ["--dataset", data_dir, "--result_dir", results,
                "--epoch_start_test", "2", "--epoch_test_frequency", "2"]
        cli.save_checkpoint, cli.restore_checkpoint = spies(saved, restored)
        srrl_loop.save_checkpoint, srrl_loop.restore_checkpoint = spies(
            srrl_saved, srrl_restored)
        try:
            torch.cuda.synchronize()
            _zero_launches()
            t0 = time.perf_counter()
            first = cli.main(base + ["--epoch_count", str(CLI_EPOCHS),
                                     "--storecheckpoint", "--storemetrics",
                                     "--profile_dir", prof_dir])
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            resumed = cli.main(base + ["--epoch_count",
                                       str(CLI_RESUME_EPOCHS),
                                       "--checkpoint", "latest"])
            resumed_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            gat = cli.main(["--dataset", data_dir, "--result_dir", results,
                            "--gnn", "gat", "--epoch_count",
                            str(CLI_GAT_EPOCHS), "--epoch_start_test", "1"])
            gat_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            bf16 = cli.main(["--dataset", data_dir, "--result_dir", results,
                             "--bf16_stream", "--remat", "--epoch_count",
                             str(CLI_BF16_EPOCHS), "--epoch_start_test",
                             "1"])
            bf16_s = time.perf_counter() - t0
            srrl_base = ["--dataset", data_dir, "--result_dir", results,
                         "--model", "srrl", "--epoch_start_test",
                         str(CLI_SRRL_EPOCHS)]
            t0 = time.perf_counter()
            srrl = cli.main(srrl_base + ["--epoch_count",
                                         str(CLI_SRRL_EPOCHS),
                                         "--storecheckpoint"])
            srrl_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            srrl_resumed = cli.main(srrl_base + [
                "--epoch_count", str(CLI_SRRL_RESUME_EPOCHS),
                "--checkpoint", "latest"])
            srrl_resumed_s = time.perf_counter() - t0
            torch.cuda.synchronize()
        finally:
            cli.save_checkpoint, cli.restore_checkpoint = save, restore
            srrl_loop.save_checkpoint = save
            srrl_loop.restore_checkpoint = restore
        launches = _launch_counts()
        idle = _window_summary(_trace_events(
            os.path.join(prof_dir, "epoch2.trace.json")))
        files = {d: sorted(os.listdir(os.path.join(results, d)))
                 for d in sorted(os.listdir(results))}

    expected = _cli_expected([
        (first.epoch_stats, (IHGNN_STEP_LAUNCHES, IHGNN_FORWARD_LAUNCHES)),
        (resumed.epoch_stats, (IHGNN_STEP_LAUNCHES, IHGNN_FORWARD_LAUNCHES)),
        (gat.epoch_stats, (GAT_STEP_LAUNCHES, GAT_FORWARD_LAUNCHES)),
        (bf16.epoch_stats, (IHGNN_STEP_LAUNCHES_BF16_REMAT,
                            IHGNN_FORWARD_LAUNCHES_BF16))])
    losses = [s.avg_loss for s in first.epoch_stats]
    resumed_epochs = [s.epoch for s in resumed.epoch_stats]
    same_state = (list(saved) == [CLI_EPOCHS] == list(restored)
                  and _same_state(torch, saved[CLI_EPOCHS],
                                  restored[CLI_EPOCHS]))
    # the first run's <stamp>_train_log.txt and <stamp>_metrics.txt
    # (--storemetrics), the resume's train_log.txt
    ihgnn_files = [f for d, names in files.items() if "IHGNNLayer" in d
                   for f in names]
    logs_written = "train_log.txt" in ihgnn_files and all(
        any(f.endswith(suffix) for f in ihgnn_files)
        for suffix in ("_train_log.txt", "_metrics.txt"))
    srrl_same_state = (list(srrl_saved) == [CLI_SRRL_EPOCHS]
                       == list(srrl_restored)
                       and _same_state(torch, srrl_saved[CLI_SRRL_EPOCHS],
                                       srrl_restored[CLI_SRRL_EPOCHS]))
    srrl_resumed_epochs = [s.epoch for s in srrl_resumed.epoch_stats]
    metrics = {name: [(e, m.as_row(), v.as_row())
                      for e, m, v in mc.iter_epoch_test_valid()]
               for name, mc in (("first", first), ("resumed", resumed),
                                ("gat", gat), ("bf16_remat", bf16),
                                ("srrl", srrl))}
    # the profiled second epoch aside, and the first one's set-up
    warm = [s for s in first.epoch_stats + resumed.epoch_stats
            if s.epoch not in (1, 2)]
    epoch_s = float(np.median([s.train_s for s in warm]))
    steps = warm[0].steps
    evals = [s.eval_s for s in first.epoch_stats + resumed.epoch_stats
             if s.eval_s is not None]
    emit({"phase": "cli", "dataset": QUALITY_SET,
          "dataset_write_s": write_s, "steps_per_epoch": steps,
          "epochs": [dataclasses.asdict(s) for s in first.epoch_stats
                     + resumed.epoch_stats],
          "gat_epochs": [dataclasses.asdict(s) for s in gat.epoch_stats],
          "bf16_remat_epochs": [dataclasses.asdict(s)
                                for s in bf16.epoch_stats],
          "epoch_s": epoch_s, "steps_per_s": steps / epoch_s,
          "eval_s": float(np.median(evals)),
          "srrl_epochs": [dataclasses.asdict(s) for s in srrl.epoch_stats
                          + srrl_resumed.epoch_stats],
          "run_s": {"first": first_s, "resumed": resumed_s, "gat": gat_s,
                    "bf16_remat": bf16_s, "srrl": srrl_s,
                    "srrl_resumed": srrl_resumed_s},
          "profiled_epoch": {"epoch": 2, **idle},
          "losses": losses, "resumed_epochs": resumed_epochs,
          "restored_equals_saved": same_state,
          "srrl_resumed_epochs": srrl_resumed_epochs,
          "srrl_restored_equals_saved": srrl_same_state, "files": files,
          "metrics": metrics, "launches": launches,
          "expected_launches": expected})
    if launches != expected:
        fail(f"cli: kernel launches {launches}, expected {expected}")
    if resumed_epochs != list(range(CLI_EPOCHS + 1,
                                    CLI_EPOCHS + 1 + CLI_RESUME_EPOCHS)):
        fail(f"cli: the resume ran epochs {resumed_epochs}")
    if not same_state:
        fail("cli: the restored state differs from the saved one")
    if srrl_resumed_epochs != list(range(
            CLI_SRRL_EPOCHS + 1,
            CLI_SRRL_EPOCHS + 1 + CLI_SRRL_RESUME_EPOCHS)):
        fail(f"cli: the Srrl resume ran epochs {srrl_resumed_epochs}")
    if not srrl_same_state:
        fail("cli: the restored Srrl state differs from the saved one")
    if not all(np.isfinite([s.avg_loss, s.kg_avg_loss]).all()
               for s in srrl.epoch_stats + srrl_resumed.epoch_stats):
        fail(f"cli: non-finite Srrl losses {srrl.epoch_stats}")
    if not logs_written:
        fail(f"cli: log or metrics file missing: {files}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"cli: the average loss did not fall: {losses}")
    if not all(np.isfinite(s.avg_loss) for s in bf16.epoch_stats):
        fail(f"cli: non-finite --bf16_stream --remat losses "
             f"{bf16.epoch_stats}")
    for name, rows in metrics.items():
        values = [x for _, m, v in rows for x in m + v]
        if not rows or not all(0.0 <= x <= 1.0 for x in values):
            fail(f"cli: bad {name} metrics {rows}")
    reference = {"epoch1_loss": losses[0],
                 "srrl_stats": srrl.epoch_stats,
                 "srrl_test": dict((e, m) for e, m, _ in
                                   metrics["srrl"])[CLI_SRRL_EPOCHS],
                 "epoch2_test": dict((e, m) for e, m, _ in
                                     metrics["first"])[2],
                 "gat_epoch1_loss": gat.epoch_stats[0].avg_loss,
                 "gat_epoch1_test": dict((e, m) for e, m, _ in
                                         metrics["gat"])[1]}
    return launches, reference


# ---- data parallelism over the edge axis: S ranks share the one card

# ranks of the sharded phases, all on card 0 with gloo (NCCL refuses two
# ranks on one GPU); full-width steps: SHARDED_WARM, then SHARDED_TIMED
# timed (host clock, the card idle before and after; 2 + 5 before the
# model axis's phases joined them)
SHARDED_RANKS = 4
SHARDED_WARM, SHARDED_TIMED = 1, 2
# SMALL's nodes with 2 more edges than SMALL, so the edges pad to a
# multiple of the ranks; the log hypergraph's logs (not a multiple of the
# ranks: memberless pad edges); the chunked case's edges, at
# SMALL_CHUNK_RANK_CAP rows a chunk 3 chunks of a 128-column grid a rank
SHARDED_SMALL_EDGES = SMALL["edges"] + 2
SHARDED_SMALL_LOGS = 150
SHARDED_SMALL_CHUNK_EDGES, SMALL_CHUNK_RANK_CAP = 1_200, 1
# the S-rank run against the one-rank run on the card: f32 within this
# share of the largest value (features, step-0 gradients) and relative
# (losses); bf16 streams with the bf16 wire: BF16_FEATURE_RTOL of scale
# and ROUTED_BF16_LOSS_RTOL for the step-0 loss
SHARDED_RTOL = 1e-5
# the mesh CLI runs against their one-rank runs: the losses relative; the
# first run's test metrics within 2 x the largest std of PARITY.json's
# rawgnn runs, every other run's equal
CLI_MESH_LOSS_RTOL = 1e-4
CLI_MESH_EPOCHS, CLI_MESH_RESUME_EPOCHS = 1, 1


def _sum_counts(ranks, j):
    """Job ``j``'s launch counts summed over the ranks."""
    total = {}
    for rank in ranks:
        for k, v in rank[j]["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def _check_rank_counts(path, ranks, j, expected, per_step, steps):
    """Fails unless every kernel of ``expected`` launched in every rank,
    ``per_step`` times the steps each; a callable ``per_step`` gives a
    chunked pack's step counts from the rank's chunks."""
    for r, rank in enumerate(ranks):
        launches = rank[j]["launches"]
        for name in expected:
            if launches[name] <= 0:
                fail(f"{path}: {name} was not launched in rank {r}")
        _check_counts(f"{path} rank {r}", launches,
                      per_step(rank[j]["chunks"]) if callable(per_step)
                      else per_step, steps)


def expected_collectives(cfg, data, model=1, shard_both=False,
                          bf16_wire=True):
    """``{kind: count}`` of the collectives one train step issues on a
    (``data``, ``model``) mesh, as ``ihgnn_torch/parallel/`` issues them
    (a collective over one rank does not run): the tables' gather over the
    model group (first over the data group with ``shard_both``) and its
    gradient's sum over the data group (an all-reduce; a reduce-scatter
    with ``shard_both``); with data > 1 the bag's all-gather and its
    reduce-scatter, the loss's and the gradients' all-reduce, and a
    layer's node sums: GAT and phase 2 a max and a sum all-reduce and an
    f32 combine (reduce-scatter + all-gather) forward, the combine and the
    ``tsum`` all-reduce backward; IHGNN's last layer the tail's all-reduce
    both ways, its others a combine both ways (one bf16 all-reduce on
    bf16 streams over the bf16 wire); the log HGCN a combine both ways."""
    from ihgnn_torch.config import V
    ar = ag = rs = 0
    if (data * model if shard_both else model) > 1:
        ag += (model > 1) + (shard_both and data > 1)
        if data > 1:
            rs, ar = (rs + 1, ar) if shard_both else (rs, ar + 1)
    if data > 1:
        ar, ag, rs = ar + 2, ag + 1, rs + 1
        last = cfg.gnn_layer_count - 1
        for layer in range(cfg.gnn_layer_count):
            if cfg.gnn == V.GAT or (cfg.gnn == V.IHGNN
                                    and cfg.phase2_attention):
                ar, rs, ag = ar + 3, rs + 2, ag + 2
            elif cfg.gnn == V.IHGNN and layer == last:
                ar += 2
            elif cfg.gnn == V.IHGNN and cfg.bf16_stream and bf16_wire:
                ar += 2
            else:
                rs, ag = rs + 2, ag + 2
    return {"all-reduce": ar, "all-gather": ag, "reduce-scatter": rs}


def _check_collectives(path, ranks, j, expected):
    """One ``collective_stats`` line a step of job ``j`` (rank 0's counts
    and bytes, its largest calls), and fails unless every rank's every
    step issued exactly ``expected`` (``expected_collectives``)."""
    from ihgnn_torch.utils.collective_stats import (collective_stats,
                                                    collective_table,
                                                    comm_bytes)
    bad = []
    for r, rank in enumerate(ranks):
        for k, record in enumerate(rank[j]["collectives"]):
            stats = collective_stats(record)
            counts = {kind: stats.get(kind, {}).get("count", 0)
                      for kind in expected}
            if counts != expected or set(stats) - set(expected):
                bad.append((r, k, counts))
            if r == 0:
                emit({"phase": "collective_stats", "path": path, "step": k,
                      "stats": stats, "comm_bytes": comm_bytes(record),
                      "expected_counts": expected,
                      "largest": collective_table(record)[:4]})
    if bad:
        fail(f"{path}: collective counts off in (rank, step, counts) {bad}, "
             f"expected {expected}")


def check_sharded_small(torch, dev):
    """Phase ``sharded_small_reference``: SHARDED_RANKS gloo ranks on the
    card train SMALL_STEPS steps on SHARDED_SMALL_EDGES edges of SMALL's
    nodes (padded to a multiple of the ranks): the default model direct
    and with per-rank routed packs, GAT with either head (a tenth of the
    2D graph's flags 0, so the softmax masks entries), IHGNN with phase 2
    direct and routed, HGCN on a log hypergraph of SHARDED_SMALL_LOGS
    logs (padded with memberless edges), and the default model on per-rank
    packs chunked at SMALL_CHUNK_RANK_CAP over SHARDED_SMALL_CHUNK_EDGES
    edges (3 chunks a rank); f32, from the same weights and batches as the
    same ranks on the CPU (plain twins) and one rank on the card. Held:
    card ranks against CPU ranks at the SMALL_* limits (features, losses,
    every step-0 gradient, the parameters after the last step; score
    heads as ``grad_scale``, their parameters reported), against the
    one-rank card run within SHARDED_RTOL of scale (features, losses,
    step-0 gradients), every rank's parameters equal bit for bit, every
    kernel of the path launched in every rank, exactly. The cases of
    ``sharded_model_small_reference`` run beside them
    (``_check_model_small``). Returns ``(jobs, finish)``: ``finish(card,
    card_s)`` takes the card ranks' results of ``jobs`` (``run_sharded``
    spawns every sharded phase's card ranks at once) and returns the
    launches summed over the card's ranks, by case, of each phase."""
    from ihgnn_torch.config import ModelConfig, V
    from ihgnn_torch.parallel.ranks import TrainJob

    s = SMALL
    _, uqi = random_graph(s["users"], s["queries"], s["items"],
                          SHARDED_SMALL_EDGES, 95)
    _, uqi_big = random_graph(s["users"], s["queries"], s["items"],
                              SHARDED_SMALL_CHUNK_EDGES, 99)
    flags = (np.random.default_rng(100).random(len(uqi)) > 0.1).astype(
        np.int64)
    uqif = np.column_stack([uqi, flags])
    logs = log_edges(s["users"], s["queries"], s["items"],
                     SHARDED_SMALL_LOGS, 101)
    qw, qc = random_words(s["queries"], s["vocab"], 96)
    counts = (s["users"], s["queries"], s["items"], s["vocab"])
    phase2 = ModelConfig(phase2_attention=True)
    # case: (ModelConfig, interactions, TrainJob fields, kernels, per step)
    paths = {
        "direct": (ModelConfig(), uqi, {}, IHGNN_TRAIN, IHGNN_STEP_LAUNCHES),
        "routed": (ModelConfig(), uqi, {"pack_kernels": True}, ROUTED_TRAIN,
                   ROUTED_STEP_LAUNCHES),
        "gat": (ModelConfig(gnn=V.GAT), uqif, {}, GAT_TRAIN,
                GAT_STEP_LAUNCHES),
        "gat_product": (ModelConfig(gnn=V.GAT, gat_head=V.PRODUCT), uqif, {},
                        GAT_TRAIN, GAT_PRODUCT_STEP_LAUNCHES),
        "phase2": (phase2, uqi, {}, PHASE2_TRAIN, PHASE2_STEP_LAUNCHES),
        "phase2_routed": (phase2, uqi, {"pack_kernels": True},
                          PHASE2_ROUTED_TRAIN, PHASE2_ROUTED_STEP_LAUNCHES),
        "log": (ModelConfig(gnn=V.HGCN, use_log_hypergraph=True), uqi,
                {"log_edges": logs}, LOG_TRAIN, LOG_STEP_LAUNCHES),
        "chunked": (ModelConfig(), uqi_big,
                    {"pack_kernels": True,
                     "chunk_rows_cap": SMALL_CHUNK_RANK_CAP}, ROUTED_TRAIN,
                    lambda chunks: per_chunk(ROUTED_STEP_LAUNCHES, chunks))}
    jobs = []
    for name, (cfg, inter, fields, _, _) in paths.items():
        batches = [train_batch(inter, s["items"], SMALL_B, TRAIN_K, 97 + k)
                   for k in range(SMALL_STEPS)]
        jobs.append(TrainJob(name, cfg, counts, inter, qw, qc, batches,
                             seed=98, keep_state=True, keep_features=True,
                             **fields))
    # the model axis's small cases run beside them
    model_cases, model_jobs = _model_small_jobs()
    n = len(jobs)
    return jobs + model_jobs, lambda card, card_s: _finish_sharded_small(
        paths, jobs + model_jobs, n, model_cases, card, card_s)


def _finish_sharded_small(paths, jobs, n, model_cases, card, card_s):
    """The second half of ``check_sharded_small``: ``card`` holds the
    card ranks' results of ``jobs`` (the first ``n`` of
    ``sharded_small_reference``, then ``_model_small_jobs``'); runs the
    same jobs on CPU ranks and in one rank on the card and holds them."""
    from ihgnn_torch.parallel.ranks import run_jobs

    cpu = run_jobs(SHARDED_RANKS, jobs, "cpu")
    one = run_jobs(0, jobs, "cuda")[0]
    failed, launches = [], {}
    for j, (name, (_, _, fields, expected, per_step)) in enumerate(
            paths.items()):
        if name == "chunked" and min(r[j]["chunks"] for r in card) < 2:
            fail(f"sharded_small_reference chunked: rank chunks "
                 f"{[r[j]['chunks'] for r in card]}, expected 2 or more")
        _check_rank_counts(f"sharded_small_reference {name}", card, j,
                             expected, per_step, SMALL_STEPS)
        _check_collectives(f"sharded_small_reference {name}", card, j,
                           expected_collectives(paths[name][0],
                                                SHARDED_RANKS))
        launches[name] = _sum_counts(card, j)
        got, want, single = card[0][j], cpu[0][j], one[j]
        feat_err = (got["features"] - want["features"]).abs().max().item()
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(got["losses"], want["losses"]))
        grad_err = {k: (got["grads0"][k] - g).abs().max().item()
                    / grad_scale(k, want["grads0"])
                    for k, g in want["grads0"].items()}
        param_errs = {k: (got["params"][k] - v).abs().max().item()
                      for k, v in want["params"].items()}
        param_err = max(v for k, v in param_errs.items()
                        if ".feature_aggregate." not in k)
        head_param_err = max([v for k, v in param_errs.items()
                              if ".feature_aggregate." in k], default=None)
        scale = single["features"].abs().max().item()
        one_feat = (got["features"] - single["features"]).abs().max().item()
        one_loss = max(abs(a - b) / abs(b) for a, b in
                       zip(got["losses"], single["losses"]))
        one_grad = max((got["grads0"][k] - g).abs().max().item()
                       / grad_scale(k, single["grads0"])
                       for k, g in single["grads0"].items())
        replicas = {"card": len({r[j]["digest"] for r in card}) == 1,
                    "cpu": len({r[j]["digest"] for r in cpu}) == 1}
        ok = (feat_err <= SMALL_FEATURE_ATOL and loss_err <= SMALL_LOSS_RTOL
              and max(grad_err.values()) <= SMALL_GRAD_RTOL
              and param_err <= SMALL_PARAM_ATOL
              and one_feat <= SHARDED_RTOL * scale
              and one_loss <= SHARDED_RTOL and one_grad <= SHARDED_RTOL
              and all(replicas.values()))
        emit({"phase": "sharded_small_reference", "case": name,
              "ranks": SHARDED_RANKS, "backend": got["backend"],
              "combine": "reduce_scatter + all_gather",
              "edges": (SHARDED_SMALL_CHUNK_EDGES if name == "chunked"
                        else SHARDED_SMALL_EDGES),
              "logs": SHARDED_SMALL_LOGS if "log_edges" in fields else None,
              "chunks_a_rank": [r[j]["chunks"] for r in card],
              "steps": SMALL_STEPS,
              "card_ranks_s": card_s,
              "vs_cpu_ranks": {"features_max_abs_err": feat_err,
                               "loss_max_rel_err": loss_err,
                               "grad0_rel_err_max": max(grad_err.values()),
                               "grad0_rel_err": grad_err,
                               "param_max_abs_err": param_err,
                               "score_head_param_max_abs_err":
                                   head_param_err},
              "vs_one_rank_card": {"features_rel_err": one_feat / scale,
                                   "loss_max_rel_err": one_loss,
                                   "grad0_rel_err_max": one_grad},
              "replicas_equal": replicas, "card_losses": got["losses"],
              "launches_rank0": card[0][j]["launches"], "held": True})
        if not ok:
            failed.append(name)
    model_launches = _check_model_small(
        model_cases, [r[n:] for r in card], [r[n:] for r in cpu], one[n:],
        card_s)
    if failed:
        fail(f"sharded_small_reference: {failed} disagree")
    return launches, model_launches


def run_sharded(torch, dev, uqi, qw, qc):
    """The sharded phases' card ranks in one spawn (a spawn of
    SHARDED_RANKS ranks costs ~20 s on the card's host): the jobs of
    ``check_sharded_small`` (with ``sharded_model_small_reference``'s),
    ``run_sharded_train``, ``run_sharded_layers`` and
    ``run_sharded_model_train``, in that order; then each phase's second
    half holds and reports its share (its ``ranks_run_s`` is the whole
    spawn's). Returns the launches by path, each phase's prefixed as
    ``main`` names them."""
    from ihgnn_torch.parallel.ranks import run_jobs

    phases = [check_sharded_small(torch, dev),
              run_sharded_train(torch, dev, uqi, qw, qc),
              run_sharded_layers(torch, dev, uqi, qw, qc),
              run_sharded_model_train(torch, dev, uqi, qw, qc)]
    jobs = [job for phase_jobs, _ in phases for job in phase_jobs]
    t0 = time.perf_counter()
    card = run_jobs(SHARDED_RANKS, jobs, "cuda")
    card_s = time.perf_counter() - t0
    del jobs
    out, start = [], 0
    for phase_jobs, finish in phases:
        stop = start + len(phase_jobs)
        out.append(finish([rank[start:stop] for rank in card], card_s))
        start = stop
    (small, model_small), train, layers, model_train = out
    launches = {f"sharded_small_reference_{k}": v for k, v in small.items()}
    launches.update({f"sharded_model_small_reference_{k}": v
                     for k, v in model_small.items()})
    for counts in (train, layers, model_train):
        launches.update(counts)
    return launches


def run_sharded_train(torch, dev, uqi, qw, qc):
    """Phases ``sharded_train`` (f32, then ``bf16`` streams with the bf16
    wire) and ``sharded_routed_train`` (per-rank routed packs, f32): the
    default model at full width (``bench.py``'s graph, E = 2M) in
    SHARDED_RANKS gloo ranks of E / SHARDED_RANKS edges sharing the card,
    batches of TRAIN_B positives x TRAIN_K negatives split over the ranks,
    SHARDED_WARM + SHARDED_TIMED steps, against one rank on the card on
    the same graph, weights and batches. Held: every kernel of the path
    launched in every rank, each exactly a step's count times the steps;
    the features before the first step and the step-0 loss against the
    one-rank run (f32 SHARDED_RTOL; bf16 BF16_FEATURE_RTOL of scale and
    ROUTED_BF16_LOSS_RTOL); every rank's parameters equal bit for bit.
    Reported: each rank's step time and time inside collectives (the
    ranks share one card: not a multi-card time), peak memory a rank.
    Returns ``(jobs, finish)`` as ``check_sharded_small`` does;
    ``finish`` returns the launches summed over the ranks, by path."""
    from ihgnn_torch.config import ModelConfig
    from ihgnn_torch.parallel.ranks import TrainJob, run_jobs

    steps = SHARDED_WARM + SHARDED_TIMED
    batches = [train_batch(uqi, I, TRAIN_B, TRAIN_K, 300 + k)
               for k in range(steps)]
    ihgnn = ModelConfig()
    ihgnn16 = dataclasses.replace(ihgnn, bf16_stream=True)
    paths = {"sharded_train": (ihgnn, False, IHGNN_TRAIN,
                               IHGNN_STEP_LAUNCHES),
             "sharded_train_bf16": (ihgnn16, False, IHGNN_TRAIN_BF16,
                                    IHGNN_STEP_LAUNCHES_BF16),
             "sharded_routed_train": (ihgnn, True, ROUTED_TRAIN,
                                      ROUTED_STEP_LAUNCHES)}
    jobs = [TrainJob(path, cfg, (U, Q, I, VOCAB), uqi, qw, qc, batches,
                     seed=0, pack_kernels=pack, keep_features=True,
                     time_steps=SHARDED_TIMED)
            for path, (cfg, pack, _, _) in paths.items()]
    return jobs, lambda ranks, ranks_s: _finish_sharded_train(
        paths, jobs, steps, batches, ranks, ranks_s)


def _finish_sharded_train(paths, jobs, steps, batches, ranks, ranks_s):
    """The second half of ``run_sharded_train`` (``ranks``: the card
    ranks' results of ``jobs``)."""
    from ihgnn_torch.parallel.ranks import run_jobs

    one = run_jobs(0, jobs, "cuda")[0]
    launches, failed = {}, []
    for j, (path, (cfg, pack, expected, per_step)) in enumerate(
            paths.items()):
        _check_rank_counts(path, ranks, j, expected, per_step, steps)
        _check_collectives(path, ranks, j,
                           expected_collectives(cfg, SHARDED_RANKS))
        launches[path] = _sum_counts(ranks, j)
        got, single = ranks[0][j], one[j]
        scale = single["features"].abs().max().item()
        feat_err = (got["features"] - single["features"]).abs().max().item()
        loss_err = abs(got["losses"][0] - single["losses"][0]) \
            / abs(single["losses"][0])
        bf16 = cfg.bf16_stream
        feat_tol = (BF16_FEATURE_RTOL if bf16 else SHARDED_RTOL) * scale
        loss_tol = ROUTED_BF16_LOSS_RTOL if bf16 else SHARDED_RTOL
        replicas = len({r[j]["digest"] for r in ranks}) == 1
        finite = all(np.isfinite(r[j]["losses"]).all() for r in ranks)
        step_ms = [float(np.median(r[j]["step_ms"])) for r in ranks]
        coll_ms = [float(np.median(r[j]["collective_ms"])) for r in ranks]
        emit({"phase": "sharded_routed_train" if pack else "sharded_train",
              "streams": "bf16" if bf16 else "f32",
              "bf16_wire": bf16, "ranks": SHARDED_RANKS,
              "backend": got["backend"],
              "combine": ("bf16 all_reduce" if bf16 else
                          "reduce_scatter + all_gather"),
              "note": ("the ranks share one card: not a multi-card time"
                       if got["backend"] == "gloo" else
                       "a card a rank"),
              "edges_a_rank": E // SHARDED_RANKS,
              "rows_a_rank": len(batches[0].users) // SHARDED_RANKS,
              "steps": steps, "timed_steps": SHARDED_TIMED,
              "rank_step_ms_median": step_ms,
              "rank_collective_ms_median": coll_ms,
              "rank_step_ms": [r[j]["step_ms"] for r in ranks],
              "rank_collective_ms": [r[j]["collective_ms"] for r in ranks],
              "max_memory_allocated_bytes": [
                  r[j].get("max_memory_allocated_bytes") for r in ranks],
              "state_bytes_a_rank": got["state_bytes"],
              "graph_s": [r[j]["graph_s"] for r in ranks],
              "ranks_run_s": ranks_s, "losses": got["losses"],
              "one_rank_losses": single["losses"],
              "features_max_abs_err": feat_err, "features_scale": scale,
              "features_tol": feat_tol, "step0_loss_rel_err": loss_err,
              "loss_rtol": loss_tol, "replicas_equal": replicas,
              "launches_rank0": got["launches"], "held": True})
        if not (feat_err <= feat_tol and loss_err <= loss_tol and replicas
                and finite):
            failed.append(path)
    if failed:
        fail(f"sharded full-width paths {failed} disagree with one rank")
    return launches


# the attention, log and chunked paths in ranks (after sharded_train): the
# log hypergraph's logs (``log_edges``) and the per-rank chunked pack's
# rows a chunk, so each rank's 500k edges pack in 8 chunks of a
# [1024, 512] grid's 128 rows
SHARDED_LOGS = 1_000_000
SHARDED_CHUNK_CAP = 128


def run_sharded_layers(torch, dev, uqi, qw, qc):
    """Phases ``sharded_gat_train`` (two concat-head GAT layers on the
    uqi 2D graph of the bench interactions, ~3M entries a rank),
    ``sharded_phase2_train`` (IHGNN with phase-2 attention on the 2M-edge
    hypergraph, direct and then with per-rank routed packs),
    ``sharded_log_train`` (HGCN on a log hypergraph of SHARDED_LOGS logs
    of the bench's nodes) and ``sharded_chunked_train`` (the default model
    on bf16 streams over the bf16 wire, per-rank packs chunked at
    SHARDED_CHUNK_CAP rows): full width (d = 32, batches of TRAIN_B x
    TRAIN_K), SHARDED_RANKS gloo ranks sharing the card, SHARDED_WARM +
    SHARDED_TIMED steps each, against one rank on the card on the same
    graph (the chunked one at the same cap), weights and batches. Held:
    every kernel of the path launched in every rank, each exactly a step's
    count (on a chunked pack, of the rank's chunks) times the steps; the
    features before the first step and every step-0 gradient within
    SHARDED_RTOL of scale (score heads: of their layer's largest, as
    ``grad_scale``), the step-0 loss within SHARDED_RTOL (bf16 streams:
    BF16_FEATURE_RTOL of scale and ROUTED_BF16_LOSS_RTOL); every rank's
    parameters equal bit for bit. Reported: each rank's step time, its
    collectives and among them the softmax's scalar all-reduces, peak
    memory a rank. Returns ``(jobs, finish)`` as ``check_sharded_small``
    does; ``finish`` returns the launches summed over the ranks, by
    path."""
    from ihgnn_torch.config import ModelConfig, V
    from ihgnn_torch.parallel.ranks import TrainJob

    steps = SHARDED_WARM + SHARDED_TIMED
    batches = [train_batch(uqi, I, TRAIN_B, TRAIN_K, 400 + k)
               for k in range(steps)]
    t0 = time.perf_counter()
    logs = log_edges(U, Q, I, SHARDED_LOGS, 401)
    logs_s = time.perf_counter() - t0
    chunked = lambda chunks: per_chunk(ROUTED_STEP_LAUNCHES_BF16, chunks)
    # path: (phase, ModelConfig, TrainJob fields, kernels, per-step counts)
    paths = {
        "sharded_gat_train": ("sharded_gat_train", ModelConfig(gnn=V.GAT),
                              {}, GAT_TRAIN, GAT_STEP_LAUNCHES),
        "sharded_phase2_train": (
            "sharded_phase2_train", ModelConfig(phase2_attention=True), {},
            PHASE2_TRAIN, PHASE2_STEP_LAUNCHES),
        "sharded_phase2_routed_train": (
            "sharded_phase2_train", ModelConfig(phase2_attention=True),
            {"pack_kernels": True}, PHASE2_ROUTED_TRAIN,
            PHASE2_ROUTED_STEP_LAUNCHES),
        "sharded_log_train": (
            "sharded_log_train",
            ModelConfig(gnn=V.HGCN, use_log_hypergraph=True),
            {"log_edges": logs}, LOG_TRAIN, LOG_STEP_LAUNCHES),
        "sharded_chunked_train": (
            "sharded_chunked_train", ModelConfig(bf16_stream=True),
            {"pack_kernels": True, "chunk_rows_cap": SHARDED_CHUNK_CAP},
            ROUTED_TRAIN_BF16, chunked)}
    jobs = [TrainJob(path, cfg, (U, Q, I, VOCAB), uqi, qw, qc, batches,
                     seed=0, keep_state=True, keep_features=True,
                     time_steps=SHARDED_TIMED, **fields)
            for path, (_, cfg, fields, _, _) in paths.items()]
    return jobs, lambda ranks, ranks_s: _finish_sharded_layers(
        paths, jobs, steps, batches, logs_s, ranks, ranks_s)


def _finish_sharded_layers(paths, jobs, steps, batches, logs_s, ranks,
                           ranks_s):
    """The second half of ``run_sharded_layers`` (``ranks``: the card
    ranks' results of ``jobs``)."""
    from ihgnn_torch.parallel.ranks import run_jobs

    one = run_jobs(0, jobs, "cuda")[0]
    launches, failed = {}, []
    for j, (path, (phase, cfg, fields, expected, per_step)) in enumerate(
            paths.items()):
        _check_rank_counts(path, ranks, j, expected, per_step, steps)
        _check_collectives(path, ranks, j,
                           expected_collectives(cfg, SHARDED_RANKS))
        launches[path] = _sum_counts(ranks, j)
        got, single = ranks[0][j], one[j]
        scale = single["features"].abs().max().item()
        feat_err = (got["features"] - single["features"]).abs().max().item()
        loss_err = abs(got["losses"][0] - single["losses"][0]) \
            / abs(single["losses"][0])
        grad_err = {k: (got["grads0"][k] - g).abs().max().item()
                    / grad_scale(k, single["grads0"])
                    for k, g in single["grads0"].items()}
        bf16 = cfg.bf16_stream
        rtol = BF16_FEATURE_RTOL if bf16 else SHARDED_RTOL
        loss_tol = ROUTED_BF16_LOSS_RTOL if bf16 else SHARDED_RTOL
        replicas = len({r[j]["digest"] for r in ranks}) == 1
        finite = all(np.isfinite(r[j]["losses"]).all() for r in ranks)
        step_ms = [float(np.median(r[j]["step_ms"])) for r in ranks]
        coll_ms = [float(np.median(r[j]["collective_ms"])) for r in ranks]
        scalar_ms = [float(np.median(r[j]["scalar_collective_ms"]))
                     for r in ranks]
        emit({"phase": phase, "path": path,
              "streams": "bf16" if bf16 else "f32", "bf16_wire": bf16,
              "pack_kernels": fields.get("pack_kernels", False),
              "chunk_rows_cap": fields.get("chunk_rows_cap"),
              "chunks_a_rank": [r[j]["chunks"] for r in ranks],
              "one_rank_chunks": single["chunks"],
              "ranks": SHARDED_RANKS, "backend": got["backend"],
              "note": ("the ranks share one card: not a multi-card time"
                       if got["backend"] == "gloo" else "a card a rank"),
              "logs": SHARDED_LOGS if "log_edges" in fields else None,
              "logs_draw_s": logs_s if "log_edges" in fields else None,
              "rows_a_rank": len(batches[0].users) // SHARDED_RANKS,
              "steps": steps, "timed_steps": SHARDED_TIMED,
              "rank_step_ms_median": step_ms,
              "rank_collective_ms_median": coll_ms,
              "rank_scalar_all_reduce_ms_median": scalar_ms,
              "rank_step_ms": [r[j]["step_ms"] for r in ranks],
              "rank_collective_ms": [r[j]["collective_ms"] for r in ranks],
              "rank_scalar_all_reduce_ms": [r[j]["scalar_collective_ms"]
                                            for r in ranks],
              "max_memory_allocated_bytes": [
                  r[j].get("max_memory_allocated_bytes") for r in ranks],
              "one_rank_max_memory_allocated_bytes":
                  single.get("max_memory_allocated_bytes"),
              "graph_s": [r[j]["graph_s"] for r in ranks],
              "one_rank_graph_s": single["graph_s"],
              "ranks_run_s": ranks_s, "losses": got["losses"],
              "one_rank_losses": single["losses"],
              "features_max_abs_err": feat_err, "features_scale": scale,
              "features_rtol": rtol, "step0_loss_rel_err": loss_err,
              "loss_rtol": loss_tol,
              "grad0_rel_err_max": max(grad_err.values()),
              "grad0_rel_err": grad_err, "grad_rtol": rtol,
              "replicas_equal": replicas,
              "launches_rank0": got["launches"], "held": True})
        if not (feat_err <= rtol * scale and loss_err <= loss_tol
                and max(grad_err.values()) <= rtol and replicas
                and finite):
            failed.append(path)
    if failed:
        fail(f"sharded paths {failed} disagree with one rank")
    return launches


def run_cli_mesh(torch, dev, reference):
    """Phase ``cli_mesh``: ``ihgnn_torch.cli`` under torchrun on phase
    cli's quality set, each rank writing ``--run_record``:
    ``--mesh_data SHARDED_RANKS`` for CLI_MESH_EPOCHS epochs tested at the
    last with ``--storecheckpoint --storemetrics``; its ``--checkpoint
    latest`` resume for CLI_MESH_RESUME_EPOCHS at ``--mesh_data 2
    --mesh_model 2 --multihost``, two torchrun nodes of 2 ranks on
    127.0.0.1 (the model axis, the resume across meshes and the
    multi-host group in one run); ``--gnn gat`` for CLI_GAT_EPOCHS at ``--mesh_data
    SHARDED_RANKS``; ``--model srrl --mesh_data 2`` as phase cli's first
    Srrl run (CLI_SRRL_EPOCHS epochs, ``--storecheckpoint``). This process
    runs the one-rank counterparts of the first run and of the resume
    (from the same checkpoint). Held: one result directory with one
    checkpoint, the resume at the next epoch, every kernel's launches in
    every rank exactly as phase cli counts a run's (Srrl none); the first
    run's loss within CLI_MESH_LOSS_RTOL of the one rank's and its test
    metrics within 2 x the largest std of PARITY.json's rawgnn runs of
    them; the resume's, the GAT run's (against phase cli's GAT run) and
    Srrl's (against phase cli's) losses within CLI_MESH_LOSS_RTOL and
    test metrics equal. Returns the launches summed over the ranks."""
    import json
    import os
    import shutil
    import tempfile

    from ihgnn_torch import cli
    from ihgnn_torch.data.artifacts import write_synthetic_dataset
    from ihgnn_torch.quality_parity import METRICS, QUALITY_SET
    from ihgnn_torch.train.metrics import EpochStats

    parity = json.loads((pathlib.Path(__file__).resolve().parent
                         / "PARITY.json").read_text())["rawgnn"]["runs"]
    limit = {k: 2 * max(float(np.std([r["test"][k] for r in runs]))
                        for runs in parity.values()) for k in METRICS}
    launcher = shutil.which("torchrun")
    launcher = [launcher] if launcher else [sys.executable, "-m",
                                            "torch.distributed.run"]
    tested = ["--epoch_start_test", "1", "--epoch_test_frequency", "1"]
    mesh22 = ["--multihost", "--mesh_data", "2", "--mesh_model", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "quality_ds")
        write_synthetic_dataset(data_dir, **QUALITY_SET)
        results = os.path.join(tmp, "results")
        data = ["--dataset", data_dir]
        one = cli.main(data + ["--result_dir", os.path.join(tmp, "one"),
                               "--epoch_count", str(CLI_MESH_EPOCHS)]
                       + tested)
        # run: (nodes, ranks a node, flags)
        runs = {
            "first": (1, SHARDED_RANKS, [
                "--mesh_data", str(SHARDED_RANKS), "--result_dir", results,
                "--epoch_count", str(CLI_MESH_EPOCHS), "--storecheckpoint",
                "--storemetrics"] + tested),
            "resume_multihost_2x2": (2, 2, mesh22 + [
                "--result_dir", results, "--checkpoint", "latest",
                "--epoch_count", str(CLI_MESH_RESUME_EPOCHS)] + tested),
            "gat": (1, SHARDED_RANKS, [
                "--mesh_data", str(SHARDED_RANKS), "--result_dir",
                os.path.join(tmp, "results_gat"), "--gnn", "gat",
                "--epoch_count", str(CLI_GAT_EPOCHS), "--epoch_start_test",
                "1"]),
            "srrl_mesh_data_2": (1, 2, [
                "--mesh_data", "2", "--model", "srrl", "--result_dir",
                os.path.join(tmp, "results_srrl"), "--epoch_count",
                str(CLI_SRRL_EPOCHS), "--epoch_start_test",
                str(CLI_SRRL_EPOCHS), "--storecheckpoint",
                "--storemetrics"])}
        recs, runs_s = {}, {}
        for name, (nodes, per_node, flags) in runs.items():
            runs_s[name], recs[name] = _torchrun(
                launcher, nodes, per_node, data + flags,
                os.path.join(tmp, f"record_{name}"))
            if name == "first":
                # the one-rank resume from the same checkpoint
                one_resumed = cli.main(data + [
                    "--result_dir", results, "--checkpoint", "latest",
                    "--epoch_count", str(CLI_MESH_RESUME_EPOCHS)] + tested)
        files = {d: sorted(os.listdir(os.path.join(results, d)))
                 for d in sorted(os.listdir(results))}
        srrl_files = [n for d in os.listdir(os.path.join(tmp, "results_srrl"))
                      for n in os.listdir(os.path.join(tmp, "results_srrl",
                                                       d))]

    def last_test(rows):
        return [m for _, m in rows][-1]

    # run: (one rank's epoch stats, its last test row, launches a step and
    # a forward or None for none)
    want = {"first": (one.epoch_stats, [m.as_row() for _, m in
                                        one.iter_epoch_test()][-1],
                      (IHGNN_STEP_LAUNCHES, IHGNN_FORWARD_LAUNCHES)),
            "resume_multihost_2x2": (
                one_resumed.epoch_stats,
                [m.as_row() for _, m in one_resumed.iter_epoch_test()][-1],
                (IHGNN_STEP_LAUNCHES, IHGNN_FORWARD_LAUNCHES)),
            "gat": (None, reference["gat_epoch1_test"],
                    (GAT_STEP_LAUNCHES, GAT_FORWARD_LAUNCHES)),
            "srrl_mesh_data_2": (reference["srrl_stats"],
                                 reference["srrl_test"], None)}
    rows, bad = {}, []
    for name, ranks in recs.items():
        stats = [[EpochStats(**e) for e in rec["epochs"]] for rec in ranks]
        one_stats, one_test, counts = want[name]
        one_losses = ([reference["gat_epoch1_loss"]] if one_stats is None
                      else [st.avg_loss for st in one_stats])
        expected = ({k: 0 for k in _launch_counts()} if counts is None
                    else _cli_expected([(stats[0], counts)]))
        loss_err = max(abs(st.avg_loss - w) / abs(w) for rank in stats
                       for st, w in zip(rank, one_losses))
        test = last_test(ranks[0]["test"])
        diff = {k: test[n] - one_test[n] for n, k in enumerate(METRICS)}
        metrics_ok = (all(abs(diff[k]) <= limit[k] for k in METRICS)
                      if name == "first" else not any(diff.values()))
        epochs = [[st.epoch for st in rank] for rank in stats]
        rows[name] = {
            "nodes": runs[name][0], "ranks_a_node": runs[name][1],
            "flags": runs[name][2][:6], "backend": ranks[0]["backend"],
            "run_s": runs_s[name],
            "epochs": [dataclasses.asdict(st) for st in stats[0]],
            "one_rank_losses": one_losses, "loss_max_rel_err": loss_err,
            "test": test, "one_rank_test": one_test, "metric_diff": diff,
            "launches_rank0": ranks[0]["launches"],
            "expected_launches": expected}
        if not (loss_err <= CLI_MESH_LOSS_RTOL and metrics_ok
                and all(rank["launches"] == expected for rank in ranks)
                and all(e == epochs[0] for e in epochs)):
            bad.append(name)
    (run_dir, names), = files.items()
    checkpoints = [n for n in names if n.startswith("checkpoint_")]
    resumed_epochs = [st["epoch"] for st in
                      rows["resume_multihost_2x2"]["epochs"]]
    emit({"phase": "cli_mesh", "ranks": SHARDED_RANKS,
          "launcher": " ".join(launcher[-2:]), "runs": rows,
          "loss_rtol": CLI_MESH_LOSS_RTOL, "first_metric_limit": limit,
          "files": files, "srrl_files": sorted(srrl_files),
          "resumed_epochs": resumed_epochs, "held": True})
    if bad:
        fail(f"cli_mesh: {bad} differ from one rank's runs")
    if len(checkpoints) != 1 or not checkpoints[0].endswith(
            f"_epoch{CLI_MESH_EPOCHS}"):
        fail(f"cli_mesh: checkpoints {checkpoints} in {run_dir}")
    if len([n for n in names if n.endswith("_metrics.txt")]) != 1:
        fail(f"cli_mesh: metrics files {names} in {run_dir}")
    if resumed_epochs != list(range(CLI_MESH_EPOCHS + 1, CLI_MESH_EPOCHS
                                    + 1 + CLI_MESH_RESUME_EPOCHS)):
        fail(f"cli_mesh: the resume ran epochs {resumed_epochs}")
    if len([n for n in srrl_files if n.startswith("checkpoint_")]) != 1:
        fail(f"cli_mesh: Srrl's files {srrl_files}")
    total = {}
    for ranks in recs.values():
        for rec in ranks:
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
    return total


def _torchrun(launcher, nodes, per_node, argv, record, timeout=600):
    """``ihgnn_torch.cli *argv --run_record record`` in ``nodes`` ×
    ``per_node`` ranks: one ``torchrun --standalone``, or one torchrun a
    node on 127.0.0.1 (``--nnodes``, ``--node_rank``, a free port) as
    across hosts; fails on a non-zero exit. Returns the host seconds and
    every rank's record."""
    import json
    import socket
    if nodes == 1:
        launches = [["--standalone"]]
    else:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = str(sock.getsockname()[1])
        launches = [["--nnodes", str(nodes), "--node_rank", str(k),
                     "--master_addr", "127.0.0.1", "--master_port", port]
                    for k in range(nodes)]
    t0 = time.perf_counter()
    logs = [f"{record}.node{k}.log" for k in range(len(launches))]
    procs = []
    for launch, log in zip(launches, logs):
        with open(log, "w", encoding="utf-8") as f:
            procs.append(subprocess.Popen(
                launcher + launch + ["--nproc_per_node", str(per_node),
                                     "-m", "ihgnn_torch.cli"] + argv
                + ["--run_record", record], stdout=subprocess.DEVNULL,
                stderr=f))
    try:
        for proc in procs:
            proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.terminate()         # torchrun stops its workers
        for proc in procs:
            proc.wait(timeout=60)
        fail(f"cli_mesh: torchrun {argv} outlasted {timeout} s")
    run_s = time.perf_counter() - t0
    for proc, log in zip(procs, logs):
        if proc.returncode != 0:
            fail(f"cli_mesh: torchrun rc {proc.returncode}: "
                 f"{pathlib.Path(log).read_text()[-3000:]}")
    return run_s, [json.loads(pathlib.Path(record, f"rank{n}.json")
                              .read_text())
                   for n in range(nodes * per_node)]


# ---- the model axis: the tables' rows (and their Adam moments) over ranks

# mesh: (model axis, tables over every rank) of SHARDED_RANKS ranks
MODEL_MESHES = {"2x2": (2, False), "1x4": (4, False), "2x2_both": (2, True)}
# the full-width model-axis runs against one rank: f32 features and step-0
# gradients within SHARDED_RTOL of scale, the step-0 loss within this
MODEL_LOSS_RTOL = 1e-6


def _model_case_errors(got, want):
    """Features (absolute), losses (relative), step-0 gradients (of
    ``grad_scale``) and parameters (absolute; score heads apart) of a
    rank-0 result ``got`` against ``want``."""
    params = {k: (got["params"][k] - v).abs().max().item()
              for k, v in want["params"].items()}
    return {"features": (got["features"] - want["features"]).abs().max()
            .item(),
            "loss": max(abs(a - b) / abs(b) for a, b in
                        zip(got["losses"], want["losses"])),
            "grad": max((got["grads0"][k] - g).abs().max().item()
                        / grad_scale(k, want["grads0"])
                        for k, g in want["grads0"].items()),
            "param": max(v for k, v in params.items()
                         if ".feature_aggregate." not in k),
            "head_param": max([v for k, v in params.items()
                               if ".feature_aggregate." in k], default=None)}


def _model_small_jobs():
    """Phase ``sharded_model_small_reference``'s cases and their
    ``TrainJob``s (``check_sharded_small`` runs them in its spawns): the
    default model at (2, 2), (1, 4) and (2, 2) with the rows over every
    rank, bf16 streams over the bf16 wire at (2, 2), per-rank routed packs
    at (2, 2), GAT at (2, 2), on ``sharded_small_reference``'s graphs."""
    from ihgnn_torch.config import ModelConfig, V
    from ihgnn_torch.parallel.ranks import TrainJob

    s = SMALL
    _, uqi = random_graph(s["users"], s["queries"], s["items"],
                          SHARDED_SMALL_EDGES, 95)
    flags = (np.random.default_rng(100).random(len(uqi)) > 0.1).astype(
        np.int64)
    uqif = np.column_stack([uqi, flags])
    qw, qc = random_words(s["queries"], s["vocab"], 96)
    counts = (s["users"], s["queries"], s["items"], s["vocab"])
    bf16 = ModelConfig(bf16_stream=True)
    # case: (mesh, ModelConfig, interactions, TrainJob fields, kernels,
    # per step)
    cases = {
        "2x2": ("2x2", ModelConfig(), uqi, {}, IHGNN_TRAIN,
                IHGNN_STEP_LAUNCHES),
        "1x4": ("1x4", ModelConfig(), uqi, {}, IHGNN_TRAIN,
                IHGNN_STEP_LAUNCHES),
        "2x2_both": ("2x2_both", ModelConfig(), uqi, {}, IHGNN_TRAIN,
                     IHGNN_STEP_LAUNCHES),
        "2x2_bf16": ("2x2", bf16, uqi, {}, IHGNN_TRAIN_BF16,
                     IHGNN_STEP_LAUNCHES_BF16),
        "2x2_routed": ("2x2", ModelConfig(), uqi, {"pack_kernels": True},
                       ROUTED_TRAIN, ROUTED_STEP_LAUNCHES),
        "2x2_gat": ("2x2", ModelConfig(gnn=V.GAT), uqif, {}, GAT_TRAIN,
                    GAT_STEP_LAUNCHES)}
    jobs = []
    for name, (mesh, cfg, inter, fields, _, _) in cases.items():
        model, both = MODEL_MESHES[mesh]
        batches = [train_batch(inter, s["items"], SMALL_B, TRAIN_K, 97 + k)
                   for k in range(SMALL_STEPS)]
        jobs.append(TrainJob(name, cfg, counts, inter, qw, qc, batches,
                             seed=98, keep_state=True, keep_features=True,
                             model_axis=model, table_shard_both=both,
                             **fields))
    return cases, jobs


def _check_model_small(cases, card, cpu, one, card_s):
    """Phase ``sharded_model_small_reference`` (``_model_small_jobs``'
    cases; ``card``, ``cpu``: ``[rank][case]`` results of SHARDED_RANKS
    gloo ranks on the card and on the CPU, plain twins; ``one``: one rank
    on the card). Held as ``sharded_small_reference`` holds its cases
    (the SMALL_* limits card against CPU, bf16 BF16_SMALL_TOL's;
    SHARDED_RTOL of scale against one rank on the card, bf16
    BF16_FEATURE_RTOL and ROUTED_BF16_LOSS_RTOL; the one-device
    parameters of every rank bit for bit; every kernel of the path
    launched in every rank, exactly; every step's collectives exactly).
    Returns the launches summed over the card's ranks, by case."""
    failed, launches = [], {}
    for j, (name, (mesh, cfg, _, fields, expected, per_step)) in enumerate(
            cases.items()):
        model, both = MODEL_MESHES[mesh]
        _check_rank_counts(f"sharded_model_small_reference {name}", card, j,
                           expected, per_step, SMALL_STEPS)
        _check_collectives(f"sharded_model_small_reference {name}", card, j,
                           expected_collectives(cfg, SHARDED_RANKS // model,
                                                model, both))
        launches[name] = _sum_counts(card, j)
        got, want, single = card[0][j], cpu[0][j], one[j]
        vs_cpu = _model_case_errors(got, want)
        vs_one = _model_case_errors(got, single)
        scale = single["features"].abs().max().item()
        if cfg.bf16_stream:
            tol = dict(BF16_SMALL_TOL)
            one_feat, one_loss = BF16_FEATURE_RTOL, ROUTED_BF16_LOSS_RTOL
        else:
            tol = dict(feature_atol=SMALL_FEATURE_ATOL,
                       loss_rtol=SMALL_LOSS_RTOL, grad_rtol=SMALL_GRAD_RTOL,
                       param_atol=SMALL_PARAM_ATOL)
            one_feat = one_loss = SHARDED_RTOL
        replicas = {"card": len({r[j]["digest"] for r in card}) == 1,
                    "cpu": len({r[j]["digest"] for r in cpu}) == 1}
        ok = (vs_cpu["features"] <= tol["feature_atol"]
              and vs_cpu["loss"] <= tol["loss_rtol"]
              and vs_cpu["grad"] <= tol["grad_rtol"]
              and vs_cpu["param"] <= tol["param_atol"]
              and vs_one["features"] <= one_feat * scale
              and vs_one["loss"] <= one_loss
              and vs_one["grad"] <= one_feat and all(replicas.values()))
        emit({"phase": "sharded_model_small_reference", "case": name,
              "mesh": {"data": SHARDED_RANKS // model, "model": model,
                       "table_shard_both": both},
              "ranks": SHARDED_RANKS, "backend": got["backend"],
              "streams": "bf16" if cfg.bf16_stream else "f32",
              "pack_kernels": fields.get("pack_kernels", False),
              "edges": SHARDED_SMALL_EDGES, "steps": SMALL_STEPS,
              "card_ranks_s": card_s, "vs_cpu_ranks": vs_cpu,
              "vs_cpu_limits": tol,
              "vs_one_rank_card": dict(vs_one, features=vs_one["features"]
                                       / scale),
              "state_bytes_a_rank": [r[j]["state_bytes"] for r in card],
              "one_rank_state_bytes": single["state_bytes"],
              "replicas_equal": replicas, "card_losses": got["losses"],
              "launches_rank0": got["launches"], "held": True})
        if not ok:
            failed.append(name)
    if failed:
        fail(f"sharded_model_small_reference: {failed} disagree")
    return launches


def run_sharded_model_train(torch, dev, uqi, qw, qc):
    """Phase ``sharded_model_train``: the default model at full width
    (``bench.py``'s graph, E = 2M, d = 32) in SHARDED_RANKS gloo ranks
    sharing the card, the tables' rows (89.6 MB) and their Adam moments
    over the model axis: (2, 2), (1, 4) and (2, 2) with the rows over
    every rank on f32 streams, (2, 2) on bf16 streams over the bf16 wire;
    SHARDED_WARM + SHARDED_TIMED steps against one rank on the card on the
    same graph, weights and batches. Held: the features before the first
    step and every step-0 gradient (the tables' assembled from the
    ranks' blocks) within SHARDED_RTOL of scale, the step-0 loss within
    MODEL_LOSS_RTOL (bf16: BF16_FEATURE_RTOL and ROUTED_BF16_LOSS_RTOL);
    every rank's one-device parameters equal bit for bit; every kernel of
    the path launched in every rank, exactly a step's count times the
    steps; every step's collectives exactly. Reported: each rank's step
    time, its collectives and among them the tables' gathers and their
    gradients' sums, peak memory and persistent parameter and Adam bytes
    a rank (one rank's, as every rank of ``sharded_train`` holds them).
    Returns ``(jobs, finish)`` as ``check_sharded_small`` does; ``finish``
    returns the launches summed over the ranks, by mesh."""
    from ihgnn_torch.config import ModelConfig
    from ihgnn_torch.parallel.ranks import TrainJob

    steps = SHARDED_WARM + SHARDED_TIMED
    batches = [train_batch(uqi, I, TRAIN_B, TRAIN_K, 500 + k)
               for k in range(steps)]
    ihgnn = ModelConfig()
    ihgnn16 = dataclasses.replace(ihgnn, bf16_stream=True)
    # path: (mesh, ModelConfig, kernels, per step)
    paths = {"2x2": ("2x2", ihgnn, IHGNN_TRAIN, IHGNN_STEP_LAUNCHES),
             "1x4": ("1x4", ihgnn, IHGNN_TRAIN, IHGNN_STEP_LAUNCHES),
             "2x2_both": ("2x2_both", ihgnn, IHGNN_TRAIN,
                          IHGNN_STEP_LAUNCHES),
             "2x2_bf16": ("2x2", ihgnn16, IHGNN_TRAIN_BF16,
                          IHGNN_STEP_LAUNCHES_BF16)}

    def job(name, cfg, mesh=None):
        model, both = MODEL_MESHES[mesh] if mesh else (1, False)
        return TrainJob(name, cfg, (U, Q, I, VOCAB), uqi, qw, qc, batches,
                        seed=0, keep_state=True, keep_features=True,
                        time_steps=SHARDED_TIMED, model_axis=model,
                        table_shard_both=both)

    jobs = [job(name, cfg, mesh) for name, (mesh, cfg, _, _) in paths.items()]
    ones = [job("one_f32", ihgnn), job("one_bf16", ihgnn16)]
    return jobs, lambda ranks, ranks_s: _finish_sharded_model_train(
        paths, ones, steps, batches, ranks, ranks_s)


def _finish_sharded_model_train(paths, ones, steps, batches, ranks,
                                ranks_s):
    """The second half of ``run_sharded_model_train`` (``ranks``: the
    card ranks' results of its jobs; ``ones``: the one-rank f32 and bf16
    jobs)."""
    from ihgnn_torch.parallel.ranks import run_jobs

    one = dict(zip(("f32", "bf16"), run_jobs(0, ones, "cuda")[0]))
    launches, failed = {}, []
    for j, (name, (mesh, cfg, expected, per_step)) in enumerate(
            paths.items()):
        model, both = MODEL_MESHES[mesh]
        path = f"sharded_model_train_{name}"
        _check_rank_counts(path, ranks, j, expected, per_step, steps)
        _check_collectives(path, ranks, j, expected_collectives(
            cfg, SHARDED_RANKS // model, model, both))
        launches[path] = _sum_counts(ranks, j)
        bf16 = cfg.bf16_stream
        got, single = ranks[0][j], one["bf16" if bf16 else "f32"]
        err = _model_case_errors(got, single)
        scale = single["features"].abs().max().item()
        rtol = BF16_FEATURE_RTOL if bf16 else SHARDED_RTOL
        loss_err = abs(got["losses"][0] - single["losses"][0]) \
            / abs(single["losses"][0])
        loss_tol = ROUTED_BF16_LOSS_RTOL if bf16 else MODEL_LOSS_RTOL
        replicas = len({r[j]["digest"] for r in ranks}) == 1
        finite = all(np.isfinite(r[j]["losses"]).all() for r in ranks)
        med = lambda key: [float(np.median(r[j][key])) for r in ranks]
        emit({"phase": "sharded_model_train", "path": name,
              "mesh": {"data": SHARDED_RANKS // model, "model": model,
                       "table_shard_both": both},
              "streams": "bf16" if bf16 else "f32", "bf16_wire": bf16,
              "ranks": SHARDED_RANKS, "backend": got["backend"],
              "note": ("the ranks share one card: not a multi-card time"
                       if got["backend"] == "gloo" else "a card a rank"),
              "edges_a_rank": E // (SHARDED_RANKS // model),
              "rows_a_rank": len(batches[0].users) // (SHARDED_RANKS
                                                        // model),
              "steps": steps, "timed_steps": SHARDED_TIMED,
              "rank_step_ms_median": med("step_ms"),
              "rank_collective_ms_median": med("collective_ms"),
              "rank_table_collective_ms_median":
                  med("table_collective_ms"),
              "rank_step_ms": [r[j]["step_ms"] for r in ranks],
              "rank_collective_ms": [r[j]["collective_ms"] for r in ranks],
              "rank_table_collective_ms": [r[j]["table_collective_ms"]
                                           for r in ranks],
              "max_memory_allocated_bytes": [
                  r[j].get("max_memory_allocated_bytes") for r in ranks],
              "one_rank_max_memory_allocated_bytes":
                  single.get("max_memory_allocated_bytes"),
              "state_bytes_a_rank": [r[j]["state_bytes"] for r in ranks],
              "sharded_train_state_bytes_a_rank": single["state_bytes"],
              "graph_s": [r[j]["graph_s"] for r in ranks],
              "ranks_run_s": ranks_s, "losses": got["losses"],
              "one_rank_losses": single["losses"],
              "features_max_abs_err": err["features"],
              "features_scale": scale, "features_rtol": rtol,
              "grad0_rel_err_max": err["grad"], "grad_rtol": rtol,
              "step0_loss_rel_err": loss_err, "loss_rtol": loss_tol,
              "param_max_abs_err": err["param"], "replicas_equal": replicas,
              "launches_rank0": got["launches"], "held": True})
        if not (err["features"] <= rtol * scale and err["grad"] <= rtol
                and loss_err <= loss_tol and replicas and finite):
            failed.append(name)
    if failed:
        fail(f"sharded_model_train: {failed} disagree with one rank")
    return launches


def run_dryrun(torch, dev):
    """Phase ``dryrun``: ``ihgnn_torch.entry``'s ``entry()`` forward on
    the card, then ``dryrun_multichip(SHARDED_RANKS)``: one train step of
    the tiny model at mesh (2, 2) in gloo ranks sharing the card, the
    tables' rows over ``model``, each rank's slice with its routed pack.
    Held: finite scores, a finite loss, every rank launched K1 and the
    same kernels as the other rank of its data index, and the step's
    collectives exactly. Returns the launches summed over the ranks."""
    from ihgnn_torch.entry import dryrun_multichip, entry

    t0 = time.perf_counter()
    fn, args = entry()
    scores = fn(*args)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = dryrun_multichip(SHARDED_RANKS)
    dryrun_s = time.perf_counter() - t0
    from ihgnn_torch.config import ModelConfig
    _check_collectives("dryrun", ranks, 0, expected_collectives(
        ModelConfig(), SHARDED_RANKS // 2, 2))
    launches = [r[0]["launches"] for r in ranks]
    emit({"phase": "dryrun", "entry_scores": list(scores.shape),
          "entry_s": entry_s, "dryrun_s": dryrun_s,
          "mesh": {"data": SHARDED_RANKS // 2, "model": 2},
          "backend": ranks[0][0]["backend"],
          "losses": [r[0]["losses"][0] for r in ranks],
          "launches": launches, "held": True})
    if not torch.isfinite(scores).all():
        fail("dryrun: entry() gave non-finite scores")
    if not all(np.isfinite(r[0]["losses"]).all() for r in ranks):
        fail(f"dryrun: losses {[r[0]['losses'] for r in ranks]}")
    if not all(c["csr_gather_sum"] > 0 for c in launches) or any(
            launches[r] != launches[r ^ 1] for r in range(len(launches))):
        fail(f"dryrun: launches {launches}")
    return _sum_counts(ranks, 0)


# ---- Srrl and preprocessing: no hand-written kernel runs on these paths

# Srrl train phase: KG steps of 1024 positives x 10 negatives, one warm
# step a mode, then SRRL_KG_TIMED; PS steps as the train phases take them
SRRL_KG_WARM, SRRL_KG_TIMED = 3, 12
# the CIKM-shaped raw files of the preprocess phase (synth_cikm's seed 3)
CIKM_SMALL = dict(users=200, products=600, sessions=12, categories=20)
AMAZON_SMALL = dict(items=300, users=120, reviews_per_user=8)


def _no_launches(path):
    """The launch counts since ``_zero_launches``; fails unless every one is
    0 (Srrl runs no hand-written kernel)."""
    launches = _launch_counts()
    if any(launches.values()):
        fail(f"{path}: a kernel was launched on a path that runs none: "
             f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def srrl_data(uqi, qw, qc):
    """A ``GraphData`` of one single-positive log an interaction of the
    seeded 2M draw, and its build's host seconds."""
    from ihgnn_torch.data.collections import SearchLogCollection
    from ihgnn_torch.data.dataset import GraphData
    from ihgnn_torch.data.schema import SearchLog
    t0 = time.perf_counter()
    logs = SearchLogCollection(
        SearchLog(u, q, "t", [i], [1], [0], [1], ["t"])
        for u, q, i in uqi.tolist())
    return GraphData(U, Q, I, VOCAB, qw, qc, logs), time.perf_counter() - t0


def _srrl_model(torch, dev, cfg, seed=0):
    from ihgnn_torch.models.srrl import Srrl
    return Srrl(cfg.model, U, Q, I, VOCAB,
                generator=torch.Generator().manual_seed(seed)).to(dev)


def run_srrl_serving(torch, dev, data):
    """Phase ``srrl_serving``: ``Srrl`` (the MLP scorer, d = 32, seeded
    weights) at full width: ``all_features`` (its second call, then
    FEATURE_REPEATS warm calls), then ``evaluate`` over the serving logs in
    ``run_srrl``'s eval batch (2^27 / (I · 2d) = 5 rows here), and one
    eval batch under ``torch.profiler``."""
    from ihgnn_torch.config import Config
    from ihgnn_torch.train.eval import evaluate
    from ihgnn_torch.train.srrl_loop import (eval_batch_size,
                                             make_eval_fns_srrl)

    cfg = Config()
    model = _srrl_model(torch, dev, cfg)
    model.eval()
    logs = random_eval_logs(U, Q, I, EVAL_LOGS, seed=2)
    batch = eval_batch_size(cfg, I)
    features_fn, metrics_fn = make_eval_fns_srrl(model, data, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.perf_counter()
    features = features_fn()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    features = features_fn()
    torch.cuda.synchronize()
    features_ms = (time.perf_counter() - t0) * 1e3
    metrics, rows, eval_s = evaluate(features_fn, metrics_fn, logs, batch,
                                     collect_rows=True, features=features)
    launches = _no_launches("srrl_serving")
    repeats = time_features(torch, features_fn)
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(features.shape) != (U + Q + I, D) or \
            not torch.isfinite(features).all():
        fail(f"srrl_serving: bad features {tuple(features.shape)}")
    row = metrics.as_row()
    if rows.shape != (logs.count, 4) or not np.isfinite(rows).all() \
            or not all(0.0 <= v <= 1.0 for v in row):
        fail(f"srrl_serving: bad metrics {row}")
    users, queries, truth, counts, _ = next(logs.batches(batch))
    profile = profile_window(
        torch, f"one Srrl eval batch of {batch}",
        lambda: metrics_fn(features, users, queries, truth, counts).cpu())
    emit({"phase": "srrl_serving", "model": "srrl", "prediction": "mlp",
          "d": D, "nodes": U + Q + I, "first_features_ms": first_ms,
          "features_ms": features_ms, **repeats, "eval_logs": logs.count,
          "eval_batch": batch, "eval_batches": -(-logs.count // batch),
          "item_chunk": 8192, "eval_s": eval_s,
          "eval_pairs_per_s": logs.count / eval_s,
          "metrics": dict(zip(["HR@10", "NDCG@10", "MAP@10", "MRR@10"],
                              row)),
          "max_memory_allocated_bytes": peak,
          "eval_batch_device_idle_share": profile.get("device_idle_share"),
          "launches": launches})
    emit(profile)


def run_srrl_train(torch, dev, data, uqi):
    """Phase ``srrl_train``: ``MetaPaths`` over the 2M positives, the KG
    sampler's batches (1024 x 10, drawn ahead and timed alone),
    SRRL_KG_WARM warm KG steps (one a mode) and SRRL_KG_TIMED timed ones,
    each timed by CUDA events (``kg_step_ms``: from its first to its last
    operation on the stream, which the host's pace sets when it issues
    slower than the card runs) and by the host's issue; then PS steps as
    ``run_train`` times them; a KG step with its sampling and a PS step
    under ``torch.profiler``, whose rows give the device's busy time."""
    from ihgnn_torch.config import Config, TrainConfig
    from ihgnn_torch.data.srrl_sampler import MetaPaths, SrrlKGSampler
    from ihgnn_torch.train.srrl_loop import (make_kg_steps, make_optimizer,
                                             make_ps_step)

    cfg = Config(train=TrainConfig(batch_size=TRAIN_B,
                                   random_negative_sample_size=TRAIN_K))
    t0 = time.perf_counter()
    meta = MetaPaths(data)
    meta_s = time.perf_counter() - t0
    sampler = SrrlKGSampler(meta, TRAIN_B, TRAIN_K, seed=0)
    t0 = time.perf_counter()
    kg_batches = [sampler.next() for _ in range(SRRL_KG_WARM
                                                + SRRL_KG_TIMED)]
    sample_ms = (time.perf_counter() - t0) * 1e3 / len(kg_batches)
    model = _srrl_model(torch, dev, cfg)
    opt = make_optimizer(model, cfg.train.learning_rate)
    kg_steps = make_kg_steps(model, data.query_words, data.query_word_counts,
                             opt, cfg, dev)
    ps_step = make_ps_step(model, data.query_words, data.query_word_counts,
                           opt, cfg, dev)
    ps_batches = [train_batch(uqi, I, TRAIN_B, TRAIN_K, seed)
                  for seed in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    kg_losses = [kg_steps[m](*a) for m, *a in kg_batches[:SRRL_KG_WARM]]
    torch.cuda.synchronize()
    events, issue = [], []
    t0 = time.perf_counter()
    for mode, *arrays in kg_batches[SRRL_KG_WARM:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        kg_losses.append(kg_steps[mode](*arrays))
        end.record()
        issue.append((time.perf_counter() - t1) * 1e3)
        events.append((mode, start, end))
    torch.cuda.synchronize()
    kg_wall_ms = (time.perf_counter() - t0) * 1e3 / SRRL_KG_TIMED
    by_mode = {}
    for mode, start, end in events:
        by_mode.setdefault(mode, []).append(start.elapsed_time(end))
    ps_losses = [ps_step(ps_batches[k % 4]) for k in range(WARM_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(TIMED_STEPS):
        ps_losses.append(ps_step(ps_batches[(WARM_STEPS + k) % 4]))
    ps_issue_s = (time.perf_counter() - t0) / TIMED_STEPS
    torch.cuda.synchronize()
    ps_step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = _no_launches("srrl_train")
    peak = torch.cuda.max_memory_allocated(dev)
    kg_losses = [x.item() for x in kg_losses]
    ps_losses = [x.item() for x in ps_losses]
    if not all(np.isfinite(kg_losses + ps_losses)):
        fail(f"srrl_train: non-finite losses {kg_losses} {ps_losses}")

    def kg_step_with_sampling():
        mode, *arrays = sampler.next()
        kg_steps[mode](*arrays)

    kg_profile = profile_window(torch, "one Srrl KG step with its sampling",
                                kg_step_with_sampling)
    ps_profile = profile_window(torch, "one Srrl PS step",
                                lambda: ps_step(ps_batches[0]))
    emit({"phase": "srrl_train", "model": "srrl", "d": D,
          "positives": len(uqi), "meta_s": meta_s,
          "kg_sample_ms": sample_ms, "rows_kg": [TRAIN_B, TRAIN_K],
          "rows_ps": TRAIN_B * (1 + TRAIN_K),
          "kg_warm_steps": SRRL_KG_WARM, "kg_timed_steps": SRRL_KG_TIMED,
          "kg_step_ms": {m: float(np.median(v)) for m, v in by_mode.items()},
          "kg_step_device_ms": by_mode, "kg_step_wall_ms": kg_wall_ms,
          "kg_host_issue_ms": float(np.median(issue)),
          "ps_warm_steps": WARM_STEPS, "ps_timed_steps": TIMED_STEPS,
          "ps_step_ms": ps_step_s * 1e3, "host_issue_ms": ps_issue_s * 1e3,
          "kg_losses": kg_losses, "ps_losses": ps_losses,
          "max_memory_allocated_bytes": peak,
          "kg_with_sampling_device_idle_share":
              kg_profile.get("device_idle_share"),
          "ps_device_idle_share": ps_profile.get("device_idle_share"),
          "launches": launches})
    emit(kg_profile)
    emit(ps_profile)


def check_small_srrl(torch, dev):
    """Phase ``small_srrl_reference``: on a small split, the tail, head and
    query KG steps then 3 PS steps on the card and on the CPU from the same
    weights and batches: the losses, every gradient of the first KG and
    the first PS step (the zero gradients of the KG heads a mode leaves
    unused included) and the parameters after the last step."""
    import copy

    from ihgnn_torch.config import Config, ModelConfig, TrainConfig
    from ihgnn_torch.data.dataset import TrainSampler
    from ihgnn_torch.data.srrl_sampler import MetaPaths, SrrlKGSampler
    from ihgnn_torch.data.synthetic import make_synthetic_data
    from ihgnn_torch.models.srrl import Srrl
    from ihgnn_torch.train.srrl_loop import (make_kg_steps, make_optimizer,
                                             make_ps_step)

    s = SMALL
    data = make_synthetic_data(user_count=s["users"], query_count=s["queries"],
                               item_count=s["items"], vocab_size=s["vocab"],
                               log_count=s["edges"], seed=11)
    cfg = Config(model=ModelConfig(), train=TrainConfig(
        batch_size=SMALL_B, random_negative_sample_size=TRAIN_K))
    model = Srrl(cfg.model, data.user_count, data.query_count,
                 data.item_count, data.vocab_size,
                 generator=torch.Generator().manual_seed(12))
    sampler = SrrlKGSampler(MetaPaths(data), SMALL_B, TRAIN_K, seed=13)
    kg_batches = [sampler.next() for _ in range(3)]
    ps_batches = list(TrainSampler(data, SMALL_B, TRAIN_K,
                                   seed=13).epoch())[:SMALL_STEPS]

    def grads(m):
        return {k: None if p.grad is None else p.grad.detach().cpu().clone()
                for k, p in m.named_parameters()}

    def train(device):
        m = copy.deepcopy(model).to(device)
        opt = make_optimizer(m, cfg.train.learning_rate)
        kg_steps = make_kg_steps(m, data.query_words, data.query_word_counts,
                                 opt, cfg, device)
        ps_step = make_ps_step(m, data.query_words, data.query_word_counts,
                               opt, cfg, device)
        losses, step0 = [], {}
        for k, (mode, *arrays) in enumerate(kg_batches):
            losses.append(kg_steps[mode](*arrays).item())
            if k == 0:
                step0["kg"] = grads(m)
        for k, b in enumerate(ps_batches):
            losses.append(ps_step(b).item())
            if k == 0:
                step0["ps"] = grads(m)
        return losses, step0, {k: v.detach().cpu()
                               for k, v in m.state_dict().items()}

    cpu_losses, cpu_grads, cpu_params = train("cpu")
    card_losses, card_grads, card_params = train(dev)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                       cpu_losses))
    grad_err, unused = {}, {}
    for phase in ("kg", "ps"):
        for k, g in cpu_grads[phase].items():
            c = card_grads[phase][k]
            if (g is None) != (c is None):
                fail(f"small_srrl_reference: {phase} gradient of {k}: "
                     f"card {c is None}, CPU {g is None}")
            if g is None:
                continue
            scale = max(g.abs().max().item(), 1e-30)
            grad_err[f"{phase}:{k}"] = (c - g).abs().max().item() / scale
            if not g.abs().max().item():
                unused[f"{phase}:{k}"] = c.abs().max().item()
    param_err = max((card_params[k] - v).abs().max().item()
                    for k, v in cpu_params.items())
    heads = {"kg:kg_aggre_head.fc.weight", "kg:kg_aggre_query.fc.weight"}
    bad_grads = {k: v for k, v in grad_err.items()
                 if not v <= SMALL_GRAD_RTOL}
    ok = (loss_err <= SMALL_LOSS_RTOL and not bad_grads
          and param_err <= SMALL_PARAM_ATOL and heads <= set(unused)
          and not any(unused.values()))
    emit({"phase": "small_srrl_reference",
          "steps": [b[0] for b in kg_batches] + ["ps"] * len(ps_batches),
          "card_losses": card_losses, "cpu_losses": cpu_losses,
          "loss_max_rel_err": loss_err, "loss_rtol": SMALL_LOSS_RTOL,
          "grad0_rel_err": grad_err, "grad0_rtol": SMALL_GRAD_RTOL,
          "zero_grads_card_max_abs": unused,
          "param_max_abs_err": param_err, "param_atol": SMALL_PARAM_ATOL})
    if not ok:
        fail("card and CPU Srrl training disagree on the small split")


def write_amazon_fixture(root, items, users, reviews_per_user, seed=0):
    """Amazon-shaped metadata and review JSON lines under ``root``;
    returns their paths."""
    import os
    import random
    rng = random.Random(seed)
    cats = [["Electronics", "Home Audio"], ["Electronics", "Cameras"],
            ["Books", "Science Fiction"], ["Books", "History"],
            ["Clothing", "Running Shoes"], ["Home", "Kitchen Gadgets"]]
    meta, reviews = (os.path.join(root, "meta.json"),
                     os.path.join(root, "reviews.json"))
    with open(meta, "w", encoding="utf-8") as f:
        for i in range(items):
            f.write(json.dumps({"asin": f"I{i:05d}",
                                "category": rng.choice(cats)}) + "\n")
    with open(reviews, "w", encoding="utf-8") as f:
        for u in range(users):
            for r in range(reviews_per_user):
                f.write(json.dumps({
                    "reviewerID": f"U{u:05d}",
                    "asin": f"I{rng.randrange(items):05d}",
                    "unixReviewTime": 1500000000 + u * 1000 + r}) + "\n")
    return meta, reviews


def run_preprocess(torch, dev):
    """Phase ``preprocess``: the port's CIKM writer at CIKM_SMALL through
    Steps 1 and 3, then one tested CLI epoch of the default model on the
    card from those artifacts (launches exact); the Amazon fixture through
    the three module CLIs (Steps 1, 2 with a 2-core item filter, 3). Host
    seconds of each step. Returns the CLI epoch's launches."""
    import os
    import random
    import tempfile

    from ihgnn_torch import cli
    from ihgnn_torch.data.dataset import GraphData
    from ihgnn_torch.data.preprocess import amazon, onehot, subset
    from ihgnn_torch.data.preprocess.synth_cikm import make_cikm_set
    from ihgnn_torch.data.preprocess.text import TextPreprocessor

    with tempfile.TemporaryDirectory() as tmp:
        cikm_dir = os.path.join(tmp, "cikm_ds")
        cikm_s = make_cikm_set(cikm_dir, **CIKM_SMALL)
        with open(os.path.join(cikm_dir, "graph_info.txt")) as f:
            cikm_counts = [int(x) for x in f.read().split()]
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        mc = cli.main(["--dataset", cikm_dir, "--result_dir",
                       os.path.join(tmp, "results"), "--epoch_count", "1",
                       "--epoch_start_test", "1"])
        cli_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _launch_counts()

        meta, reviews = write_amazon_fixture(tmp, **AMAZON_SMALL)
        amazon_s = {}
        t0 = time.perf_counter()
        amazon.main(["--item", meta, "--search", reviews, "--result",
                     os.path.join(tmp, "inter")])
        amazon_s["step1_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        subset.main(["--source", os.path.join(tmp, "inter"), "--result",
                     os.path.join(tmp, "sub"), "--nitem", "2"])
        amazon_s["step2_s"] = time.perf_counter() - t0
        random.seed(0)
        t0 = time.perf_counter()
        onehot.main(["--source", os.path.join(tmp, "sub"), "--result",
                     os.path.join(tmp, "amazon_ds")])
        amazon_s["step3_s"] = time.perf_counter() - t0
        amazon_data = GraphData.from_files(os.path.join(tmp, "amazon_ds"))
    expected = _cli_expected([(mc.epoch_stats, (IHGNN_STEP_LAUNCHES,
                                                IHGNN_FORWARD_LAUNCHES))])
    metrics = [(e, m.as_row(), v.as_row())
               for e, m, v in mc.iter_epoch_test_valid()]
    emit({"phase": "preprocess", "cikm": {**CIKM_SMALL, **cikm_s,
                                          "graph_info": cikm_counts},
          "cikm_cli_s": cli_s,
          "cikm_epochs": [dataclasses.asdict(s) for s in mc.epoch_stats],
          "cikm_metrics": metrics,
          "amazon": {**AMAZON_SMALL, **amazon_s,
                     "positives": amazon_data.pos_count,
                     "counts": [amazon_data.user_count,
                                amazon_data.query_count,
                                amazon_data.item_count,
                                amazon_data.vocab_size]},
          "text_preprocess_sample": TextPreprocessor().preprocess(
              "The Running Shoes 42 (Blue)!"),
          "launches": launches, "expected_launches": expected})
    if launches != expected:
        fail(f"preprocess: kernel launches {launches}, expected {expected}")
    if not metrics or not all(0.0 <= x <= 1.0 for _, m, v in metrics
                              for x in m + v) or \
            not np.isfinite(mc.epoch_stats[0].avg_loss):
        fail(f"preprocess: bad CIKM epoch {metrics} {mc.epoch_stats}")
    if amazon_data.pos_count <= 0:
        fail("preprocess: the Amazon artifacts hold no positive")
    return launches


def _same_state(torch, a, b):
    """Whether two (state_dict, optimizer state_dict) snapshots are equal
    bit for bit, the learning rate included."""
    (params, opt), (r_params, r_opt) = a, b
    if params.keys() != r_params.keys() or \
            opt["param_groups"] != r_opt["param_groups"] or \
            opt["state"].keys() != r_opt["state"].keys():
        return False
    return (all(torch.equal(params[k], r_params[k]) for k in params)
            and all(state.keys() == r_opt["state"][k].keys()
                    and all(torch.equal(v, r_opt["state"][k][n])
                            for n, v in state.items())
                    for k, state in opt["state"].items()))


def features_only(torch, root: str) -> None:
    """``--features ROOT``: the serving forward of the direct and routed
    paths, f32 and on bf16 streams, at full width with the port of the
    checkout at ROOT, timed as
    ``run_serving`` times it (the second call, then FEATURE_REPEATS warm
    calls), and the host time of each graph's build. It reads only what
    every slice of the port has, so one call can time two checkouts on one
    card. Prints one JSON line; checks nothing."""
    sys.path.insert(0, root)
    from ihgnn_torch.config import ModelConfig
    from ihgnn_torch.graph import build_hypergraph
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.ops import _build, native
    from ihgnn_torch.train.eval import make_eval_fns

    _build.build()
    native.load()
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    graph_cpu, uqi = random_graph(U, Q, I, E, seed=0)
    build_s = {"direct": time.perf_counter() - t0}
    t0 = time.perf_counter()
    routed_cpu = build_hypergraph(uqi, U + Q + I, U, Q, pack_kernels=True)
    build_s["routed"] = time.perf_counter() - t0
    qw, qc = random_words(Q, VOCAB, seed=1)
    out = {"phase": "features", "root": root,
           "package": str(sys.modules["ihgnn_torch"].__file__),
           "graph_build_s": build_s}
    for path, graph_cpu, bf16 in (
            ("direct", graph_cpu, False), ("routed", routed_cpu, False),
            ("direct_bf16", graph_cpu, True),
            ("routed_bf16", routed_cpu, True)):
        model = RawGnn(ModelConfig(bf16_stream=bf16), U, Q, I, VOCAB,
                       generator=torch.Generator().manual_seed(0)).to(dev)
        model.eval()
        features_fn, _ = make_eval_fns(model, graph_cpu, qw, qc, device=dev)
        features_fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        features_fn()
        torch.cuda.synchronize()
        out[path] = {"features_ms": (time.perf_counter() - t0) * 1e3,
                     **time_features(torch, features_fn)}
        del model, features_fn
    emit(out)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--features"]:
        features_only(torch, sys.argv[2] if len(sys.argv) > 2 else
                      str(pathlib.Path(__file__).resolve().parent))
        return 0
    from ihgnn_torch.ops import _build
    if sys.argv[1:2] == ["--k1_skew"]:
        _build.build(("segsum",))
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "nvidia_smi": subprocess.run(
                  ["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], capture_output=True, text=True,
                  timeout=60).stdout.strip()})
        with torch.no_grad():
            k1_skew_row(torch, torch.device("cuda"), {})
        return 0

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi rc {smi.returncode}: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi.stdout.strip(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from ihgnn_torch.ops import native
    t0 = time.perf_counter()
    reference = None
    if sys.argv[1:2] == ["--reference"]:
        # ROOT's builds, their nvcc processes beside this checkout's
        import threading
        from ihgnn_torch.compare_builds import build_pair
        reference = {}
        ref_build = threading.Thread(target=lambda: reference.update(
            build_pair(pathlib.Path(sys.argv[2]), REFERENCE_STEMS,
                       tags=("reference",))))
        ref_build.start()
    libs = _build.build()
    native.load()        # g++: the routed pack's router
    if reference is not None:
        ref_build.join()
        if len(reference) != len(REFERENCE_STEMS):
            fail(f"the reference build of {sys.argv[2]} failed")
        REFERENCE.update({stem: lib for (_, stem), lib in reference.items()})
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(p.relative_to(_build.PACKAGE.parent))
                        for p in (*libs.values(), native.library_path())],
          "reference": sys.argv[2] if reference is not None else None})
    t0 = time.perf_counter()
    graph_cpu, uqi = random_graph(U, Q, I, E, seed=0)
    direct_s = time.perf_counter() - t0
    qw, qc = random_words(Q, VOCAB, seed=1)
    from ihgnn_torch.config import ModelConfig, V
    from ihgnn_torch.graph import build_graph2d, build_hypergraph
    from ihgnn_torch.models.embedding import make_word_bag
    graph = graph_cpu.to(dev)
    bag = make_word_bag(qw, qc, VOCAB + 1).to(dev)
    hyper_s = time.perf_counter() - t0
    # the same interactions with the routed pack
    t0 = time.perf_counter()
    routed_cpu = build_hypergraph(uqi, U + Q + I, U, Q, pack_kernels=True)
    routed_s = time.perf_counter() - t0
    kp = routed_cpu.kp
    emit({"phase": "routed_data", "build_s": routed_s,
          "unpacked_build_s": direct_s, "pack_s": routed_s - direct_s,
          "grid": [kp.rows, kp.cols], "e_pad": kp.e_pad,
          "sigma_pads": kp.e_pad - kp.edge_count,
          "node_update_entries": int(kp.seg_col.numel())})
    # the uqi 2D graph of the same interactions, flags 1
    t0 = time.perf_counter()
    graph2d_cpu = build_graph2d(np.column_stack([uqi, np.ones(len(uqi),
                                                              np.int64)]),
                                U + Q + I, U, Q, completeness=V.GRAPH_UQI)
    graph2d_s = time.perf_counter() - t0
    graph2d = graph2d_cpu.to(dev)
    # the same 2D graph with its routed packs (pk_role, gat_pk)
    t0 = time.perf_counter()
    graph2d_routed_cpu = build_graph2d(
        np.column_stack([uqi, np.ones(len(uqi), np.int64)]), U + Q + I, U, Q,
        completeness=V.GRAPH_UQI, pack_kernels=True)
    graph2d_routed_s = time.perf_counter() - t0
    rp, gat_pk = graph2d_routed_cpu.pk_role, graph2d_routed_cpu.gat_pk
    if rp is None or gat_pk is None:
        fail("the bench 2D graph did not pack")
    emit({"phase": "routed_2d_data", "build_s": graph2d_routed_s,
          "unpacked_build_s": graph2d_s,
          "pack_s": graph2d_routed_s - graph2d_s,
          "entries": graph2d_routed_cpu.nnz, "role_grid": [rp.rows, rp.cols],
          "gat_packs": len(gat_pk.packs),
          "gat_grids": [[p.rows, p.cols] for p in gat_pk.packs],
          "gat_pack_entries": [p.nnz for p in gat_pk.packs]})
    # the per-graph cost of csr_edge_dot's order, built at its first use
    t0 = time.perf_counter()
    graph2d.attention.dot_order
    torch.cuda.synchronize()
    edge_dot_order_s = time.perf_counter() - t0
    emit({"phase": "data", "seconds": hyper_s,
          "nodes": graph.node_count, "edges": graph.edge_count,
          "incidence": int(graph.inc_edge.numel()),
          "bag_entries": int(bag.col.numel()),
          "graph2d_build_s": graph2d_s, "graph2d_entries": graph2d.nnz,
          "edge_dot_order_s": edge_dot_order_s,
          "graph2d_masked_entries": 0 if graph2d.attention.mask is None
          else int((graph2d.attention.mask == 0).sum().item())})

    check_fault_3_1(torch, dev)
    with torch.no_grad():
        checks = check_kernels(torch, dev, graph, bag, graph2d)
        kp_dev = kp.to(dev)
        check_routed_kernels(torch, dev, kp_dev, checks)
        check_bf16_kernels(torch, dev, graph, checks)
        check_routed_bf16_kernels(torch, dev, kp_dev, checks)
        del kp_dev
        check_routed_2d_kernels(torch, dev, graph2d_routed_cpu.to(dev),
                                checks)
        k1_skew_row(torch, dev, checks)
    torch.cuda.synchronize()
    del graph, graph2d, bag
    ihgnn, gat = ModelConfig(), ModelConfig(gnn=V.GAT)
    ihgnn16 = dataclasses.replace(ihgnn, bf16_stream=True)
    launches = {}
    launches["serving"], serving, direct_metrics = run_serving(
        torch, dev, ihgnn, graph_cpu, qw, qc, "serving", IHGNN_SERVING)
    profile_serving(torch, *serving)
    direct_features = serving[2].cpu()
    check_small(torch, dev)
    del serving
    launches["bf16_serving"], serving, bf16_metrics = run_serving(
        torch, dev, ihgnn16, graph_cpu, qw, qc, "bf16_serving",
        IHGNN_SERVING_BF16, IHGNN_FORWARD_LAUNCHES_BF16)
    bf16_features = serving[2].cpu()
    del serving
    launches["train"], warm_step, direct_losses = run_train(
        torch, dev, ihgnn, graph_cpu, uqi, qw, qc, "train", IHGNN_TRAIN)
    emit(profile_window(torch, "one warm train step", warm_step))
    del warm_step
    check_repeatable_full_width(torch, dev, ihgnn, graph_cpu, uqi, qw, qc)
    check_small_train(torch, dev)

    # bf16 streams and remat at full width: the same graph, weights and
    # batches as the f32 phases
    launches["bf16_train"], warm_step, bf16_losses = run_train(
        torch, dev, ihgnn16, graph_cpu, uqi, qw, qc, "bf16_train",
        IHGNN_TRAIN_BF16, IHGNN_STEP_LAUNCHES_BF16)
    emit(profile_window(torch, "one warm bf16 train step", warm_step))
    del warm_step
    scale = direct_features.abs().max().item()
    feature_err = (bf16_features - direct_features).abs().max().item()
    emit({"phase": "bf16_vs_f32", "features_max_abs_err": feature_err,
          "features_scale": scale, "features_rtol": BF16_FEATURE_RTOL,
          "metrics_bf16": bf16_metrics, "metrics_f32": direct_metrics,
          "step0_loss_bf16": bf16_losses[0],
          "step0_loss_f32": direct_losses[0],
          "step0_loss_rel_diff": abs(bf16_losses[0] - direct_losses[0])
          / abs(direct_losses[0])})
    if not feature_err <= BF16_FEATURE_RTOL * scale:
        fail(f"bf16 features differ from the f32 features by {feature_err} "
             f"(scale {scale})")
    for path, cfg, per_step, expected in (
            ("remat_train", ihgnn, IHGNN_STEP_LAUNCHES_REMAT, IHGNN_TRAIN),
            ("remat_bf16_train", ihgnn16, IHGNN_STEP_LAUNCHES_BF16_REMAT,
             IHGNN_TRAIN_BF16)):
        remat = dataclasses.replace(cfg, remat=True)
        launches[path], _, _ = run_train(torch, dev, remat, graph_cpu, uqi,
                                         qw, qc, path, expected, per_step)
        if not check_repeatable_full_width(
                torch, dev, cfg, graph_cpu, uqi, qw, qc,
                f"{path}_equals_no_remat", cfg_b=remat):
            fail(f"{path}: a step with remat differs from the step without "
                 "it")
    check_small_bf16(torch, dev)

    # the routed path: same interactions, weights and batches
    launches["routed_serving"], serving, routed_metrics = run_serving(
        torch, dev, ihgnn, routed_cpu, qw, qc, "routed_serving",
        ROUTED_SERVING, ROUTED_FORWARD_LAUNCHES)
    feature_err = (serving[2].cpu() - direct_features).abs().max().item()
    del serving, direct_features
    launches["routed_scan"] = run_routed_scan(torch, dev, ihgnn, routed_cpu,
                                              qw, qc)
    launches["routed_train"], warm_step, routed_losses = run_train(
        torch, dev, ihgnn, routed_cpu, uqi, qw, qc, "routed_train",
        ROUTED_TRAIN, ROUTED_STEP_LAUNCHES)
    emit(profile_window(torch, "one warm routed train step", warm_step))
    del warm_step
    loss_err = abs(routed_losses[0] - direct_losses[0]) / abs(direct_losses[0])
    emit({"phase": "routed_vs_direct", "features_max_abs_err": feature_err,
          "features_atol": ROUTED_FEATURE_ATOL,
          "metrics_routed": routed_metrics, "metrics_direct": direct_metrics,
          "step0_loss_routed": routed_losses[0],
          "step0_loss_direct": direct_losses[0],
          "step0_loss_rel_err": loss_err, "loss_rtol": ROUTED_LOSS_RTOL})
    if not feature_err <= ROUTED_FEATURE_ATOL:
        fail(f"routed features differ from the direct path's by {feature_err}")
    if routed_metrics != direct_metrics:
        fail(f"routed metrics {routed_metrics} != direct {direct_metrics}")
    if not loss_err <= ROUTED_LOSS_RTOL:
        fail(f"routed step-0 loss differs from the direct one by {loss_err}")
    launches["small_routed_reference"] = check_small_routed(torch, dev)

    # the routed path on bf16 streams (bench.py's default): the same
    # interactions, weights and batches as the bf16 phases
    launches["routed_bf16_serving"], serving, routed16_metrics = run_serving(
        torch, dev, ihgnn16, routed_cpu, qw, qc, "routed_bf16_serving",
        ROUTED_SERVING_BF16, ROUTED_FORWARD_LAUNCHES_BF16)
    routed16_features = serving[2].cpu()
    del serving
    launches["routed_bf16_scan"] = run_routed_scan(
        torch, dev, ihgnn16, routed_cpu, qw, qc, "routed_bf16_scan",
        ROUTED_SCAN_LAUNCHES_BF16)
    launches["routed_bf16_train"], warm_step, routed16_losses = run_train(
        torch, dev, ihgnn16, routed_cpu, uqi, qw, qc, "routed_bf16_train",
        ROUTED_TRAIN_BF16, ROUTED_STEP_LAUNCHES_BF16)
    emit(profile_window(torch, "one warm routed bf16 train step", warm_step))
    del warm_step
    scale = bf16_features.abs().max().item()
    feature_err = (routed16_features - bf16_features).abs().max().item()
    loss_err = (abs(routed16_losses[0] - bf16_losses[0])
                / abs(bf16_losses[0]))
    emit({"phase": "routed_bf16_vs_direct_bf16",
          "features_max_abs_err": feature_err, "features_scale": scale,
          "features_rtol": BF16_FEATURE_RTOL,
          "metrics_routed_bf16": routed16_metrics,
          "metrics_direct_bf16": bf16_metrics,
          "step0_loss_routed_bf16": routed16_losses[0],
          "step0_loss_direct_bf16": bf16_losses[0],
          "step0_loss_rel_err": loss_err,
          "loss_rtol": ROUTED_BF16_LOSS_RTOL})
    if not feature_err <= BF16_FEATURE_RTOL * scale:
        fail(f"routed bf16 features differ from the direct bf16 features by "
             f"{feature_err} (scale {scale})")
    if not loss_err <= ROUTED_BF16_LOSS_RTOL:
        fail(f"routed bf16 step-0 loss differs from the direct bf16 one by "
             f"{loss_err}")
    del routed16_features, bf16_features
    launches["small_routed_bf16_reference"] = check_small_routed_bf16(torch,
                                                                      dev)
    if not check_repeatable_full_width(
            torch, dev, ihgnn16, routed_cpu, uqi, qw, qc,
            "routed_bf16_remat_equals_no_remat",
            cfg_b=dataclasses.replace(ihgnn16, remat=True)):
        fail("routed_bf16_remat_equals_no_remat: a routed bf16 step with "
             "remat differs from the step without it")

    # the chunked pack at the JAX package's stress shape
    launches.update(run_chunked(torch, dev, checks))
    launches["small_chunked_reference"] = check_small_chunked(torch, dev)

    launches["gat_serving"], serving, gat_metrics = run_serving(
        torch, dev, gat, graph2d_cpu, qw, qc, "gat_serving", GAT_SERVING,
        GAT_FORWARD_LAUNCHES)
    gat_features = serving[2].cpu()
    del serving
    launches["gat_train"], warm_step, gat_losses = run_train(
        torch, dev, gat, graph2d_cpu, uqi, qw, qc, "gat_train", GAT_TRAIN,
        GAT_STEP_LAUNCHES)
    emit(profile_window(torch, "one warm GAT train step", warm_step))
    del warm_step
    check_repeatable_full_width(torch, dev, gat, graph2d_cpu, uqi, qw, qc,
                                "repeatable_gat_full_width")

    # the routed 2D graph: the same entries, weights and batches
    packs = len(graph2d_routed_cpu.gat_pk.packs)
    launches["routed_gat_serving"], serving, rgat_metrics = run_serving(
        torch, dev, gat, graph2d_routed_cpu, qw, qc, "routed_gat_serving",
        ROUTED_GAT_SERVING, routed_gat_launches(packs, False))
    feature_err = (serving[2].cpu() - gat_features).abs().max().item()
    del serving, gat_features
    launches["routed_gat_train"], warm_step, rgat_losses = run_train(
        torch, dev, gat, graph2d_routed_cpu, uqi, qw, qc, "routed_gat_train",
        ROUTED_GAT_TRAIN, routed_gat_launches(packs, True))
    emit(profile_window(torch, "one warm routed GAT train step", warm_step))
    del warm_step
    loss_err = abs(rgat_losses[0] - gat_losses[0]) / abs(gat_losses[0])
    emit({"phase": "routed_gat_vs_direct",
          "features_max_abs_err": feature_err,
          "features_atol": ROUTED_2D_ATOL, "metrics_routed": rgat_metrics,
          "metrics_direct": gat_metrics,
          "step0_loss_routed": rgat_losses[0],
          "step0_loss_direct": gat_losses[0],
          "step0_loss_rel_err": loss_err, "loss_rtol": ROUTED_2D_LOSS_RTOL})
    if not feature_err <= ROUTED_2D_ATOL:
        fail(f"routed GAT features differ from the direct ones by "
             f"{feature_err}")
    if not loss_err <= ROUTED_2D_LOSS_RTOL:
        fail(f"routed GAT step-0 loss differs from the direct one by "
             f"{loss_err}")
    launches["routed_gcn"] = run_routed_gcn(torch, dev, graph2d_routed_cpu,
                                            uqi, qw, qc)
    launches["small_routed_2d_reference"] = check_small_routed_2d(torch,
                                                                  dev)
    del graph2d_routed_cpu
    check_small_zoo(torch, dev)
    launches["cli"], cli_reference = run_cli(torch, dev)

    # data parallelism over the edge axis: ranks sharing the card
    # and the model axis: the tables' rows and their Adam moments over
    # ranks; every phase's card ranks in one spawn
    launches.update(run_sharded(torch, dev, uqi, qw, qc))
    launches["dryrun"] = run_dryrun(torch, dev)
    launches["cli_mesh"] = run_cli_mesh(torch, dev, cli_reference)
    srrl_graph_data, srrl_data_s = srrl_data(uqi, qw, qc)
    emit({"phase": "srrl_data", "seconds": srrl_data_s,
          "logs": len(srrl_graph_data.search_logs),
          "positives": srrl_graph_data.pos_count})
    run_srrl_serving(torch, dev, srrl_graph_data)
    run_srrl_train(torch, dev, srrl_graph_data, uqi)
    del srrl_graph_data
    check_small_srrl(torch, dev)
    launches["preprocess"] = run_preprocess(torch, dev)

    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        main_row, *others = checks[kname]
        # K1's three-region form counts as csr_segment_sum3_multi on the
        # chunked paths and as csr_segment_sum3 on the others
        counter = COUNTED_AS.get(kname, kname)
        multi = counter != kname
        by_path = {path: counts[counter] for path, counts in launches.items()
                   if (path in CHUNKED_PATHS) == multi
                   or counter not in COUNTED_AS.values()}
        if not any(by_path.values()):
            fail(f"{kname} was launched on no path")
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r.get("max_abs_err_all", r["max_abs_err"])
                               for r in checks[kname]),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "shape": main_row["shape"],
            "other_shapes": others})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
