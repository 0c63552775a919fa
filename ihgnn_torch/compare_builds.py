"""Hold this checkout's interaction, segment-sum, gather and scan kernels,
f32 and bf16 forms, bit for bit against another checkout's build of them,
and K5's backward against this build's direct backward, on the same
inputs.

    python3 -m ihgnn_torch.compare_builds --reference DIR

``DIR`` is the root of another checkout (for example the parent commit,
unpacked with ``git archive``). Both checkouts' ``csrc/interact_bwd.cu``,
``csrc/interact.cu``, ``csrc/segsum.cu``, ``csrc/gather.cu`` and
``csrc/segscan.cu`` are built with the package's nvcc flags (one nvcc
process each, in parallel, into ``build/compare/``), and each pair below
runs on the same seeded inputs:

* ``ihgnn_interact_bwd`` and ``ihgnn_interact_bwd_absorb`` (K5's
  backward) of both builds of ``interact_bwd.cu``;
* ``ihgnn_interact_fwd`` and ``ihgnn_interact_fwd_absorb`` (K3's and K5's
  tensor-core forms), ``ihgnn_interact_fwd_cores`` and
  ``ihgnn_interact_fwd_absorb_cores`` (their f32-core form) of both
  builds of ``interact.cu``; the reference needs those entry points, so
  it is a checkout with K3's tensor-core form and K5's fused backward;
* ``ihgnn_csr_gather_sum`` (K1's vector form with and without weights,
  its fixed-width form and its scalar form) and ``ihgnn_csr_segment_sum3``
  of both builds of ``segsum.cu``, on a CSR of short and hub segments;
  and the reference's vector form against this checkout's
  ``ihgnn_csr_gather_sum_long`` (the hubs summed by a block each, as the
  wrapper launches it with the CSR's ``long_segments``), with and without
  weights;
* ``ihgnn_gather_rows`` and ``ihgnn_gather_rows_t`` of both builds of
  ``gather.cu``;
* K2, ``ihgnn_gather_roles`` (f32) and its bf16 form, at d = 8, 12, 32
  and 64 on a ragged E whose ids reach the last row: from a bf16 x (also
  on rows aligned to 8 bytes only, at d = 32), and from an f32 x, where a
  build with ``ihgnn_round_bf16`` runs as its wrapper does (rounded into
  a bf16 table, then copied) and one without it rounds in the copy;
* ``ihgnn_csr_segment_scan`` (K8, its float4 and 4-byte forms) of both
  builds of ``segscan.cu``, on a block-sorted stream whose runs cross
  blocks;
* this checkout's ``ihgnn_interact_bwd_absorb`` against its own
  ``ihgnn_interact_bwd`` on the pre-permuted inputs (i[e_pi] and the
  merged, masked cotangent), di scattered back to t1 order: the identity
  of ``interact_bwd_absorb_via_direct``;
* the bf16 forms: ``ihgnn_csr_gather_sum_bf16`` (into f32, and the
  fixed-width form into bf16) and ``ihgnn_csr_segment_sum3_bf16`` (into
  f32 and into bf16) at d = 8, 12, 32, 64 and on 8-byte aligned rows at
  d = 32 (both lane widths); ``ihgnn_csr_segment_scan_bf16`` (K8);
  ``ihgnn_interact_bwd_bf16`` and ``ihgnn_interact_bwd_absorb_bf16`` at
  orders 1-3, masked and with no mask, with ``cols`` equal to the chunk
  (1024 edges) and not, and this checkout's bf16 K5 backward against its
  own bf16 ``interact_bwd`` on the pre-permuted inputs.

Prints one JSON line a case and, last, ``{"bitwise_equal": ...}``; exits 1
when any output differs in any bit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ihgnn_torch.ops import _build
from ihgnn_torch.ops.interact import CHUNK_EDGES, ORDER_PARTS
from ihgnn_torch.ops.segscan import BLOCK, pack_scan_inputs
from ihgnn_torch.ops.segsum import long_segments

PTR, INT = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    "ihgnn_interact_bwd": [PTR] * 8 + [INT] * 5 + [PTR],
    "ihgnn_interact_bwd_absorb": [PTR] * 11 + [INT] * 6 + [PTR],
    "ihgnn_interact_fwd_cores": [PTR] * 6 + [INT] * 4 + [PTR],
    "ihgnn_interact_fwd_absorb_cores": [PTR] * 8 + [INT] * 5 + [PTR],
    "ihgnn_interact_fwd": [PTR] * 6 + [INT] * 4 + [PTR],
    "ihgnn_interact_fwd_absorb": [PTR] * 8 + [INT] * 5 + [PTR],
    "ihgnn_gather_rows": [PTR] * 3 + [INT] * 3 + [PTR],
    "ihgnn_gather_roles": [PTR] * 5 + [INT] * 2 + [PTR],
    "ihgnn_gather_roles_bf16": [PTR, INT] + [PTR] * 4 + [INT] * 2 + [PTR],
    "ihgnn_round_bf16": [PTR] * 2 + [ctypes.c_longlong, PTR],
    "ihgnn_gather_rows_t": [PTR] * 3 + [INT] * 3 + [PTR],
    "ihgnn_csr_segment_scan": [PTR] * 5 + [INT] * 3 + [PTR],
    "ihgnn_csr_gather_sum": [PTR] * 5 + [INT] * 4 + [PTR],
    "ihgnn_csr_gather_sum_long": [PTR] * 5 + [INT] * 2 + [PTR, INT, PTR],
    "ihgnn_csr_segment_sum3": [PTR] * 3 + [INT] + [PTR] * 3 + [INT] * 3
    + [PTR],
    "ihgnn_csr_gather_sum_bf16": [PTR] * 4 + [INT] * 4 + [PTR],
    "ihgnn_csr_segment_sum3_bf16": [PTR] * 3 + [INT] + [PTR] * 3
    + [INT] * 3 + [PTR],
    "ihgnn_csr_segment_scan_bf16": [PTR] * 5 + [INT] * 3 + [PTR],
    "ihgnn_interact_bwd_bf16": [PTR] * 8 + [INT] * 5 + [PTR],
    "ihgnn_interact_bwd_absorb_bf16": [PTR] * 11 + [INT] * 6 + [PTR],
}
BF16 = torch.bfloat16
# (edges, d, out) of each case; the first is the train step's shape
SHAPES = ((2_000_000, 32, 32), (4097, 16, 64), (3000, 8, 8), (389, 12, 16))
COLS = {2_000_000: 1000, 4097: 241, 3000: 100, 389: 389}
# (edges, d, out, cols) of the bf16 backward's cases; the first is the
# routed pack's (cols the chunk, 1024 edges), the second the direct train
# step's
BF16_SHAPES = ((2_097_152, 32, 32, 1024), (2_000_000, 32, 32, 1000),
               (4097, 16, 64, 241), (3072, 8, 16, 1024), (3000, 24, 8, 100))
# widths of K1's bf16 cases: 12 takes the 8-byte lanes, the others the
# 16-byte lanes (and the 8-byte lanes on rows aligned to 8 bytes only)
BF16_WIDTHS = (8, 12, 32, 64)


def build_pair(reference: Path, stems,
               tags=("reference", "this")) -> dict:
    """``{(tag, stem): loaded library}`` for each tag of ``tags``
    (``"reference"``: the checkout at ``reference``; ``"this"``: this one),
    all built at once."""
    out_dir = _build.BUILD / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    roots = {"reference": reference / "ihgnn_torch" / "csrc",
             "this": _build.CSRC}
    for tag, csrc in ((tag, roots[tag]) for tag in tags):
        for stem in stems:
            lib = out_dir / f"{tag}-{stem}.so"
            log = open(out_dir / f"{tag}-{stem}.log", "w")
            jobs[tag, stem] = (subprocess.Popen(
                _build.nvcc_command(nvcc, csrc / f"{stem}.cu", lib),
                stdout=log, stderr=subprocess.STDOUT), log, lib)
    libs = {}
    for key, (proc, log, lib) in jobs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {key}: "
                               + Path(log.name).read_text()[-4000:])
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def run_bwd(lib, absorb, u, q, i, pi, w, cot, c2, mask, order):
    e, d = u.shape
    out = w.shape[1]
    droles = torch.empty(3, e, d, device=u.device)
    chunks = -(-e // CHUNK_EDGES)
    partial = torch.empty(chunks, w.shape[0] + 1, out, device=u.device)
    dw_ext = torch.empty(w.shape[0] + 1, out, device=u.device)
    stream = _build.stream_ptr(u.device)
    if absorb:
        err = entry(lib, "ihgnn_interact_bwd_absorb")(
            u.data_ptr(), q.data_ptr(), i.data_ptr(), pi.data_ptr(),
            w.data_ptr(), cot.data_ptr(), c2.data_ptr(), mask.data_ptr(),
            droles.data_ptr(), partial.data_ptr(), dw_ext.data_ptr(), e, d,
            out, order, pi.shape[1], CHUNK_EDGES, stream)
    else:
        err = entry(lib, "ihgnn_interact_bwd")(
            u.data_ptr(), q.data_ptr(), i.data_ptr(), w.data_ptr(),
            cot.data_ptr(), droles.data_ptr(), partial.data_ptr(),
            dw_ext.data_ptr(), e, d, out, order, CHUNK_EDGES, stream)
    if err:
        raise RuntimeError(f"interact_bwd (absorb={absorb}): CUDA error {err}")
    return droles, dw_ext


def run_fwd(lib, name, u, q, i, pi, w, b, order):
    e, d = u.shape
    o1 = torch.empty(e, w.shape[1], device=u.device)
    o2 = torch.empty_like(o1)
    stream = _build.stream_ptr(u.device)
    if pi is None:
        err = entry(lib, name)(u.data_ptr(), q.data_ptr(), i.data_ptr(),
                               w.data_ptr(), b.data_ptr(), o1.data_ptr(), e,
                               d, w.shape[1], order, stream)
        outs = (o1,)
    else:
        err = entry(lib, name)(u.data_ptr(), q.data_ptr(), i.data_ptr(),
                               pi.data_ptr(), w.data_ptr(), b.data_ptr(),
                               o1.data_ptr(), o2.data_ptr(), e, d,
                               w.shape[1], order, pi.shape[1], stream)
        outs = (o1, o2)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return outs


def run_bwd_bf16(lib, absorb, u, q, i, pi, w, cot, c2, mask, order):
    """``ihgnn_interact_bwd_bf16`` or, with ``absorb``,
    ``ihgnn_interact_bwd_absorb_bf16`` of ``lib`` (mask None: no mask)."""
    e, d = u.shape
    out = w.shape[1]
    droles = torch.empty(3, e, d, dtype=BF16, device=u.device)
    chunks = -(-e // CHUNK_EDGES)
    partial = torch.empty(chunks, w.shape[0] + 1, out, device=u.device)
    dw_ext = torch.empty(w.shape[0] + 1, out, device=u.device)
    stream = _build.stream_ptr(u.device)
    if absorb:
        err = entry(lib, "ihgnn_interact_bwd_absorb_bf16")(
            u.data_ptr(), q.data_ptr(), i.data_ptr(), pi.data_ptr(),
            w.data_ptr(), cot.data_ptr(), c2.data_ptr(),
            None if mask is None else mask.data_ptr(), droles.data_ptr(),
            partial.data_ptr(), dw_ext.data_ptr(), e, d, out, order,
            pi.shape[1], CHUNK_EDGES, stream)
    else:
        err = entry(lib, "ihgnn_interact_bwd_bf16")(
            u.data_ptr(), q.data_ptr(), i.data_ptr(), w.data_ptr(),
            cot.data_ptr(), droles.data_ptr(), partial.data_ptr(),
            dw_ext.data_ptr(), e, d, out, order, CHUNK_EDGES, stream)
    if err:
        raise RuntimeError(f"interact_bwd bf16 (absorb={absorb}): CUDA "
                           f"error {err}")
    return droles, dw_ext


def run_k1_bf16(lib, x, col, rowptr, width=0, out_dtype=torch.float32):
    """``ihgnn_csr_gather_sum_bf16`` of ``lib`` on bf16 rows ``x``."""
    s, d = rowptr.numel() - 1, x.shape[1]
    out = torch.empty(s, d, dtype=out_dtype, device=x.device)
    err = entry(lib, "ihgnn_csr_gather_sum_bf16")(
        x.data_ptr(), col.data_ptr(), rowptr.data_ptr(), out.data_ptr(), s,
        d, width, int(out_dtype == BF16), _build.stream_ptr(x.device))
    if err:
        raise RuntimeError(f"csr_gather_sum bf16: CUDA error {err}")
    return (out,)


def run_k1_three_bf16(lib, u, q, i, col, rowptr, out_dtype=torch.float32):
    """``ihgnn_csr_segment_sum3_bf16`` of ``lib`` on bf16 regions."""
    s, d = rowptr.numel() - 1, u.shape[1]
    out = torch.empty(s, d, dtype=out_dtype, device=u.device)
    err = entry(lib, "ihgnn_csr_segment_sum3_bf16")(
        u.data_ptr(), q.data_ptr(), i.data_ptr(), u.shape[0], col.data_ptr(),
        rowptr.data_ptr(), out.data_ptr(), s, d, int(out_dtype == BF16),
        _build.stream_ptr(u.device))
    if err:
        raise RuntimeError(f"csr_segment_sum3 bf16: CUDA error {err}")
    return (out,)


def rows_at(x, offset_bytes):
    """A contiguous copy of ``x`` whose data begins ``offset_bytes`` past a
    16-byte boundary (a row view aligned to 8 bytes only, for 8)."""
    n = offset_bytes // x.element_size()
    buf = torch.empty(x.numel() + n, dtype=x.dtype, device=x.device)
    view = buf[n:].view(x.shape)
    view.copy_(x)
    return view


def run_k1(lib, x, col, rowptr, weight, vector, width):
    s, d = rowptr.numel() - 1, x.shape[1]
    out = torch.empty(s, d, device=x.device)
    err = entry(lib, "ihgnn_csr_gather_sum")(
        x.data_ptr(), col.data_ptr(), rowptr.data_ptr(),
        None if weight is None else weight.data_ptr(), out.data_ptr(), s, d,
        vector, width, _build.stream_ptr(x.device))
    if err:
        raise RuntimeError(f"csr_gather_sum: CUDA error {err}")
    return (out,)


def run_k1_long(lib, x, col, rowptr, weight, hubs):
    """``ihgnn_csr_gather_sum_long`` of ``lib``: the vector form with the
    long segments ``hubs`` (``ops/segsum.py`` ``LongSegments``)."""
    s, d = rowptr.numel() - 1, x.shape[1]
    out = torch.empty(s, d, device=x.device)
    err = entry(lib, "ihgnn_csr_gather_sum_long")(
        x.data_ptr(), col.data_ptr(), rowptr.data_ptr(),
        None if weight is None else weight.data_ptr(), out.data_ptr(), s, d,
        hubs.ids.data_ptr(), hubs.ids.numel(), _build.stream_ptr(x.device))
    if err:
        raise RuntimeError(f"csr_gather_sum long: CUDA error {err}")
    return (out,)


def run_k1_three(lib, x, col, rowptr):
    m, d = x.shape[0] // 3, x.shape[1]
    s = rowptr.numel() - 1
    out = torch.empty(s, d, device=x.device)
    err = entry(lib, "ihgnn_csr_segment_sum3")(
        x[:m].data_ptr(), x[m:2 * m].data_ptr(), x[2 * m:].data_ptr(), m,
        col.data_ptr(), rowptr.data_ptr(), out.data_ptr(), s, d, 1,
        _build.stream_ptr(x.device))
    if err:
        raise RuntimeError(f"csr_segment_sum3: CUDA error {err}")
    return (out,)


def k1_cases(libs, dev, gen) -> dict:
    """``{case: (reference outputs, this checkout's)}`` of K1's f32 forms
    on 300k rows of d = 32: a CSR of 100k segments, most of 0-10 entries
    and a few hubs of 5k-50k, and a fixed-width CSR of 3 entries a
    segment; and of its bf16 forms on 300k bf16 rows of each width of
    ``BF16_WIDTHS`` with the same CSRs (the three-region form on three
    100k-row regions, the columns taken modulo 300k). The vector form's
    cases also run through this checkout's long-segment launch, held to
    the reference's vector form."""
    rows, d = 300_000, 32
    counts = torch.randint(0, 11, (100_000,), device=dev, generator=gen)
    counts[::20_000] = torch.tensor([50_000, 20_000, 5_000, 10_000, 8_000],
                                    device=dev)
    rowptr = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=dev)
    rowptr[1:] = counts.cumsum(0)
    rowptr = rowptr.int()
    k = int(rowptr[-1].item())
    col = torch.randint(0, rows, (k,), device=dev, generator=gen).int()
    weight = torch.rand(k, device=dev, generator=gen)
    x = torch.randn(rows, d, device=dev, generator=gen)
    fixed_col = torch.randint(0, rows, (3 * 100_000,), device=dev,
                              generator=gen).int()
    fixed_ptr = torch.arange(0, 3 * 100_000 + 1, 3, device=dev).int()
    cases = {}
    for tag in ("reference", "this"):
        lib = libs[tag, "segsum"]
        for name, outs in (
                ("csr_gather_sum vector", run_k1(lib, x, col, rowptr, None,
                                                 1, 0)),
                ("csr_gather_sum vector weighted",
                 run_k1(lib, x, col, rowptr, weight, 1, 0)),
                ("csr_gather_sum fixed width 3",
                 run_k1(lib, x, fixed_col, fixed_ptr, None, 1, 3)),
                ("csr_gather_sum scalar weighted",
                 run_k1(lib, x, col, rowptr, weight, 0, 0)),
                ("csr_segment_sum3", run_k1_three(lib, x, col, rowptr))):
            cases.setdefault(name, []).append(outs)
    hubs = long_segments(rowptr.cpu()).to(dev)
    for label, w in (("", None), (" weighted", weight)):
        cases[f"csr_gather_sum vector{label}, long segments by block"] = [
            run_k1(libs["reference", "segsum"], x, col, rowptr, w, 1, 0),
            run_k1_long(libs["this", "segsum"], x, col, rowptr, w, hubs)]
    for d in BF16_WIDTHS:
        x16 = torch.randn(rows, d, device=dev, generator=gen).to(BF16)
        views = [("", x16)]
        if d == 32:
            views.append((" 8-byte rows", rows_at(x16, 8)))
        m = rows // 3
        for tag in ("reference", "this"):
            lib = libs[tag, "segsum"]
            for label, x in views:
                regions = (x[:m], x[m:2 * m], x[2 * m:3 * m])
                three_col = col % (3 * m)
                for name, outs in (
                        (f"csr_gather_sum bf16{label} d {d}",
                         run_k1_bf16(lib, x, col, rowptr)),
                        (f"csr_gather_sum bf16{label} fixed width 3 -> bf16 "
                         f"d {d}", run_k1_bf16(lib, x, fixed_col, fixed_ptr,
                                               3, BF16)),
                        (f"csr_segment_sum3 bf16{label} d {d}",
                         run_k1_three_bf16(lib, *regions, three_col,
                                           rowptr)),
                        (f"csr_segment_sum3 bf16{label} -> bf16 d {d}",
                         run_k1_three_bf16(lib, *regions, three_col, rowptr,
                                           BF16))):
                    cases.setdefault(name, []).append(outs)
    return cases


def run_gather(lib, name, x, idx):
    rows, cols = idx.shape
    out = torch.empty(rows * cols, x.shape[1], device=x.device)
    err = entry(lib, name)(x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows,
                           cols, x.shape[1], _build.stream_ptr(x.device))
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return (out,)


def run_roles(lib, x, i3, dtype):
    """K2 of ``lib``: ``ihgnn_gather_roles`` (f32 roles) or its bf16 form
    (bf16 roles). An f32 x goes to the bf16 form as the build's wrapper
    hands it: rounded into a bf16 table by ``ihgnn_round_bf16`` where the
    build has it, else as it is (the form that rounds in the copy)."""
    e, d = i3.shape[0], x.shape[1]
    out = torch.empty(3, e, d, dtype=dtype, device=x.device)
    stream = _build.stream_ptr(x.device)
    planes = (out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr())
    if dtype == torch.float32:
        err = entry(lib, "ihgnn_gather_roles")(x.data_ptr(), i3.data_ptr(),
                                               *planes, e, d, stream)
    else:
        if x.dtype == torch.float32 and hasattr(lib, "ihgnn_round_bf16"):
            table = torch.empty(x.shape, dtype=BF16, device=x.device)
            err = entry(lib, "ihgnn_round_bf16")(
                x.data_ptr(), table.data_ptr(), x.numel(), stream)
            if err:
                raise RuntimeError(f"round_bf16: CUDA error {err}")
            x = table
        err = entry(lib, "ihgnn_gather_roles_bf16")(
            x.data_ptr(), int(x.dtype == BF16), i3.data_ptr(), *planes, e, d,
            stream)
    if err:
        raise RuntimeError(f"gather_roles ({dtype}): CUDA error {err}")
    return (out,)


def roles_cases(libs, dev, gen) -> dict:
    """``{case: (reference outputs, this checkout's)}`` of K2 at each
    width of ``BF16_WIDTHS``: 100,003 rows, 300,001 edges (a ragged last
    block) whose ids are random but for the first and last edges', which
    read rows 0 and N - 1; f32 roles from an f32 x, bf16 roles from that x
    (rounded) and from a bf16 x, and at d = 32 from bf16 rows aligned to 8
    bytes only."""
    n, e = 100_003, 300_001
    i3 = torch.randint(0, n, (e, 3), device=dev, generator=gen).int()
    i3[0], i3[-1] = 0, n - 1
    cases = {}
    for d in BF16_WIDTHS:
        x = torch.randn(n, d, device=dev, generator=gen)
        x16 = torch.randn(n, d, device=dev, generator=gen).to(BF16)
        runs = [(f"gather_roles d {d}", x, torch.float32),
                (f"gather_roles bf16 from f32 d {d}", x, BF16),
                (f"gather_roles bf16 from bf16 d {d}", x16, BF16)]
        if d == 32:
            runs.append((f"gather_roles bf16 from bf16 8-byte rows d {d}",
                         rows_at(x16, 8), BF16))
        for tag in ("reference", "this"):
            for name, rows, dtype in runs:
                cases.setdefault(name, []).append(
                    run_roles(libs[tag, "gather"], rows, i3, dtype))
    return cases


def run_scan(lib, values, pack):
    k, d = values.shape
    out = torch.empty(pack.num_segments, d, device=values.device)
    name = ("ihgnn_csr_segment_scan_bf16" if values.dtype == BF16
            else "ihgnn_csr_segment_scan")
    err = entry(lib, name)(
        values.data_ptr(), pack.pos.data_ptr(), pack.rowptr.data_ptr(),
        pack.block_seg.data_ptr(), out.data_ptr(), k, d, BLOCK,
        _build.stream_ptr(values.device))
    if err:
        raise RuntimeError(f"csr_segment_scan: CUDA error {err}")
    return (out,)


def gather_scan_cases(libs, dev, gen) -> dict:
    """``{case: (reference outputs, this checkout's)}`` of K2's
    single-index forms (700k rows of d = 32 into a [1024, 1024] grid) and
    K8 (a stream of 1,048,576 entries, block-sorted, runs of 1-200 entries
    crossing blocks, 5 % sentinels; d = 32 and the 4-byte form's d = 5;
    its bf16 form at d = 32 and 12)."""
    x = torch.randn(700_000, 32, device=dev, generator=gen)
    idx = torch.randint(0, 700_000, (1024, 1024), device=dev,
                        generator=gen).int()
    rng = np.random.default_rng(0)
    k = 1024 * BLOCK
    ids = np.repeat(np.arange(k // 50), rng.integers(1, 200, k // 50))[:k]
    ids[rng.random(k) < 0.05] = 2 ** 31 - 1
    ids = ids.reshape(-1, BLOCK)
    rng.permuted(ids, axis=1, out=ids)
    ids = ids.reshape(-1)
    n = int(ids[ids != 2 ** 31 - 1].max()) + 1
    pack = pack_scan_inputs(ids, n).to(dev)
    v32 = torch.randn(k, 32, device=dev, generator=gen)
    v5 = torch.randn(k, 5, device=dev, generator=gen)
    v32_16, v12_16 = v32.to(BF16), torch.randn(k, 12, device=dev,
                                               generator=gen).to(BF16)
    cases = {}
    for tag in ("reference", "this"):
        g, sc = libs[tag, "gather"], libs[tag, "segscan"]
        for name, outs in (
                ("gather_rows", run_gather(g, "ihgnn_gather_rows", x, idx)),
                ("gather_rows_t", run_gather(g, "ihgnn_gather_rows_t", x,
                                             idx)),
                ("csr_segment_scan d 32", run_scan(sc, v32, pack)),
                ("csr_segment_scan d 5", run_scan(sc, v5, pack)),
                ("csr_segment_scan bf16 d 32", run_scan(sc, v32_16, pack)),
                ("csr_segment_scan bf16 d 12", run_scan(sc, v12_16, pack))):
            cases.setdefault(name, []).append(outs)
    return cases


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reference", type=Path, required=True,
                        help="root of the checkout to compare against")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_builds: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build_pair(args.reference, ("interact_bwd", "interact", "segsum",
                                       "gather", "segscan"))
    gen = torch.Generator(device=dev).manual_seed(0)
    equal_all = True
    cases = k1_cases(libs, dev, gen)
    cases.update(gather_scan_cases(libs, dev, gen))
    cases.update(roles_cases(libs, dev, gen))
    for case, (ref, this) in cases.items():
        torch.cuda.synchronize()
        equal = all(torch.equal(a, c) for a, c in zip(ref, this))
        equal_all = equal_all and equal
        print(json.dumps({"case": case, "bitwise_equal": equal}), flush=True)
    for e, d, out in SHAPES:
        cols = COLS[e]
        pi = torch.stack([torch.randperm(cols, device=dev, generator=gen)
                          for _ in range(e // cols)]).int()
        for order in (1, 2, 3):
            u, q, i = (torch.randn(e, d, device=dev, generator=gen)
                       for _ in range(3))
            parts = ORDER_PARTS[order]
            w = torch.randn(parts * d, out, device=dev,
                            generator=gen) / (parts * d) ** 0.5
            b = torch.randn(out, device=dev, generator=gen)
            cot, c2 = (torch.randn(e, out, device=dev, generator=gen)
                       for _ in range(2))
            mask = (torch.rand(e, device=dev, generator=gen) > 0.1).float()
            cases = {"interact_bwd": [
                run_bwd(libs[tag, "interact_bwd"], False, u, q, i, pi, w, cot,
                        c2, mask, order) for tag in ("reference", "this")]}
            this_bwd = libs["this", "interact_bwd"]
            e_pi = (torch.arange(e // cols, device=dev)[:, None] * cols
                    + pi.long()).view(-1)
            direct = run_bwd(this_bwd, False, u, q, i[e_pi], pi, w,
                             (cot + c2[e_pi]) * mask[:, None], c2, mask,
                             order)
            direct[0][2][e_pi] = direct[0][2].clone()
            cases["interact_bwd_absorb_via_direct"] = [
                direct, run_bwd(this_bwd, True, u, q, i, pi, w, cot, c2,
                                mask, order)]
            cases["interact_bwd_absorb"] = [
                run_bwd(libs[tag, "interact_bwd"], True, u, q, i, pi, w, cot,
                        c2, mask, order) for tag in ("reference", "this")]
            for name, p in (("ihgnn_interact_fwd", None),
                            ("ihgnn_interact_fwd_absorb", pi),
                            ("ihgnn_interact_fwd_cores", None),
                            ("ihgnn_interact_fwd_absorb_cores", pi)):
                cases[name] = [
                    run_fwd(libs[tag, "interact"], name, u, q, i, p, w, b,
                            order) for tag in ("reference", "this")]
            torch.cuda.synchronize()
            for case, (ref, this) in cases.items():
                outputs = [torch.equal(a, c) for a, c in zip(ref, this)]
                equal = all(outputs)
                equal_all = equal_all and equal
                print(json.dumps({"case": case, "edges": e, "d": d,
                                  "out": out, "order": order,
                                  "bitwise_equal": equal,
                                  "outputs_equal": outputs}), flush=True)
    equal_all = bf16_bwd_cases(libs, dev, gen) and equal_all
    print(json.dumps({"bitwise_equal": equal_all}), flush=True)
    return 0 if equal_all else 1


def bf16_bwd_cases(libs, dev, gen) -> bool:
    """The bf16 backward of both builds (``interact_bwd`` and K5's) at
    ``BF16_SHAPES``, orders 1-3, masked and with no mask, and this build's
    bf16 K5 backward against its own ``interact_bwd`` on the pre-permuted
    inputs; prints a line a case and returns whether all were equal."""
    equal_all = True
    for e, d, out, cols in BF16_SHAPES:
        pi = torch.stack([torch.randperm(cols, device=dev, generator=gen)
                          for _ in range(e // cols)]).int()
        e_pi = (torch.arange(e // cols, device=dev)[:, None] * cols
                + pi.long()).view(-1)
        for order in (1, 2, 3):
            u, q, i = (torch.randn(e, d, device=dev, generator=gen).to(BF16)
                       for _ in range(3))
            parts = ORDER_PARTS[order]
            w = torch.randn(parts * d, out, device=dev,
                            generator=gen) / (parts * d) ** 0.5
            cot, c2 = (torch.randn(e, out, device=dev, generator=gen).to(BF16)
                       for _ in range(2))
            cases = {"interact_bwd bf16": [
                run_bwd_bf16(libs[tag, "interact_bwd"], False, u, q, i, pi, w,
                             cot, c2, None, order)
                for tag in ("reference", "this")]}
            this_bwd = libs["this", "interact_bwd"]
            for masked in (True, False):
                mask = ((torch.rand(e, device=dev, generator=gen) > 0.1)
                        .float() if masked else None)
                label = "masked" if masked else "no mask"
                merged = cot + c2[e_pi]
                if masked:
                    merged = merged * mask[:, None].to(BF16)
                direct = run_bwd_bf16(this_bwd, False, u, q, i[e_pi], pi, w,
                                      merged.contiguous(), c2, None, order)
                direct[0][2][e_pi] = direct[0][2].clone()
                cases[f"interact_bwd_absorb_via_direct bf16 {label}"] = [
                    direct, run_bwd_bf16(this_bwd, True, u, q, i, pi, w, cot,
                                         c2, mask, order)]
                cases[f"interact_bwd_absorb bf16 {label}"] = [
                    run_bwd_bf16(libs[tag, "interact_bwd"], True, u, q, i, pi,
                                 w, cot, c2, mask, order)
                    for tag in ("reference", "this")]
            torch.cuda.synchronize()
            for case, (ref, this) in cases.items():
                equal = all(torch.equal(a, c) for a, c in zip(ref, this))
                equal_all = equal_all and equal
                print(json.dumps({"case": case, "edges": e, "d": d,
                                  "out": out, "cols": cols, "order": order,
                                  "bitwise_equal": equal}), flush=True)
    return equal_all


if __name__ == "__main__":
    sys.exit(main())
