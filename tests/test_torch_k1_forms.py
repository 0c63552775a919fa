"""K1's bf16 lane widths (``ihgnn_torch.ops.segsum.bf16_form``): the
16-byte form, the 8-byte form or none, chosen from d and the rows'
alignment alone, the rule the C entry points of ``csrc/segsum.cu`` apply
(``bf16_lane_bytes``). On the CPU the wrappers run the plain twins
whatever the form; the forms themselves are held on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from ihgnn_torch.ops.segsum import (bf16_form, csr_gather_sum,
                                    csr_gather_sum_plain, csr_segment_sum3,
                                    csr_segment_sum3_plain, vector_form)

BF16 = torch.bfloat16


def _rows(n, d, offset_bytes=0, dtype=BF16):
    """``[n, d]`` contiguous rows beginning ``offset_bytes`` past a 64-byte
    aligned allocation."""
    size = torch.tensor([], dtype=dtype).element_size()
    buf = torch.zeros(n * d + offset_bytes // size + 64, dtype=dtype)
    start = (-buf.data_ptr() % 64 + offset_bytes) // size
    view = buf[start:start + n * d].view(n, d)
    assert view.data_ptr() % 64 == offset_bytes % 64
    return view


@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 64, 128, 136])
def test_sixteen_byte_lanes_for_d_multiple_of_8_on_aligned_rows(d):
    assert bf16_form(d, _rows(5, d)) == 16
    assert bf16_form(d, _rows(5, d), _rows(7, d), _rows(1, d)) == 16


@pytest.mark.parametrize("d", [4, 12, 20, 36, 100])
def test_eight_byte_lanes_for_d_4_mod_8(d):
    assert bf16_form(d, _rows(5, d)) == 8
    assert bf16_form(d, _rows(5, d, offset_bytes=8)) == 8


@pytest.mark.parametrize("d", [8, 32, 64])
def test_eight_byte_lanes_for_rows_aligned_to_8_bytes(d):
    assert bf16_form(d, _rows(5, d, offset_bytes=8)) == 8
    # one region aligned to 8 bytes takes all three to the 8-byte lanes
    assert bf16_form(d, _rows(5, d), _rows(5, d, offset_bytes=24),
                     _rows(5, d)) == 8


@pytest.mark.parametrize("d,offset", [(2, 0), (6, 0), (10, 0), (32, 4),
                                      (32, 2), (12, 4), (8, 6)])
def test_no_bf16_form(d, offset):
    assert bf16_form(d, _rows(5, d, offset_bytes=offset)) == 0


def test_form_reads_only_d_and_alignment():
    """The row count, the dtype and the values do not move the choice."""
    for n in (1, 3, 1000):
        assert bf16_form(32, _rows(n, 32)) == 16
        assert bf16_form(32, _rows(n, 32, offset_bytes=8)) == 8
    assert bf16_form(32, _rows(4, 32, dtype=torch.float32)) == 16
    assert bf16_form(32, _rows(4, 32, offset_bytes=8,
                                dtype=torch.float32)) == 8
    # f32's vector form asks 16 bytes whatever the lane width
    assert vector_form(32, _rows(4, 32, dtype=torch.float32))
    assert not vector_form(32, _rows(4, 32, offset_bytes=8,
                                     dtype=torch.float32))


@pytest.mark.parametrize("offset", [0, 8])
@pytest.mark.parametrize("d", [12, 32])
def test_cpu_wrappers_run_the_twins_on_any_form(d, offset):
    """On CPU tensors ``csr_gather_sum`` and ``csr_segment_sum3`` give
    their twins' results for rows of either lane width, into f32 and bf16."""
    rng = np.random.default_rng(d + offset)
    m = 37
    rows = _rows(3 * m, d, offset_bytes=offset)
    rows.copy_(torch.from_numpy(rng.standard_normal((3 * m, d))).to(BF16))
    counts = rng.integers(0, 6, 20)
    rowptr = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])
                              .astype(np.int32))
    col = torch.from_numpy(rng.integers(0, 3 * m, int(counts.sum()))
                           .astype(np.int32))
    for out_dtype in (None, BF16):
        want = csr_gather_sum_plain(rows, col, rowptr, out_dtype=out_dtype)
        assert torch.equal(csr_gather_sum(rows, col, rowptr,
                                          out_dtype=out_dtype), want)
        regions = (rows[:m], rows[m:2 * m], rows[2 * m:])
        assert torch.equal(
            csr_segment_sum3(*regions, col, rowptr, out_dtype),
            csr_segment_sum3_plain(*regions, col, rowptr, out_dtype))
        assert torch.equal(
            csr_segment_sum3(*regions, col, rowptr, out_dtype), want)
