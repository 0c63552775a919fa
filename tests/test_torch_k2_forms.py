"""K2's bf16 form (``ihgnn_torch.ops.gather``): the identity its design
rests on, and its choice of copy width.

From an f32 x the card's form first rounds x into a bf16 table, then
copies rows of the table; the form it replaced rounded each value as it
copied it. Rounding to nearest even is elementwise, so the two give the
same bits: ``x.to(bf16)[ids] == x[ids].to(bf16)``. The tests hold that
identity on values that stress the rounding (ties either way, subnormals,
±inf, the largest finite values, values that round up to inf), against a
bit-level emulation of round-to-nearest-even and against JAX's cast (the
one the JAX package makes before its gather, ``ops/hyperagg.py``). The
copy width, from x and the three output planes (16 bytes for d % 8 == 0
on 16-byte aligned rows, else 8 for d % 4 == 0 on 8-byte aligned rows,
else none), is K1's lane rule (``ops/segsum.py`` ``bf16_form``), which
the wrapper and ``csrc/gather.cu`` apply; the forms themselves are held
on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihgnn_torch.ops.gather import gather_roles, gather_roles_plain
from ihgnn_torch.ops.segsum import bf16_form

BF16 = torch.bfloat16


def _rne_bf16_bits(x: np.ndarray) -> np.ndarray:
    """The bf16 bits of f32 ``x`` rounded to nearest even, from the f32
    bits alone (NaN kept quiet)."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    nan = np.isnan(x)
    rounded[nan] = (bits[nan] >> 16) | 0x40
    return rounded.astype(np.uint16)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _hard_values() -> np.ndarray:
    """f32 values at the edges of the bf16 rounding, and random ones."""
    f = np.float32
    one = f(1.0)
    ulp = np.float32(2.0 ** -7)          # a bf16 ulp at 1
    tiny = np.finfo(np.float32).tiny
    vals = [
        0.0, -0.0, one, -one,
        one + ulp / 2,                   # tie, rounds down to even
        one + 3 * ulp / 2,               # tie, rounds up to even
        one + ulp / 2 + np.float32(2.0 ** -23),   # just above a tie
        one + ulp / 2 - np.float32(2.0 ** -23),   # just below a tie
        tiny, -tiny, tiny / 2, tiny * 0.75,       # normal and subnormals
        np.float32(1e-45), np.float32(-3e-44),    # the smallest subnormals
        np.inf, -np.inf,
        np.finfo(np.float32).max, -np.finfo(np.float32).max,  # to ±inf
        np.float32(3.3895314e38),        # the largest finite bf16
        np.float32(65504.0), np.float32(-1.5e30), np.float32(7.0e-39),
    ]
    rng = np.random.default_rng(13)
    rand = np.concatenate([
        rng.standard_normal(200),
        rng.standard_normal(100) * 1e30,
        rng.standard_normal(100) * 1e-38,
        rng.integers(-2**31, 2**31, 200).astype(np.int64).astype(np.uint32)
        .view(np.float32)[:200],         # any bit pattern (NaN dropped)
    ]).astype(np.float32)
    rand = rand[~np.isnan(rand)]
    return np.concatenate([np.asarray(vals, np.float32), rand])


def _table(d: int) -> np.ndarray:
    vals = _hard_values()
    n = -(-len(vals) // d) + 3
    out = np.resize(vals, n * d).reshape(n, d)
    out[-1] = vals[-d:]                  # the last row is read too
    return out


def _ids(n: int, edges: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, (edges, 3)).astype(np.int32)
    ids[0] = 0
    ids[-1] = n - 1
    return ids


@pytest.mark.parametrize("d", [8, 12, 32, 64])
def test_table_then_copy_equals_rounding_in_the_copy(d):
    """Gathering rows of the rounded table gives the bits of rounding each
    gathered value: the identity K2's bf16 redesign rests on."""
    x = torch.from_numpy(_table(d))
    i3 = torch.from_numpy(_ids(x.shape[0], 1025, d)).long()
    table_then_copy = x.to(BF16)[i3.t()]
    round_in_copy = x[i3.t()].to(BF16)
    assert np.array_equal(_bits(table_then_copy), _bits(round_in_copy))


@pytest.mark.parametrize("d", [8, 12, 32, 64])
def test_rounding_is_nearest_even(d):
    """PyTorch's cast, which the wrapper's twin and the card's rounding
    kernel both apply, is round to nearest even, ties to even, overflow to
    ±inf, subnormals kept."""
    x = _table(d)
    got = _bits(torch.from_numpy(x).to(BF16))
    assert np.array_equal(got, _rne_bf16_bits(x))


@pytest.mark.parametrize("d", [8, 12, 32, 64])
def test_gather_roles_bf16_twin_matches_jax_cast(d):
    """``gather_roles(x, i3, bf16)`` on the CPU (its twin) gives the bits of
    JAX's bf16 cast of x gathered, from an f32 x and from a bf16 x."""
    x = _table(d)
    i3 = _ids(x.shape[0], 333, 7 * d)
    jax_rows = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)[i3.T]).view(
        np.uint16)
    xt, i3t = torch.from_numpy(x), torch.from_numpy(i3)
    for rows in (xt, xt.to(BF16)):
        got = gather_roles(rows, i3t, BF16)
        assert got.dtype == BF16 and got.shape == (3, 333, d)
        assert np.array_equal(_bits(got), jax_rows)
        assert torch.equal(got, gather_roles_plain(rows, i3t, BF16))


def _rows(n, d, offset_bytes=0, dtype=BF16):
    """``[n, d]`` contiguous rows beginning ``offset_bytes`` past a 64-byte
    aligned allocation."""
    size = torch.tensor([], dtype=dtype).element_size()
    buf = torch.zeros(n * d + offset_bytes // size + 64, dtype=dtype)
    start = (-buf.data_ptr() % 64 + offset_bytes) // size
    view = buf[start:start + n * d].view(n, d)
    assert view.data_ptr() % 64 == offset_bytes % 64
    return view


@pytest.mark.parametrize("d", [8, 16, 32, 64, 136])
def test_sixteen_byte_copies_for_d_multiple_of_8_on_aligned_rows(d):
    out = torch.empty(3, 5, d, dtype=BF16)
    assert bf16_form(d, _rows(7, d), *out) == 16


@pytest.mark.parametrize("d", [4, 12, 20, 36])
def test_eight_byte_copies_for_d_4_mod_8(d):
    out = torch.empty(3, 5, d, dtype=BF16)
    assert bf16_form(d, _rows(7, d), *out) == 8
    assert bf16_form(d, _rows(7, d, offset_bytes=8), *out) == 8


@pytest.mark.parametrize("d", [8, 32, 64])
def test_eight_byte_copies_for_rows_aligned_to_8_bytes(d):
    out = torch.empty(3, 5, d, dtype=BF16)
    assert bf16_form(d, _rows(7, d, offset_bytes=8), *out) == 8
    # one output plane aligned to 8 bytes takes the copy to 8 bytes too
    assert bf16_form(d, _rows(7, d), out[0], out[1],
                     _rows(5, d, offset_bytes=24)) == 8


@pytest.mark.parametrize("d,offset", [(2, 0), (6, 0), (10, 0), (32, 4),
                                      (32, 2), (12, 4), (8, 6)])
def test_no_copy_form(d, offset):
    assert bf16_form(d, _rows(7, d, offset_bytes=offset)) == 0


def test_copy_form_reads_only_d_and_alignment():
    """The row count and the values do not move the choice."""
    for n in (1, 3, 1000):
        assert bf16_form(32, _rows(n, 32)) == 16
        assert bf16_form(32, _rows(n, 32, offset_bytes=8)) == 8
        assert bf16_form(12, _rows(n, 12)) == 8
    assert bf16_form(32, _rows(4, 32).fill_(7.0)) == 16
