"""K3: the fused hyperedge feature interaction, its backward, their plain
twins, and the autograd Function that joins them.

  out[e, :] = b + Σ_j part_j[e, :] · W[j·d:(j+1)·d, :]
  parts = [u, q, i]                                   (order 1)
        + [u⊙q, q⊙i, i⊙u]                              (order 2)
        + [u⊙q⊙i]                                      (order 3)

Counterpart of ``ihgnn_tpu/ops/pallas/interact.py`` ``interact_fwd``,
``interact_bwd`` and the custom VJP ``fused_interaction``; the part order
is that of ``_parts`` there (Models/CommonLayers.py:58-85). Both kernels
keep every part (and every dpart) on chip: none is written to device
memory. The forward has two forms, chosen from the shape alone
(``interact_fwd_form``): on the tensor cores in 3xTF32 from staged edge
tiles (d % 8 == 0, every width the model uses), and on the f32 cores,
one thread an edge (any other d % 4 == 0). The backward writes du/dq/di
into one ``[3, E, d]`` buffer; ``InteractFn`` takes the roles as one
``[3, E, d]`` tensor (as the gather gives them) and returns that buffer
as their gradient, which the gather's backward (``ops/hyperagg.py``)
reads as ``[3E, d]``.

Layout: ``u``/``q``/``i`` row-major ``[E, d]`` f32, ``w`` ``[parts·d, out]``
(the flax kernel layout, ``Linear.weight.T``), ``b`` ``[out]``; the result
is ``[E, out]`` f32. The TPU pads E to a multiple of its block; here the
ragged tail is masked, so E is any size.

bf16 streams (``ModelConfig.bf16_stream``): with bf16 u, q, i (and cot),
``interact_fwd`` and ``interact_bwd`` compute the Pallas kernels' bf16
contract (``ihgnn_tpu/ops/pallas/interact.py:40-125``): the parts u⊙q, q⊙i
and i⊙u each rounded to bf16, u⊙q⊙i = round(round(u⊙q)⊙i), W rounded to
bf16, every product accumulated in f32; the forward's ``out + b`` rounded to
a bf16 ``[E, out]``; the backward's product rule in f32 on the widened u,
q, i, with du, dq, di rounded to bf16 once and dW, db in f32. On the card
each is one bf16 ``mma.sync`` pass (d % 8 == 0), counted in the wrapper's
``launches_bf16``; the plain twins emulate the rounding points in f32. W and
b stay f32. K5 (the routed path's absorbed interaction) has the same bf16
forms, with the Pallas absorb kernels' merge: c1 + π(c2) rounded to bf16
once, then masked (``ihgnn_tpu/ops/pallas/interact.py:203-227``).
"""

from __future__ import annotations

import ctypes

import torch

from ihgnn_torch.ops import _build

ORDER_PARTS = {1: 3, 2: 6, 3: 7}
KERNEL_OUT_DIMS = (8, 16, 32, 64)     # instantiated in csrc/interact*.cu
SMEM_LIMIT = 232_448                  # bytes of shared memory per block
# edges summed into one dW/db partial by csrc/interact_bwd.cu's fused
# kernel (interact_bwd and K5's interact_bwd_absorb); a multiple of its
# 32-edge tile. The partials are summed in a fixed order, so the result
# depends on E and this constant only.
CHUNK_EDGES = 1024

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check_weights(what: str, u: torch.Tensor, w: torch.Tensor,
                   order: int) -> None:
    if order not in ORDER_PARTS:
        raise ValueError(f"{what}: order must be 1, 2 or 3, got {order}")
    d = u.shape[1]
    if w.dim() != 2 or w.shape[0] != ORDER_PARTS[order] * d:
        raise ValueError(f"{what}: w {tuple(w.shape)} does not fit order "
                         f"{order} at d = {d}")


def _require_kernel_inputs(what: str, streams, params, u, q, i, w,
                           bf16_form: bool = True) -> bool:
    """What the kernels take: the edge streams ``streams`` (the roles, and
    the cotangents) contiguous and 16-byte aligned, all f32 or all bf16
    (bf16 only where ``bf16_form``), the parameters ``params`` (W, b)
    contiguous 16-byte aligned f32, one [E, d] shape for the roles with
    d % 4 == 0 (d % 8 == 0 in bf16), an instantiated output width and a W
    that fits in one block's shared memory. Returns whether the streams
    are bf16."""
    dtype = u.dtype
    _build.require(dtype == torch.float32
                   or (bf16_form and dtype == torch.bfloat16), what,
                   "the edge streams must be f32" + (
                       " or bf16" if bf16_form else
                       " (this kernel has no bf16 form)"))
    for t in streams:
        _build.require(t.dtype == dtype and t.is_contiguous()
                       and t.data_ptr() % 16 == 0, what,
                       f"edge streams must be contiguous, 16-byte aligned "
                       f"{dtype}, one dtype for all")
    for t in params:
        _build.require(t.dtype == torch.float32 and t.is_contiguous()
                       and t.data_ptr() % 16 == 0, what,
                       "w and b must be contiguous, 16-byte aligned f32")
    _build.require(q.shape == u.shape and i.shape == u.shape, what,
                   "u, q and i must have one shape [E, d]")
    _build.require(u.shape[1] % 4 == 0, what, "d must be a multiple of 4")
    bf16 = dtype == torch.bfloat16
    if bf16:
        _build.require(u.shape[1] % 8 == 0, what,
                       "the bf16 forms copy 16-byte row pieces: d must be a "
                       "multiple of 8")
    _build.require(w.shape[1] in KERNEL_OUT_DIMS, what,
                   f"out must be one of {KERNEL_OUT_DIMS}")
    _build.require(w.numel() * 4 <= SMEM_LIMIT, what,
                   "W does not fit in one block's shared memory")
    _build.require(u.numel() < 2 ** 31, what, "E * d must fit in int32")
    return bf16


def interact_parts(u, q, i, order: int):
    parts = [u, q, i]
    if order >= 2:
        parts += [u * q, q * i, i * u]
    if order >= 3:
        parts.append(parts[3] * i)     # u⊙q⊙i
    return parts


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even), held in f32."""
    return x.to(torch.bfloat16).float()


def interact_parts_bf16(u, q, i, order: int):
    """The bf16 contract's parts of bf16 ``u``, ``q``, ``i``, in f32: the
    roles widened, each product rounded to bf16, u⊙q⊙i =
    round(round(u⊙q)⊙i). A product of two bf16 values is exact in f32, so
    one rounding after the f32 product is the bf16 product."""
    u, q, i = u.float(), q.float(), i.float()
    parts = [u, q, i]
    if order >= 2:
        parts += [_bf16_round(u * q), _bf16_round(q * i),
                  _bf16_round(i * u)]
    if order >= 3:
        parts.append(_bf16_round(parts[3] * i))
    return parts


def interact_fwd_plain(u: torch.Tensor, q: torch.Tensor, i: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor,
                       order: int) -> torch.Tensor:
    """Plain PyTorch twin of ``interact_fwd``: one matmul per part, summed
    (any device). bf16 roles follow the bf16 contract in f32 arithmetic
    with its rounding points written out (parts and W rounded to bf16,
    ``out + b`` rounded to bf16), not through a bf16 matmul, whose
    accumulation would be the library's own choice."""
    d = u.shape[1]
    bf16 = u.dtype == torch.bfloat16
    if bf16:
        parts, w = interact_parts_bf16(u, q, i, order), _bf16_round(w)
    else:
        parts = interact_parts(u, q, i, order)
    out = None
    for j, p in enumerate(parts):
        y = p @ w[j * d:(j + 1) * d]
        out = y if out is None else out + y
    out = out + b
    return out.to(torch.bfloat16) if bf16 else out


def interact_fwd_form(d: int, out_dim: int, order: int) -> str:
    """K3's form for the shape, as ``csrc/interact.cu`` picks it:
    ``"tensor_cores"`` (3xTF32 on ``mma.sync``, d % 8 == 0 when W's split
    and one warp's ring fit in shared memory) or ``"f32_cores"`` (any
    other d % 4 == 0). Asks the built library, so it needs nvcc."""
    fn = _build.function("interact", "ihgnn_interact_fwd_form",
                         [ctypes.c_int] * 3)
    return "tensor_cores" if fn(d, out_dim, order) else "f32_cores"


def _fwd(wrapper, entry: str, u, q, i, w, b, order: int,
         bf16_entry=None) -> torch.Tensor:
    """The checks, the plain twin on the CPU and the launch of C entry
    point ``entry`` (``bf16_entry`` for bf16 roles, where the wrapper has a
    bf16 form) for ``interact_fwd`` and ``interact_fwd_cores``; one launch
    counts in ``wrapper.launches`` (``wrapper.launches_bf16``)."""
    what = wrapper.__name__
    _check_weights(what, u, w, order)
    if b.shape != (w.shape[1],):
        raise ValueError(f"{what}: b {tuple(b.shape)} does not fit w "
                         f"{tuple(w.shape)}")
    if not _build.use_kernel(what, u, q, i, w, b):
        return interact_fwd_plain(u, q, i, w, b, order)
    bf16 = _require_kernel_inputs(what, (u, q, i), (w, b), u, q, i, w,
                                  bf16_form=bf16_entry is not None)
    (e, d), out_dim = u.shape, w.shape[1]
    out = torch.empty(e, out_dim, dtype=u.dtype, device=u.device)
    if e == 0:
        return out
    fn = _build.function("interact", bf16_entry if bf16 else entry,
                         _ARGTYPES)
    err = fn(u.data_ptr(), q.data_ptr(), i.data_ptr(), w.data_ptr(),
             b.data_ptr(), out.data_ptr(), e, d, out_dim, order,
             _build.stream_ptr(u.device))
    _build.check("interact", what, err)
    _build.count(wrapper, bf16)
    return out


def interact_fwd(u: torch.Tensor, q: torch.Tensor, i: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor, order: int) -> torch.Tensor:
    """``[E, out]`` interaction projection of the (u, q, i) role rows, in
    the roles' dtype. CPU tensors run the plain twin; CUDA tensors launch
    ``csrc/interact.cu``: for f32 roles in the form ``interact_fwd_form``
    names, counted in ``interact_fwd.launches``; for bf16 roles its bf16
    form (d % 8 == 0), counted in ``interact_fwd.launches_bf16``."""
    return _fwd(interact_fwd, "ihgnn_interact_fwd", u, q, i, w, b, order,
                bf16_entry="ihgnn_interact_fwd_bf16")


interact_fwd.launches = 0
interact_fwd.launches_bf16 = 0


def interact_fwd_cores(u: torch.Tensor, q: torch.Tensor, i: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor,
                       order: int) -> torch.Tensor:
    """``interact_fwd`` in K3's f32-core form whatever the shape, for its
    card tests and its time beside the tensor-core form; counts in
    ``interact_fwd_cores.launches``. No model path calls it."""
    return _fwd(interact_fwd_cores, "ihgnn_interact_fwd_cores", u, q, i, w,
                b, order)


interact_fwd_cores.launches = 0


def interact_bwd_plain(u: torch.Tensor, q: torch.Tensor, i: torch.Tensor,
                       w: torch.Tensor, cot: torch.Tensor, order: int):
    """Plain PyTorch twin of ``interact_bwd``: one matmul per part for the
    dparts and for dW, then the product rule as ``_bwd_kernel`` writes it
    (``ihgnn_tpu/ops/pallas/interact.py:284-294``). Any device. bf16 roles
    and cot follow the bf16 contract in f32 arithmetic (W and the parts
    rounded to bf16, the product rule on the widened roles, du, dq, di
    rounded to bf16 once)."""
    d = u.shape[1]
    bf16 = u.dtype == torch.bfloat16
    if bf16:
        parts = interact_parts_bf16(u, q, i, order)
        w, cot = _bf16_round(w), cot.float()
        u, q, i = u.float(), q.float(), i.float()
    else:
        parts = interact_parts(u, q, i, order)
    dparts = [cot @ w[j * d:(j + 1) * d].t() for j in range(len(parts))]
    dw = torch.cat([p.t() @ cot for p in parts])
    db = cot.sum(0)
    du, dq, di = dparts[0], dparts[1], dparts[2]
    if order >= 2:
        du = du + (dparts[3] * q + dparts[5] * i)
        dq = dq + (dparts[3] * u + dparts[4] * i)
        di = di + (dparts[4] * q + dparts[5] * u)
    if order >= 3:
        du = du + dparts[6] * (q * i)
        dq = dq + dparts[6] * (u * i)
        di = di + dparts[6] * (u * q)
    droles = torch.stack([du, dq, di])
    return (droles.to(torch.bfloat16) if bf16 else droles), dw, db


def interact_bwd(u: torch.Tensor, q: torch.Tensor, i: torch.Tensor,
                 w: torch.Tensor, cot: torch.Tensor, order: int):
    """``(droles, dw, db)`` of ``interact_fwd`` for the output cotangent
    ``cot`` ``[E, out]``: droles is ``[3, E, d]`` (planes du, dq, di), dw
    ``[parts·d, out]`` and db ``[out]``. CPU tensors run the plain twin;
    CUDA tensors launch ``csrc/interact_bwd.cu`` (its fused kernel, on the
    tensor cores in 3xTF32) and count one in ``interact_bwd.launches``. W
    is staged in shared memory when it fits beside the edge tiles, else
    read from device memory; a shape whose edge tiles alone do not fit
    (d above 268 to 288, by out) is refused by the C entry point, and the
    wrapper raises. bf16 u, q, i and cot (droles bf16, dW and db f32) run
    the bf16 form, one bf16 ``mma.sync`` pass, counted in
    ``interact_bwd.launches_bf16``; it takes d % 8 == 0 when W, the staged
    du, dq, di rows and two 64-edge stages fit in one block's shared
    memory (d up to 120 at out = 32, order 3; 88 at out = 64), and the C
    entry point refuses other shapes."""
    what = "interact_bwd"
    _check_weights(what, u, w, order)
    if cot.shape != (u.shape[0], w.shape[1]):
        raise ValueError(f"{what}: cot {tuple(cot.shape)} is not "
                         f"[{u.shape[0]}, {w.shape[1]}]")
    if not _build.use_kernel(what, u, q, i, w, cot):
        return interact_bwd_plain(u, q, i, w, cot, order)
    bf16 = _require_kernel_inputs(what, (u, q, i, cot), (w,), u, q, i, w)
    (e, d), out_dim = u.shape, w.shape[1]
    rows = w.shape[0]
    droles = torch.empty(3, e, d, dtype=u.dtype, device=u.device)
    # dW then db as one [parts·d + 1, out] buffer
    dw_ext = torch.empty(rows + 1, out_dim, dtype=torch.float32,
                         device=u.device)
    if e == 0:
        dw_ext.zero_()
    else:
        chunks = -(-e // CHUNK_EDGES)
        partial = torch.empty(chunks, rows + 1, out_dim, dtype=torch.float32,
                              device=u.device)
        fn = _build.function("interact_bwd", "ihgnn_interact_bwd_bf16"
                             if bf16 else "ihgnn_interact_bwd", _BWD_ARGTYPES)
        err = fn(u.data_ptr(), q.data_ptr(), i.data_ptr(), w.data_ptr(),
                 cot.data_ptr(), droles.data_ptr(), partial.data_ptr(),
                 dw_ext.data_ptr(), e, d, out_dim, order, CHUNK_EDGES,
                 _build.stream_ptr(u.device))
        _build.check("interact_bwd", what, err)
        _build.count(interact_bwd, bf16)
    return droles, dw_ext[:rows], dw_ext[rows]


interact_bwd.launches = 0
interact_bwd.launches_bf16 = 0


class InteractFn(torch.autograd.Function):
    """``interact_fwd`` with ``interact_bwd`` as its backward: the
    counterpart of the custom VJP ``fused_interaction``
    (``ihgnn_tpu/ops/pallas/interact.py:566-581``)."""

    @staticmethod
    def forward(ctx, roles, w, b, order: int):
        """``roles`` ``[3, E, d]`` (u, q, i) → ``[E, out]``."""
        ctx.order = order
        ctx.save_for_backward(roles, w)
        return interact_fwd(roles[0], roles[1], roles[2], w, b, order)

    @staticmethod
    def backward(ctx, cot):
        roles, w = ctx.saved_tensors
        droles, dw, db = interact_bwd(roles[0], roles[1], roles[2], w,
                                      cot.contiguous(), ctx.order)
        return droles, dw, db, None


# ---------------------------------------------------------------------------
# K5: the absorbed interaction of the routed path
# ---------------------------------------------------------------------------
#
# ``ihgnn_tpu/ops/pallas/interact.py`` ``interact_fwd_absorb`` (``:397``),
# ``interact_bwd_absorb`` (``:422``) and the custom VJP
# ``fused_interaction_absorb`` (``:591-616``). The E edges form an
# ``[R, C]`` grid in σ order; the i role arrives one row-local stage early
# (t1 order), and ``pi`` ``[R, C]`` is that stage (the routed pack's
# ``i.p2``), ρ = π⁻¹ row-locally. With e = r·C + c and e_π = r·C + π[r, c]:
#
#   forward:  i_σ[e] = i_t1[e_π];  o1 = interact(u, q, i_σ);  o2[e_π] = o1[e]
#             (o2 = ρ(o1), the first stage of the scatter's i chain);
#   backward: cot[e] = (c1[e] + c2[e_π])·mask[e] (the σ pads masked);
#             du, dq, dW, db as ``interact_bwd`` on cot; di_t1[e_π] = di_σ[e].
#
# On the card π is one index load an edge inside K3's kernels
# (``csrc/interact.cu``, ``csrc/interact_bwd.cu``, ABSORB); the backward
# is ``interact_bwd``'s fused kernel with i and c2 read through π.

_FWD_ABSORB_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]
_BWD_ABSORB_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]


def _permuted_edges(pi: torch.Tensor) -> torch.Tensor:
    """``[E]`` int64 e_π = r·C + π[r, c] of every edge e = r·C + c."""
    rows, cols = pi.shape
    base = torch.arange(rows, device=pi.device)[:, None] * cols
    return (base + pi.long()).reshape(-1)


def _check_absorb(what: str, u: torch.Tensor, pi: torch.Tensor) -> None:
    if pi.dim() != 2 or pi.numel() != u.shape[0]:
        raise ValueError(f"{what}: pi {tuple(pi.shape)} is not an [R, C] "
                         f"grid of the {u.shape[0]} edges")


def interact_fwd_absorb_plain(u, q, i_t1, pi, w, b, order: int):
    """Plain twin of ``interact_fwd_absorb`` (any device); bf16 roles follow
    ``interact_fwd_plain``'s bf16 contract, and o2 is a copy of the bf16
    o1."""
    e_pi = _permuted_edges(pi)
    o1 = interact_fwd_plain(u, q, i_t1[e_pi], w, b, order)
    o2 = torch.empty_like(o1)
    o2[e_pi] = o1
    return o1, o2


def _fwd_absorb(wrapper, entry: str, u, q, i_t1, pi, w, b, order: int,
                bf16_entry=None):
    """``_fwd`` for ``interact_fwd_absorb`` and
    ``interact_fwd_absorb_cores``."""
    what = wrapper.__name__
    _check_weights(what, u, w, order)
    _check_absorb(what, u, pi)
    if b.shape != (w.shape[1],):
        raise ValueError(f"{what}: b {tuple(b.shape)} does not fit w "
                         f"{tuple(w.shape)}")
    if not _build.use_kernel(what, u, q, i_t1, pi, w, b):
        return interact_fwd_absorb_plain(u, q, i_t1, pi, w, b, order)
    bf16 = _require_kernel_inputs(what, (u, q, i_t1), (w, b), u, q, i_t1,
                                  w, bf16_form=bf16_entry is not None)
    _build.require(pi.dtype == torch.int32 and pi.is_contiguous(), what,
                   "pi must be a contiguous int32 table")
    (e, d), out_dim = u.shape, w.shape[1]
    o1 = torch.empty(e, out_dim, dtype=u.dtype, device=u.device)
    o2 = torch.empty_like(o1)
    if e == 0:
        return o1, o2
    fn = _build.function("interact", bf16_entry if bf16 else entry,
                         _FWD_ABSORB_ARGTYPES)
    err = fn(u.data_ptr(), q.data_ptr(), i_t1.data_ptr(), pi.data_ptr(),
             w.data_ptr(), b.data_ptr(), o1.data_ptr(), o2.data_ptr(), e, d,
             out_dim, order, pi.shape[1], _build.stream_ptr(u.device))
    _build.check("interact", what, err)
    _build.count(wrapper, bf16)
    return o1, o2


def interact_fwd_absorb(u: torch.Tensor, q: torch.Tensor, i_t1: torch.Tensor,
                        pi: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        order: int):
    """``(o1, o2)``, each ``[E, out]``: the interaction of the σ-ordered
    ``u``/``q`` and the t1-ordered ``i_t1`` read through ``pi``, and
    ``o1`` permuted by ρ = π⁻¹, in the roles' dtype. CPU tensors run the
    plain twin; CUDA tensors launch ``csrc/interact.cu``: for f32 roles in
    the form ``interact_fwd_form`` names, counted in
    ``interact_fwd_absorb.launches``; for bf16 roles its bf16 form (d % 8
    == 0), counted in ``interact_fwd_absorb.launches_bf16``."""
    return _fwd_absorb(interact_fwd_absorb, "ihgnn_interact_fwd_absorb", u,
                       q, i_t1, pi, w, b, order,
                       bf16_entry="ihgnn_interact_fwd_absorb_bf16")


interact_fwd_absorb.launches = 0
interact_fwd_absorb.launches_bf16 = 0


def interact_fwd_absorb_cores(u, q, i_t1, pi, w, b, order: int):
    """``interact_fwd_absorb`` in K3's f32-core form whatever the shape,
    as ``interact_fwd_cores``; counts in
    ``interact_fwd_absorb_cores.launches``."""
    return _fwd_absorb(interact_fwd_absorb_cores,
                       "ihgnn_interact_fwd_absorb_cores", u, q, i_t1, pi, w,
                       b, order)


interact_fwd_absorb_cores.launches = 0


def _merged_cotangent(c1, c2, e_pi, mask):
    """(c1 + c2[e_π])·mask in the cotangents' dtype: in bf16 the sum is
    rounded once, then masked (0 or 1, exact), as the Pallas kernel merges
    it."""
    cot = c1 + c2[e_pi]
    if mask is not None:
        cot = cot * mask[:, None].to(cot.dtype)
    return cot


def interact_bwd_absorb_plain(u, q, i_t1, pi, w, c1, c2, mask, order: int):
    """Plain twin of ``interact_bwd_absorb`` (any device); bf16 roles and
    cotangents follow ``interact_bwd_plain``'s bf16 contract on the merged
    bf16 cotangent."""
    e_pi = _permuted_edges(pi)
    cot = _merged_cotangent(c1, c2, e_pi, mask)
    droles, dw, db = interact_bwd_plain(u, q, i_t1[e_pi], w, cot, order)
    di_t1 = torch.empty_like(droles[2])
    di_t1[e_pi] = droles[2]
    return torch.stack([droles[0], droles[1], di_t1]), dw, db


def interact_bwd_absorb_via_direct(u, q, i_t1, pi, w, c1, c2, mask,
                                   order: int):
    """K5's backward through ``interact_bwd`` on the pre-permuted inputs:
    i_t1[e_π] and the merged cotangent (c1 + c2[e_π])·mask, with di
    scattered back to t1 order. Both kernels run the same arithmetic over
    the same σ-ordered edges in the same chunks, so on the card this gives
    bit for bit what ``interact_bwd_absorb`` gives: the identity that
    ``chip_smoke.py``, ``compare_builds`` and the card tests hold K5's
    backward to; bf16 inputs run both bf16 forms. Counts in
    ``interact_bwd.launches`` (``launches_bf16``)."""
    e_pi = _permuted_edges(pi)
    cot = _merged_cotangent(c1, c2, e_pi, mask)
    droles, dw, db = interact_bwd(u, q, i_t1[e_pi], w, cot, order)
    di_t1 = torch.empty_like(droles[2])
    di_t1[e_pi] = droles[2]
    return torch.stack([droles[0], droles[1], di_t1]), dw, db


def interact_bwd_absorb(u: torch.Tensor, q: torch.Tensor, i_t1: torch.Tensor,
                        pi: torch.Tensor, w: torch.Tensor, c1: torch.Tensor,
                        c2: torch.Tensor, mask, order: int):
    """``(droles, dw, db)`` of ``interact_fwd_absorb`` for the cotangents
    ``c1`` of o1 and ``c2`` of o2 (each ``[E, out]``), the merged
    cotangent zeroed where ``mask`` ``[E]`` is 0 (None: no mask): droles
    ``[3, E, d]`` holds du, dq (σ order) and di for ``i_t1`` (t1 order).
    CPU tensors run the plain twin; CUDA tensors launch
    ``csrc/interact_bwd.cu`` (the fused kernel of ``interact_bwd``, reading
    i and c2 through π) and count one in
    ``interact_bwd_absorb.launches``; bf16 roles and cotangents (droles
    bf16, dW and db f32) run its bf16 form, counted in
    ``interact_bwd_absorb.launches_bf16``."""
    what = "interact_bwd_absorb"
    _check_weights(what, u, w, order)
    _check_absorb(what, u, pi)
    for name, c in (("c1", c1), ("c2", c2)):
        if c.shape != (u.shape[0], w.shape[1]):
            raise ValueError(f"{what}: {name} {tuple(c.shape)} is not "
                             f"[{u.shape[0]}, {w.shape[1]}]")
    if mask is not None and mask.shape != (u.shape[0],):
        raise ValueError(f"{what}: mask {tuple(mask.shape)} is not "
                         f"[{u.shape[0]}]")
    if not _build.use_kernel(what, u, q, i_t1, pi, w, c1, c2, mask):
        return interact_bwd_absorb_plain(u, q, i_t1, pi, w, c1, c2, mask,
                                         order)
    bf16 = _require_kernel_inputs(what, (u, q, i_t1, c1, c2), (w,), u, q,
                                  i_t1, w)
    _build.require(pi.dtype == torch.int32 and pi.is_contiguous(), what,
                   "pi must be a contiguous int32 table")
    if mask is not None:
        _build.require(mask.dtype == torch.float32 and mask.is_contiguous(),
                       what, "mask must be contiguous f32")
    (e, d), out_dim = u.shape, w.shape[1]
    rows = w.shape[0]
    droles = torch.empty(3, e, d, dtype=u.dtype, device=u.device)
    dw_ext = torch.empty(rows + 1, out_dim, dtype=torch.float32,
                         device=u.device)
    if e == 0:
        dw_ext.zero_()
    else:
        chunks = -(-e // CHUNK_EDGES)
        partial = torch.empty(chunks, rows + 1, out_dim, dtype=torch.float32,
                              device=u.device)
        fn = _build.function("interact_bwd", "ihgnn_interact_bwd_absorb_bf16"
                             if bf16 else "ihgnn_interact_bwd_absorb",
                             _BWD_ABSORB_ARGTYPES)
        err = fn(u.data_ptr(), q.data_ptr(), i_t1.data_ptr(), pi.data_ptr(),
                 w.data_ptr(), c1.data_ptr(), c2.data_ptr(),
                 None if mask is None else mask.data_ptr(), droles.data_ptr(),
                 partial.data_ptr(), dw_ext.data_ptr(), e, d, out_dim, order,
                 pi.shape[1], CHUNK_EDGES, _build.stream_ptr(u.device))
        _build.check("interact_bwd", what, err)
        _build.count(interact_bwd_absorb, bf16)
    return droles, dw_ext[:rows], dw_ext[rows]


interact_bwd_absorb.launches = 0
interact_bwd_absorb.launches_bf16 = 0


class InteractAbsorbFn(torch.autograd.Function):
    """``interact_fwd_absorb`` with ``interact_bwd_absorb`` as its
    backward: the counterpart of ``fused_interaction_absorb``
    (``ihgnn_tpu/ops/pallas/interact.py:591-616``). ``pi`` and ``mask``
    are graph structure and get no gradient. bf16 roles give bf16 outputs
    and bf16 role gradients, as ``InteractFn``."""

    @staticmethod
    def forward(ctx, roles, w, b, pi, mask, order: int):
        """``roles`` ``[3, E, d]`` (u and q in σ order, i in t1 order) →
        ``(o1, o2)``."""
        ctx.order = order
        ctx.save_for_backward(roles, w, pi, mask)
        return interact_fwd_absorb(roles[0], roles[1], roles[2], pi, w, b,
                                   order)

    @staticmethod
    def backward(ctx, c1, c2):
        roles, w, pi, mask = ctx.saved_tensors
        droles, dw, db = interact_bwd_absorb(
            roles[0], roles[1], roles[2], pi, w, c1.contiguous(),
            c2.contiguous(), mask, ctx.order)
        return droles, dw, db, None, None, None
