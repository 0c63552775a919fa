"""The launch counts of the kernel wrappers.

Each wrapper of ``ihgnn_torch/ops`` adds one to its ``launches`` (its
bf16 forms to ``launches_bf16``) where it launches its kernel, and
nowhere else; these read and reset every count at once.
"""

from __future__ import annotations

from typing import Dict


def wrappers():
    """Every kernel wrapper, in a fixed order."""
    from ihgnn_torch.ops.edgedot import csr_edge_dot
    from ihgnn_torch.ops.gather import (gather_roles, gather_rows,
                                        gather_rows_t, gather_scalars)
    from ihgnn_torch.ops.interact import (interact_bwd, interact_bwd_absorb,
                                          interact_fwd, interact_fwd_absorb)
    from ihgnn_torch.ops.permute import (row_local_permute,
                                         transposed_local_permute)
    from ihgnn_torch.ops.segmax import csr_segment_max, csr_segment_sum
    from ihgnn_torch.ops.segscan import csr_segment_scan
    from ihgnn_torch.ops.segsum import csr_gather_sum, csr_segment_sum3
    return (csr_gather_sum, gather_roles, interact_fwd, interact_bwd,
            csr_segment_max, csr_segment_sum, csr_edge_dot, gather_rows,
            gather_rows_t, csr_segment_sum3, row_local_permute,
            transposed_local_permute, interact_fwd_absorb,
            interact_bwd_absorb, csr_segment_scan, gather_scalars)


def zero_launches() -> None:
    for fn in wrappers():
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0


def launch_counts() -> Dict[str, int]:
    """Every wrapper's counts since ``zero_launches``: ``name`` its f32
    forms' launches, ``name_bf16`` its bf16 forms'."""
    counts = {}
    for fn in wrappers():
        counts[fn.__name__] = fn.launches
        if hasattr(fn, "launches_bf16"):
            counts[fn.__name__ + "_bf16"] = fn.launches_bf16
    return counts
