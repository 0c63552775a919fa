"""Collective statistics of a step, from the collectives' own record.

Counterpart of ``ihgnn_tpu/utils/hlo_stats.py`` (``collective_stats``
``:47``, ``comm_bytes`` ``:61``, ``collective_table`` ``:89``). The JAX
package reads the collectives of a compiled step out of its optimized
HLO. The port has no HLO: every collective of ``parallel/`` goes through
``parallel/collectives.py`` ``_call``, which, while recording is on
(``collectives.set_recording``), appends one entry a call to
``collectives.RECORD``: its kind (``all-reduce``, ``all-gather``,
``reduce-scatter``), its result's bytes and shape in the HLO convention
(``f32[700000,32]``), its group's axis (``data`` or ``model``) and its
call site (``grad:`` in a backward, as
``hlo_stats._attribute`` marks a transpose). A collective over one rank
does not run and is not recorded.

Byte counts are the result's, as in ``hlo_stats.py``: the payload a rank
materialises; the wire traffic a rank is at most that for an all-gather,
and at most 2·(P−1)/P of it for an all-reduce.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def collective_stats(record: Sequence[dict]) -> Dict[str, Dict[str, int]]:
    """``{kind: {count, bytes}}`` over ``record`` (a step's
    ``collectives.RECORD``)."""
    stats: Dict[str, Dict[str, int]] = {}
    for row in record:
        s = stats.setdefault(row["kind"], {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += row["bytes"]
    return stats


def comm_bytes(record: Sequence[dict]) -> int:
    """The result bytes of every collective of ``record``."""
    return sum(s["bytes"] for s in collective_stats(record).values())


def collective_table(record: Sequence[dict]) -> List[dict]:
    """One row a collective call, ``{kind, bytes, shape, group,
    attribution}``, the largest first (ties in call order)."""
    rows = [{k: row[k] for k in ("kind", "bytes", "shape", "group",
                                 "attribution")}
            for row in record]
    rows.sort(key=lambda r: -r["bytes"])
    return rows
