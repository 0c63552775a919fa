"""Search-log data model (the integer-encoded ``SearchLog`` and the
``PosInteraction`` rows flattened from it).

Counterpart of ``ihgnn_tpu/data/schema.py`` ``SearchLog`` and
``PosInteraction``, file-format
compatible with the reference artifacts (Helpers/SearchLog.py). CSV row:
``user,query,search_time,items,pages,positions,interactions,times`` with
space-separated list columns (SearchLog.py:15-31).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple


class SearchLog(NamedTuple):
    """One search: a user issued a query and saw a ranked list of items,
    some of which were interacted with (flag > 0)."""

    user: int
    query: int
    search_time: str
    items: List[int] = None
    pages: List[int] = None
    positions: List[int] = None
    interactions: List[int] = None
    times: List[str] = None

    @staticmethod
    def column_names() -> str:
        return "user,query,search_time,items,pages,positions,interactions,times"

    def tostr(self) -> str:
        return ",".join([
            str(self.user),
            str(self.query),
            self.search_time,
            " ".join(str(e) for e in self.items),
            " ".join(str(e) for e in self.pages),
            " ".join(str(e) for e in self.positions),
            " ".join(str(e) for e in self.interactions),
            " ".join(self.times),
        ])

    __str__ = tostr

    @classmethod
    def parse(cls, line: str) -> "SearchLog":
        u, q, stime, items, pages, positions, flags, times = \
            line.strip().split(",")
        return cls(
            int(u), int(q), stime,
            [int(e) for e in items.split()],
            [int(e) for e in pages.split()],
            [int(e) for e in positions.split()],
            [int(e) for e in flags.split()],
            times.split(),
        )

    def get_interacted_items(self, flag_policy: str = "min"
                             ) -> Tuple[List[int], List[int], bool]:
        """Unique positively-interacted items and their relevance flags.

        Items keep their first-seen order; an item seen with several
        positive flags takes the min (or max) of them (SearchLog.py:34-61).
        Returns (items, flags, all_flags_are_1)."""
        by_item: Dict[int, List[int]] = {}
        for item, flag in zip(self.items, self.interactions):
            if flag > 0:
                by_item.setdefault(item, []).append(flag)

        pick = min if flag_policy == "min" else max
        items, flags = [], []
        for item, fs in by_item.items():
            items.append(item)
            flags.append(pick(fs))
        return items, flags, all(f <= 1 for f in flags)


class PosInteraction(NamedTuple):
    """One positive (user, query, item) interaction, flattened from a log."""

    user: int
    query: int
    search_time: str
    item: int
    page: int
    position: int
    interaction: int
    time: str

    def uqif(self) -> Tuple[int, int, int, int]:
        return self.user, self.query, self.item, self.interaction

    @staticmethod
    def from_search_log(log: SearchLog,
                        treat_all_1: bool) -> List["PosInteraction"]:
        """All flag>0 items of a log; flags clamped to 1 when
        ``treat_all_1`` (SearchLog.py:199-207)."""
        out = []
        for item, page, pos, flag, t in zip(log.items, log.pages,
                                            log.positions, log.interactions,
                                            log.times):
            if flag > 0:
                if treat_all_1 and flag > 1:
                    flag = 1
                out.append(PosInteraction(log.user, log.query,
                                          log.search_time, item, page, pos,
                                          flag, t))
        return out
