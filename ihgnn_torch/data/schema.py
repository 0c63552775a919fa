"""Search-log data model.

Counterpart of ``ihgnn_tpu/data/schema.py``, file-format compatible with
the reference artifacts (Helpers/SearchLog.py):

* ``SearchLog`` — the integer-encoded log (after Step 3). CSV row:
  ``user,query,search_time,items,pages,positions,interactions,times`` with
  space-separated list columns (SearchLog.py:15-31);
* ``PosInteraction`` — one positive (flag > 0) item of a log
  (SearchLog.py:185-207);
* ``RawSearchLog`` — the string-id log of the preprocessing steps, a TSV
  row (SearchLog.py:133-146);
* ``CikmSearchLog`` — a parsed CIKM Cup 2016 Track 2 raw line
  (SearchLog.py:209-298).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Set, Tuple


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


class RawSearchLog:
    """String-ID search log used by the offline preprocessing pipeline."""

    __slots__ = ("search_id", "user_id", "query", "search_time", "sorted",
                 "item_ids", "pages", "positions", "interactions", "times")

    def __init__(self, search_id: str, user_id: str, query: str, search_time: str):
        self.search_id = search_id
        self.user_id = user_id
        self.query = query
        self.search_time = search_time
        self.sorted = False
        self.item_ids: List[str] = []
        self.pages: List[int] = []
        self.positions: List[int] = []
        self.interactions: List[int] = []
        self.times: List[str] = []

    def __len__(self) -> int:
        return len(self.item_ids)

    def __repr__(self) -> str:
        return f"RawSearchLog(id={self.search_id}, len={len(self)}, sorted={self.sorted})"

    def copy(self) -> "RawSearchLog":
        log = RawSearchLog(self.search_id, self.user_id, self.query, self.search_time)
        log.item_ids = self.item_ids.copy()
        log.pages = self.pages.copy()
        log.positions = self.positions.copy()
        log.interactions = self.interactions.copy()
        log.times = self.times.copy()
        log.sorted = self.sorted
        return log

    def add_item(self, item_id: str, page: int, position: int,
                 interaction: int, interaction_time: str) -> None:
        self.item_ids.append(item_id)
        self.pages.append(page)
        self.positions.append(position)
        self.interactions.append(interaction)
        self.times.append(interaction_time)
        self.sorted = False

    def sort_items(self) -> None:
        """Sort item lists by absolute display position 1000*page + position
        (SearchLog.py:118-131)."""
        if self.sorted:
            return
        order = sorted(range(len(self.item_ids)),
                       key=lambda i: 1000 * self.pages[i] + self.positions[i])
        self.item_ids = [self.item_ids[i] for i in order]
        self.pages = [self.pages[i] for i in order]
        self.positions = [self.positions[i] for i in order]
        self.interactions = [self.interactions[i] for i in order]
        self.times = [self.times[i] for i in order]
        self.sorted = True

    def subset(self, item_ids_subset: Set[str]) -> "RawSearchLog":
        """Copy of this log restricted to items in the given set
        (SearchLog.py:148-160)."""
        keep = [i for i, iid in enumerate(self.item_ids) if iid in item_ids_subset]
        log = RawSearchLog(self.search_id, self.user_id, self.query, self.search_time)
        log.item_ids = [self.item_ids[i] for i in keep]
        log.pages = [self.pages[i] for i in keep]
        log.positions = [self.positions[i] for i in keep]
        log.interactions = [self.interactions[i] for i in keep]
        log.times = [self.times[i] for i in keep]
        log.sorted = self.sorted
        return log

    def validate_times(self) -> None:
        for flag, itime in zip(self.interactions, self.times):
            if flag > 0:
                assert bool(itime) and itime != "NA", repr(self)

    # ---- TSV round-trip (format: SearchLog.py:133-146,167-182) ----

    @staticmethod
    def column_names() -> str:
        return ("search_id\tuser_id\tquery\tsearch_time\tsorted\t"
                "item_ids\tpages\tpositions\tinteractions\ttimes")

    def tostr(self) -> str:
        return "\t".join([
            self.search_id,
            self.user_id,
            self.query,
            self.search_time,
            str(self.sorted),
            " ".join(self.item_ids),
            " ".join(str(e) for e in self.pages),
            " ".join(str(e) for e in self.positions),
            " ".join(str(e) for e in self.interactions),
            " ".join(self.times),
        ])

    __str__ = tostr

    @classmethod
    def parse(cls, line: str) -> "RawSearchLog":
        sid, uid, q, stime, sort, items, pages, positions, flags, times = \
            [p.strip() for p in line.strip().split("\t")]
        log = cls(sid, uid, q, stime)
        log.sorted = sort == "True"
        log.item_ids = items.split()
        log.pages = [int(e) for e in pages.split()]
        log.positions = [int(e) for e in positions.split()]
        log.interactions = [int(e) for e in flags.split()]
        log.times = times.split()
        return log


class CikmSearchLog:
    """Parser for CIKM Cup 2016 Track 2 ``train-queries.csv`` rows
    (SearchLog.py:209-298). Two modes: query rows (query words present) and
    category-browse rows (category id, no query)."""

    __slots__ = ("session_id", "search_id", "user_id", "is_query", "query_str",
                 "query_segment", "category_id", "item_ids", "item_interactions",
                 "item_times", "time_frame", "search_date", "page_alive_time")

    @classmethod
    def from_cikm_line(cls, line: str, category_mode: bool) -> Optional["CikmSearchLog"]:
        """Parse one raw line; returns None for rows to skip (test rows, NA
        users, empty item lists, or the wrong mode)."""
        (query_id, session_id, user_id, time_frame, page_alive_time, event_date,
         query_str, category_id, items, is_test) = line.strip().split(";")
        assert query_str != "" or category_id != ""

        if user_id == "NA" or items in ("", "NA") or is_test == "TRUE":
            return None
        if not category_mode and query_str == "":
            return None
        if category_mode and (category_id == "" or query_str != ""):
            return None

        log = cls()
        if category_mode:
            log.query_str = ""
            log.query_segment = []
            log.is_query = False
            log.category_id = category_id
        else:
            words = query_str.split(",")
            log.query_str = " ".join(words)
            log.query_segment = words
            log.is_query = True
            log.category_id = ""

        log.session_id = session_id
        log.search_id = query_id
        log.user_id = user_id
        log.item_ids = items.split(",")
        log.item_interactions = [0] * len(log.item_ids)
        log.item_times = ["NA"] * len(log.item_ids)
        log.time_frame = int(time_frame)
        log.search_date = event_date
        log.page_alive_time = page_alive_time
        return log

    def to_query(self, query_vocabulary_size: int) -> None:
        """Rewrite a category browse as a single-token query whose word id is
        offset past the query vocabulary (SearchLog.py:282-288)."""
        if not self.is_query:
            word = int(self.category_id) + query_vocabulary_size
            self.query_str = str(word)
            self.query_segment = [self.query_str]
            self.is_query = True

    def to_raw_search_log(self) -> RawSearchLog:
        log = RawSearchLog(self.search_id, self.user_id, self.query_str,
                           self.search_date + str(self.time_frame).rjust(15, "0"))
        log.item_ids = self.item_ids
        log.pages = [1] * len(log.item_ids)
        log.positions = list(range(len(log.item_ids)))
        log.interactions = self.item_interactions
        log.times = self.item_times
        log.sorted = True
        return log
