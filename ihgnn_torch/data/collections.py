"""Collections of search logs: CSV and TSV I/O, the per-user temporal
split, the one-hot mapping.

Counterpart of ``ihgnn_tpu/data/collections.py`` (reference:
Helpers/SearchLogCollection.py), with the same file formats and split
semantics. The split draws its fractional counts from Python's global
``random`` in the JAX package's order, so one seed splits alike.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from ihgnn_torch.data.schema import RawSearchLog, SearchLog


class SearchLogCollection:
    def __init__(self, logs: Optional[Iterable[SearchLog]] = None):
        self.logs: List[SearchLog] = list(logs) if logs is not None else []

    def __getitem__(self, index: int) -> SearchLog:
        return self.logs[index]

    def __len__(self) -> int:
        return len(self.logs)

    def __iter__(self) -> Iterator[SearchLog]:
        return iter(self.logs)

    def append(self, log: SearchLog) -> None:
        self.logs.append(log)

    def write(self, filename: str, encoding: str = "utf-8") -> None:
        with open(filename, "w", encoding=encoding) as f:
            f.write(SearchLog.column_names() + "\n")
            for log in self.logs:
                f.write(log.tostr() + "\n")

    @classmethod
    def read(cls, filename: str,
             encoding: str = "utf-8") -> "SearchLogCollection":
        res = cls()
        with open(filename, "r", encoding=encoding) as f:
            f.readline()  # header
            for line in f:
                if line.strip():
                    res.append(SearchLog.parse(line))
        return res


class RawSearchLogCollection:
    """List of string-ID ``RawSearchLog`` with TSV I/O and the per-user
    temporal split (SearchLogCollection.py:35-243)."""

    def __init__(self, logs: Optional[Iterable[RawSearchLog]] = None):
        self.logs: List[RawSearchLog] = list(logs) if logs is not None else []
        self._sorted = False

    def __getitem__(self, index: int) -> RawSearchLog:
        return self.logs[index]

    def __len__(self) -> int:
        return len(self.logs)

    def __iter__(self) -> Iterator[RawSearchLog]:
        return iter(self.logs)

    def append(self, log: RawSearchLog) -> None:
        self.logs.append(log)

    def sort_by_user_and_time(self) -> None:
        self.logs.sort(key=lambda log: (log.user_id, log.search_time))
        self._sorted = True

    def write(self, filename: str, encoding: str = "utf-8") -> None:
        with open(filename, "w", encoding=encoding) as f:
            f.write(RawSearchLog.column_names() + "\n")
            for log in self.logs:
                f.write(log.tostr() + "\n")

    def write_search_ids(self, filename: str, encoding: str = "utf-8") -> None:
        with open(filename, "w", encoding=encoding) as f:
            for log in self.logs:
                f.write(log.search_id + "\n")

    @classmethod
    def read(cls, filename: str, encoding: str = "utf-8") -> "RawSearchLogCollection":
        res = cls()
        with open(filename, "r", encoding=encoding) as f:
            f.readline()  # header
            for line in f:
                if line.strip():
                    res.append(RawSearchLog.parse(line))
        return res

    # ---- splitting ----

    def split_to_train_valid_test(
        self,
        train_ratio: float,
        valid_ratio: float,
        test_ratio: float,
        presplit_search_ids: Optional[List[Set[str]]] = None,
        reserve_at_least_one_in_train: bool = False,
    ) -> Tuple["RawSearchLogCollection", "RawSearchLogCollection", "RawSearchLogCollection"]:
        """Per-user temporal split (SearchLogCollection.py:65-156).

        For each user with m logs (sorted by time): the first
        floor(m*train_ratio) logs go to train, plus one more with probability
        frac(m*train_ratio); symmetrically the tail goes to test; the middle
        is validation. ``presplit_search_ids`` (train/valid/test id sets)
        reproduces a previous split exactly.
        """
        if not self._sorted:
            self.sort_by_user_and_time()

        train, valid, test = (RawSearchLogCollection(), RawSearchLogCollection(),
                              RawSearchLogCollection())

        if presplit_search_ids is not None:
            ids_train, ids_valid, ids_test = presplit_search_ids
            for log in self.logs:
                if log.search_id in ids_train:
                    train.append(log)
                elif log.search_id in ids_valid:
                    valid.append(log)
                elif log.search_id in ids_test:
                    test.append(log)
                else:
                    raise ValueError(f"search id {log.search_id} not in any presplit set")
            return train, valid, test

        for start, end in self._iter_user_ranges():
            m = end - start
            frac, n_train = math.modf(train_ratio * m)
            n_train = int(n_train) + random.choices([1, 0], weights=[frac, 1 - frac], k=1)[0]
            if reserve_at_least_one_in_train and n_train == 0:
                n_train = 1
            valid_start = start + n_train

            if valid_start >= end:
                test_start = end
            else:
                frac, n_test = math.modf(test_ratio * m)
                n_test = int(n_test) + random.choices([1, 0], weights=[frac, 1 - frac], k=1)[0]
                test_start = max(end - n_test, valid_start)

            train.logs.extend(self.logs[start:valid_start])
            valid.logs.extend(self.logs[valid_start:test_start])
            test.logs.extend(self.logs[test_start:end])
        return train, valid, test

    def split_to_train_test(
        self, test_data_ratio: float, reserve_at_least_one_in_train: bool = False,
    ) -> Tuple["RawSearchLogCollection", "RawSearchLogCollection"]:
        """Two-way per-user temporal split (SearchLogCollection.py:159-214).

        Note: like the reference, the final user group is bounded by the last
        user-id *change*; a trailing single-user tail keeps reference
        semantics via the sentinel range below.
        """
        if not self._sorted:
            self.sort_by_user_and_time()

        train, test = RawSearchLogCollection(), RawSearchLogCollection()
        for start, end in self._iter_user_ranges():
            m = end - start
            frac, n_test = math.modf(test_data_ratio * m)
            n_test = int(n_test) + random.choices([1, 0], weights=[frac, 1 - frac], k=1)[0]
            middle = end - n_test
            if reserve_at_least_one_in_train and middle == start:
                middle += 1
            train.logs.extend(self.logs[start:middle])
            test.logs.extend(self.logs[middle:end])
        return train, test

    def _iter_user_ranges(self) -> Iterator[Tuple[int, int]]:
        """Contiguous [start, end) ranges of logs sharing a user_id."""
        n = len(self.logs)
        start = 0
        for i in range(1, n + 1):
            if i == n or self.logs[start].user_id != self.logs[i].user_id:
                yield start, i
                start = i

    # ---- one-hot mapping ----

    def to_onehot(
        self,
        user_id_onehot_dict: Dict[str, int],
        item_id_onehot_dict: Dict[str, int],
        query_rdict: Dict[str, int],
    ) -> SearchLogCollection:
        """Map string ids to integer indices (SearchLogCollection.py:217-232).
        Items are sorted by display position first if not already."""
        res = SearchLogCollection()
        for log in self.logs:
            if not log.sorted:
                log.sort_items()
            res.append(SearchLog(
                user_id_onehot_dict[log.user_id],
                query_rdict[log.query],
                log.search_time,
                [item_id_onehot_dict[i] for i in log.item_ids],
                log.pages,
                log.positions,
                log.interactions.copy(),
                log.times,
            ))
        return res
