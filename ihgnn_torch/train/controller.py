"""Epoch schedule and wall-clock estimate of the training loop.

Counterpart of ``ihgnn_tpu/train/controller.py`` (the reference's
Helpers/ProcessController.py): epochs run from a checkpoint-aware start;
evaluation fires once ``epoch + 1 - first_epoch`` reaches the test start
and then every ``test_every`` epochs (anchored at the start), and always on
the final epoch; checkpoint stores follow the same rule with their own
start and frequency. The remaining-time estimate takes the mean of the last
two train and eval durations (eval guessed as twice a train pass before
any eval has run) and counts the evals this run still has to do, so a
resumed run does not bill evals the earlier run made.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional


def _mean_of_recent(samples: List[float], default: float) -> float:
    if not samples:
        return default
    return sum(samples[-2:]) / len(samples[-2:])


@dataclasses.dataclass
class EpochSchedule:
    """Test/store cadence over epochs [first_epoch, first_epoch +
    epoch_count)."""

    epoch_count: int
    first_epoch: int
    test_start: int
    test_every: int
    store_start: Optional[int] = None
    store_every: Optional[int] = None

    def __post_init__(self):
        self._train_seconds: List[float] = []
        self._eval_seconds: List[float] = []

    @property
    def end_epoch(self) -> int:
        """One past the last epoch (the reference's EndEpoch)."""
        return self.first_epoch + self.epoch_count

    @property
    def last_epoch(self) -> int:
        return self.end_epoch - 1

    @property
    def epochs(self) -> range:
        return range(self.first_epoch, self.end_epoch)

    def _fires(self, epoch: int, start: int, every: int) -> bool:
        past_start = epoch + 1 - self.first_epoch >= start
        on_cadence = (epoch - start) % every == 0
        return past_start and (on_cadence or epoch == self.last_epoch)

    def is_test_epoch(self, epoch: int) -> bool:
        return self._fires(epoch, self.test_start, self.test_every)

    def is_store_epoch(self, epoch: int) -> bool:
        if self.store_start is None or self.store_every is None:
            return False
        return self._fires(epoch, self.store_start, self.store_every)

    def record_train_seconds(self, seconds: float) -> None:
        self._train_seconds.append(seconds)

    def record_eval_seconds(self, seconds: float) -> None:
        self._eval_seconds.append(seconds)

    def remaining_seconds(self, epoch: int) -> float:
        """Estimated wall-clock left after ``epoch``'s train pass: the
        train passes still to run and the evals from ``epoch``'s own on;
        NaN before any train pass was recorded."""
        if not self._train_seconds:
            return float("nan")
        train_avg = _mean_of_recent(self._train_seconds, 0.0)
        eval_avg = _mean_of_recent(self._eval_seconds, train_avg * 2)
        evals_left = sum(1 for ep in range(epoch, self.end_epoch + 1)
                         if self.is_test_epoch(ep))
        return (train_avg * (self.end_epoch - epoch)
                + eval_avg * evals_left)

    def remaining_text(self, epoch: int) -> str:
        seconds = self.remaining_seconds(epoch)
        if math.isnan(seconds):
            return "n/a"
        if seconds >= 3600:
            hours = int(seconds // 3600)
            return f"{hours} h {int(seconds / 60) - 60 * hours} m"
        if seconds >= 60:
            return f"{int(seconds / 60)} m"
        return f"{int(seconds)} s"
