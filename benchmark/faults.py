"""Faults planted under the timed path, to show that ``correct`` catches
them. Neither the benchmark's runs nor the program use these; the fault
tests and ``calibrate.py`` do.

* ``state_unchanged`` (training): the optimizer's step does nothing;
* ``half_batch`` (training): the loss is the mean over the first half
  of the batch's rows only; (ranking) the second half of each batch's
  metric rows is left out, as zeros;
* ``answer_altered`` (ranking): each batch's first metric row has its HR
  raised by 0.25 where the rows are made;
* ``score_altered`` (ranking): the catalog scores leave out the user's
  term (the HEM head scores with the query's feature alone).
"""

from __future__ import annotations

import contextlib

FAULTS = {"train": ("state_unchanged", "half_batch"),
          "rank": ("answer_altered", "half_batch", "score_altered")}


@contextlib.contextmanager
def planted(kind: str, name):
    """Patch the program for the duration; ``name`` None plants
    nothing."""
    if name is None:
        yield
        return
    if name not in FAULTS[kind]:
        raise ValueError(f"no fault {name!r} for {kind} cells")
    import torch
    from ihgnn_torch.train import eval as port_eval
    from ihgnn_torch.train import train as port_train

    saved = {}
    if kind == "train" and name == "state_unchanged":
        saved[(torch.optim.Adam, "step")] = torch.optim.Adam.step
        torch.optim.Adam.step = lambda self, closure=None: None
    elif kind == "train":
        bce = port_train.bce_with_logits

        def half(logits, labels, weight):
            n = logits.shape[0] // 2
            return bce(logits[:n], labels[:n], weight[:n])
        saved[(port_train, "bce_with_logits")] = bce
        port_train.bce_with_logits = half
    elif name == "score_altered":
        from ihgnn_torch.models.prediction import HemPredictionLayer
        score_all = HemPredictionLayer.score_all

        def no_user(self, user_feature, query_feature, all_item_features):
            return score_all(self, None, query_feature, all_item_features)
        saved[(HemPredictionLayer, "score_all")] = score_all
        HemPredictionLayer.score_all = no_user
    else:
        metrics = port_eval.ranking_metrics

        def broken(scores, truth, counts, *args, **kw):
            rows = metrics(scores, truth, counts, *args, **kw).clone()
            if name == "answer_altered":
                rows[0, 0] += 0.25
            else:
                rows[rows.shape[0] // 2:] = 0.0
            return rows
        saved[(port_eval, "ranking_metrics")] = metrics
        port_eval.ranking_metrics = broken
    try:
        yield
    finally:
        for (owner, attr), value in saved.items():
            setattr(owner, attr, value)
