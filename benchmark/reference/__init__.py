"""The plain reference of the benchmark's configurations.

Plain PyTorch in float32, written from the published description of the
model (CDboyOne/IHGNN: ``Models/RawGnn.py``, ``Models/GnnLayers.py``,
``Models/CommonLayers.py``, ``Models/PredictionLayers.py``,
``Helpers/Metrics.py``). It builds its own incidence, 2D graph and word
bags from the (u, q, i) rows and query words the benchmark draws, and it
imports nothing of the program under test. ``rawgnn`` holds what every
configuration shares (tables, word bag, HEM head, BCE, Adam, the ranking
metrics); ``<gnn>.py`` holds one layer kind, found by the configuration's
``model.gnn``.
"""
