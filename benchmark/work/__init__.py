"""The work a step or a batch requires, counted from the cell's shapes.

Each op is the least the algorithm must do at its stage, whatever kernel
runs it (``common.Op``): its inputs read once and its outputs written
once, and its operations. ``common`` holds the peaks and what every
configuration shares; ``<gnn>.py`` one layer kind, found by the
configuration's ``model.gnn``.
"""
