"""The offline preprocessing pipeline: raw logs → Step-3 artifacts.

Step 1 (``amazon``, ``cikm``) writes an intermediate directory, Step 2
(``subset``) filters it, Step 3 (``onehot``) writes the artifacts every
run reads; ``synth_cikm`` writes the CIKM-shaped quality set.
"""
