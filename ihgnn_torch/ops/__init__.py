"""Kernel wrappers and their plain PyTorch twins.

* ``segsum``   — K1 ``csr_gather_sum``: CSR weighted row gather-sum (the
  node update H·E, the query word-bag mean, and the backward sums of the
  gather, the scatter and the bag).
* ``gather``   — K2 ``gather_roles``: the three endpoint rows of each edge.
* ``interact`` — K3 ``interact_fwd`` and ``interact_bwd``: the fused
  order-1/2/3 interaction and its backward, joined by ``InteractFn``.
* ``hyperagg`` — the gather/scatter pair of one hypergraph, as
  ``GatherRolesFn`` and ``ScatterIncidenceFn``.
* ``bag``      — the word-bag mean, as ``BagMeanFn``.

Each wrapper runs its plain twin on CPU tensors and its CUDA kernel on CUDA
tensors, and counts its kernel launches in ``<wrapper>.launches``. The
``*Fn`` classes are ``torch.autograd.Function``s whose forward and backward
call the wrappers.
"""
