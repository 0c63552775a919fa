"""Kernel wrappers and their plain PyTorch twins.

* ``segsum``   — K1 ``csr_gather_sum``: CSR weighted row gather-sum (the
  node update H·E, the query word-bag mean, GCN's SpMM, the log
  hypergraph's sums, the attention's weighted sum, and the backward sums
  of all of them); ``long_segments``, a CSR's hubs, which K1 sums with a
  block each.
* ``gather``   — K2 ``gather_roles``: the three endpoint rows of each edge.
* ``interact`` — K3 ``interact_fwd`` and ``interact_bwd``: the fused
  order-1/2/3 interaction and its backward, joined by ``InteractFn``.
* ``segmax``   — K4 ``csr_segment_max`` and the scalar ``csr_segment_sum``
  over a CSR: the attention softmax's max and denominators.
* ``edgedot``  — ``csr_edge_dot``: the dot of two gathered rows per entry
  (the attention backward and the product head; no TPU kernel of its own),
  and ``edge_dot_order``, its per-graph column order.
* ``segment``  — plain segment sum/max/softmax, SpMM and hyperedge
  gather/scatter: the reference semantics the twins are written with.
* ``hyperagg`` — the hypergraph's gather/scatter pair (``GatherRolesFn``,
  ``SpmmFn``), GCN's SpMM and the log hypergraph's sums (``SpmmFn``).
* ``gatconv``  — the attention conv of GAT and IHGNN phase 2,
  ``GatConvFn``.
* ``bag``      — the word-bag mean, as ``BagMeanFn``.

The routed path (a ``HyperGraph`` built with ``pack_kernels=True``):

* ``packing``  — the routed pack ``HyperKernelPack``: expand indices, Clos
  stage tables, the node sums' ids with their CSR and K8's scan pack;
* ``benes`` / ``native`` — the Clos router: the NumPy oracle and the g++
  build of ``csrc/routing.cc``;
* ``permute``  — K6/K7 ``row_local_permute`` and
  ``transposed_local_permute`` (``pick_grid``, the routed grid);
* ``segscan``  — K8 ``csr_segment_scan`` and its pack;
* ``gather``, ``segsum``, ``interact`` also hold K2's single-index forms,
  K1's three-region form and K5, the absorbed interaction
  (``InteractAbsorbFn``); ``hyperagg`` the routed chains' Functions.

Past 2048 grid rows the pack chunks (``packing.ChunkedHyperPack``: σ
packs of contiguous edge slices, one K1 three-region sum over a CSR that
spans them). The routed 2D graph (a ``Graph2D`` built with
``pack_kernels=True``): ``packing.role_pack`` (the non-σ ``RolePack``,
``hyperagg.RoutedSpmmFn``, GCN), ``gatpack`` (``GatPack``,
``ChunkedGatPack``, ``build_gat_pack``) and ``gatconv.RoutedGatConvFn``,
with K2's d = 1 form ``gather.gather_scalars``.

Each wrapper runs its plain twin on CPU tensors and its CUDA kernel on CUDA
tensors, and counts its kernel launches in ``<wrapper>.launches``. The
``*Fn`` classes are ``torch.autograd.Function``s whose forward and backward
call the wrappers.
"""
