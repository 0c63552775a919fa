"""ihgnn_torch: the IHGNN model on PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of ``ihgnn_tpu`` that keeps its module names so each counterpart is
easy to find. Tensors are row-major: node features are ``[N, d]`` and edge
features ``[E, d]``, so one node's 32 f32 features form one 128-byte line
on the card.

Entry points (``python -m ihgnn_torch.cli``, ``RawGnn``,
``train.eval.make_eval_fns``/``evaluate``, ``train.train.make_train_step``)
run on CUDA unless the caller passes ``device="cpu"`` (``--device cpu``). On CPU tensors every kernel
wrapper in ``ops/`` runs its plain PyTorch twin; on CUDA tensors it
launches its kernel or raises.
"""
