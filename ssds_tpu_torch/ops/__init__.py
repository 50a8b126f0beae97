"""Detection math (counterpart of :mod:`ssds_tpu.ops`).

- :mod:`~ssds_tpu_torch.ops.boxes` — box geometry, encode/decode
- :mod:`~ssds_tpu_torch.ops.anchors` — prior boxes (numpy)
- :mod:`~ssds_tpu_torch.ops.nms` — greedy NMS, plain PyTorch
- :mod:`~ssds_tpu_torch.ops.conv` — the 3x3 stem conv prototype, plain PyTorch
- :mod:`~ssds_tpu_torch.ops.stencil` — the conv probes' shifted bf16 sums, plain PyTorch
- :mod:`~ssds_tpu_torch.ops.cuda` — the hand-written CUDA kernels
- :mod:`~ssds_tpu_torch.ops.postprocess` — decode -> per-class NMS -> dense rows

Nothing is imported here, so importing one op pulls in no other.
"""
