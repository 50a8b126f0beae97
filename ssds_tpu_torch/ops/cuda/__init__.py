"""Hand-written CUDA kernels for Hopper, one wrapper module each.

Each wrapper runs its plain PyTorch version on CPU tensors, launches its
kernel on CUDA tensors (or raises), and counts its launches. The sources
live in ``ssds_tpu_torch/csrc/`` and are built on first use by
:mod:`~ssds_tpu_torch.ops.cuda._build`.
"""
