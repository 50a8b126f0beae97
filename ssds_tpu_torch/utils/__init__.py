"""Observability helpers (counterpart of :mod:`ssds_tpu.utils`)."""

from ssds_tpu_torch.utils.timer import Timer

__all__ = ["Timer"]
