"""Datasets, the host input pipeline and the VOC evaluation (counterpart of
:mod:`ssds_tpu.data`). Nothing is imported here."""
