"""Models: layers, backbones, heads and the builder (counterpart of :mod:`ssds_tpu.models`)."""
