"""The benchmark of the PyTorch and CUDA port (``ssds_tpu_torch``): ``python3 benchmark/run.py``.

See ``benchmark/README.md``.
"""
