"""Tracing and device-correct timing (counterpart of :mod:`ssds_tpu.utils.profiler`).

:func:`trace` records a ``torch.profiler`` trace of the enclosed block, host
and card, into a Chrome trace file (``chrome://tracing``, Perfetto, or
TensorBoard's profile plugin); :func:`annotate` names a span in it, on the
same clock as the card's kernels, and costs a flag read when no profiler
runs; :func:`timed` adds a block's wall time to a dict after waiting for the
work it queued on the card, as the JAX package's waits on
``jax.effects_barrier``.

The training loop's spans (``Solver.train_epoch`` and the train step of
``build_train_step``) are these; a step's other spans are the ones its
``solver.step`` span holds:

- ``solver.epoch``: the whole of ``train_epoch``, the loader included;
- ``solver.step``: one iteration of its loop;
- ``solver.upload``: the batch to the device;
- ``solver.host_read``: a blocking read of the losses on the host;
- ``step.forward``, ``step.loss``, ``step.backward`` (the gradients'
  zeroing and reduction included), ``step.optimizer``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Profile the enclosed block (CPU activity, and the card's kernels when
    there is one) and write ``{log_dir}/{name}.json``, a Chrome trace::

        with profiler.trace(cfg.LOG_DIR):
            with profiler.annotate("train_step"):
                metrics = train_step(batch, step)

    Yields the ``torch.profiler.profile`` object (``key_averages()``); its
    ``trace_path`` attribute names the file once the block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
        _synchronize()
    finally:
        prof.stop()
    prof.trace_path = os.path.join(log_dir, f"{name}.json")
    prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def timed(name: str, results: dict):
    """Add the block's wall seconds to ``results[name]``, the card's queued
    work included (synchronised before the clock is read)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _synchronize()
        results[name] = results.get(name, 0.0) + time.perf_counter() - t0


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named span in the trace (``torch.profiler.record_function``) while
    a profiler runs; otherwise one shared no-op context (an ungated
    ``record_function`` costs some microseconds even with no profiler)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
