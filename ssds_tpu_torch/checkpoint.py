"""Checkpoints with the reference's manifest and scope filters.

Counterpart of :mod:`ssds_tpu.checkpoint` (reference ``lib/ssds_train.py``):
``save_checkpoint`` writes ``{EXP_DIR}/{PREFIX}_epoch_{N}.pth`` and appends
``epoch N:<file>`` to ``{EXP_DIR}/checkpoint_list.txt``; ``find_previous``
reads that manifest to auto-resume the newest checkpoint;
``resume_checkpoint`` loads only the keys present in both the file and the
model (printing the rest), restricted to the RESUME_SCOPE words when given,
which is how a pretrained backbone is grafted.

Format: ``torch.save({"state_dict": <the model's state dict>, "epoch": N})``
in the reference torch layout (``base.{i}``, ``norm``, ``extras.{k}``,
``loc.{k}``, ``conf.{k}``), which :class:`ssds_tpu_torch.detector.ObjectDetector`
loads as ``RESUME_CHECKPOINT``. ``resume_checkpoint`` also takes a bare state
dict, as ssds.pytorch saves one, with or without ``module.`` prefixes. The
JAX package's flax msgpack ``.ckpt`` files are not read here: carry JAX
parameters across with :func:`ssds_tpu_torch.weights.state_dict_from_jax`.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch

MANIFEST = "checkpoint_list.txt"


def _name_matches(name: str, prefix: str) -> bool:
    """Module-name match: exact, ``'<prefix>_*'`` or ``'<prefix><digits>'``;
    a longer bare word (``'confusion'`` against ``'conf'``) does not match."""
    if name == prefix or name.startswith(prefix + "_"):
        return True
    tail = name[len(prefix):]
    return name.startswith(prefix) and tail.isdigit() and tail != ""


def path_in_scope(name: str, scope: str, aliases: Optional[Mapping[str, Sequence[str]]] = None
                  ) -> bool:
    """Does a state-dict name (``'base.0.weight'``) fall under a scope string
    (``'base,norm,extras'``)? The empty scope matches everything.

    The scope words are the reference's module names, which the port's
    modules keep (``base``, ``norm``, ``extras``, ``transforms``,
    ``pyramids``, ``loc``, ``conf``), so a word is matched against the
    name's first part directly; the JAX package maps each word to its flax
    names (``ssds_tpu/checkpoint.py`` ``SCOPE_PREFIXES``). ``aliases`` maps
    a word with no module of its name to the modules it selects, a model's
    ``SCOPE_ALIASES``: FSSD's ``{'fusion': ('norm',)}``, since its fusion BN
    is the reference's ``norm``.
    """
    if not scope:
        return True
    top = name.split(".", 1)[0]
    aliases = aliases or {}
    words = [w.strip() for w in scope.split(",") if w.strip()]
    return any(_name_matches(top, m) for w in words for m in aliases.get(w, (w,)))


def save_checkpoint(exp_dir: str, prefix: str, epoch: int,
                    state_dict: Mapping[str, torch.Tensor]) -> str:
    """Write ``{exp_dir}/{prefix}_epoch_{epoch}.pth`` and its manifest line.

    Atomic: written to ``.tmp``, fsynced, renamed, and only then listed in
    the manifest, so a save cut short never leaves a manifest line pointing
    at a torn file (``find_previous`` resumes from the previous one).
    """
    os.makedirs(exp_dir, exist_ok=True)
    name = f"{prefix}_epoch_{epoch}.pth"
    path = os.path.join(exp_dir, name)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save({"state_dict": dict(state_dict), "epoch": int(epoch)}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    with open(os.path.join(exp_dir, MANIFEST), "a") as f:
        f.write(f"epoch {epoch}:{name}\n")
    return path


class AsyncCheckpointer:
    """Checkpoint writes off the training thread.

    :meth:`save` copies the state dict to host memory on the caller's thread
    (the training step may overwrite the parameters right after), and a
    worker thread serialises and writes it. :meth:`wait` blocks until every
    queued write is on disk and raises the first write error, if any;
    :meth:`close` waits, then stops the worker.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._error: BaseException | None = None
        self._worker = threading.Thread(target=self._run, name="checkpoint-writer", daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._error is None:
                    save_checkpoint(*item)
            except Exception as e:  # reported by wait() on the training thread
                self._error = e
            finally:
                self._q.task_done()

    def save(self, exp_dir: str, prefix: str, epoch: int,
             state_dict: Mapping[str, torch.Tensor]) -> None:
        host = {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()}
        self._q.put((exp_dir, prefix, epoch, host))

    def wait(self) -> None:
        self._q.join()
        if self._error is not None:
            raise RuntimeError("checkpoint write failed") from self._error

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._worker.is_alive():
                self._q.put(None)
                self._worker.join(timeout=60)


def find_previous(exp_dir: str):
    """Parse the manifest; return ``(epochs, paths)`` of the checkpoints that
    exist, in manifest order, or ``False`` (reference ``find_previous``)."""
    manifest = os.path.join(exp_dir, MANIFEST)
    if not os.path.exists(manifest):
        return False
    epochs, paths = [], []
    with open(manifest) as f:
        for line in f:
            m = re.match(r"epoch (\d+):(.*)", line.strip())
            if not m:
                continue
            path = os.path.join(exp_dir, m.group(2))
            if os.path.exists(path):
                epochs.append(int(m.group(1)))
                paths.append(path)
    if not epochs:
        return False
    return epochs, paths


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a ``.pth``: ours (``{"state_dict", "epoch"}``) or a
    bare one, ``module.`` prefixes (``DataParallel``) removed."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw["state_dict"] if isinstance(raw.get("state_dict"), Mapping) else raw
    return {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}


class Audit(NamedTuple):
    """A checkpoint's keys against a model's (:func:`audit_state_dict`), each
    group in the order its source lists them."""

    matched: List[str]
    missing: List[str]  # in the model, not in the checkpoint
    unexpected: List[str]  # in the checkpoint, not in the model
    shape_mismatched: List[str]  # in both, of other shapes

    @property
    def healthy(self) -> bool:
        return bool(self.matched) and not (self.missing or self.unexpected
                                           or self.shape_mismatched)


def audit_state_dict(model_sd: Mapping[str, torch.Tensor],
                     ckpt_sd: Mapping[str, torch.Tensor]) -> Audit:
    """Sort a checkpoint's keys against a model's state dict; BatchNorm's
    ``num_batches_tracked`` counters, which the reference's files may lack,
    count in no group."""
    skip = lambda k: k.endswith("num_batches_tracked")  # noqa: E731
    model_keys = [k for k in model_sd if not skip(k)]
    ckpt_keys = [k for k in ckpt_sd if not skip(k)]
    return Audit(
        matched=[k for k in model_keys
                 if k in ckpt_sd and tuple(ckpt_sd[k].shape) == tuple(model_sd[k].shape)],
        missing=[k for k in model_keys if k not in ckpt_sd],
        unexpected=[k for k in ckpt_keys if k not in model_sd],
        shape_mismatched=[k for k in model_keys
                          if k in ckpt_sd and tuple(ckpt_sd[k].shape) != tuple(model_sd[k].shape)])


def resume_checkpoint(state_dict: Mapping[str, torch.Tensor], path: str,
                      resume_scope: str = "", aliases=None) -> Dict[str, torch.Tensor]:
    """Load a checkpoint over ``state_dict`` as the reference does: only keys
    in both (the others printed), only names under ``resume_scope`` (with the
    model's scope ``aliases``, :func:`path_in_scope`) when it is given, only
    matching shapes. Returns a new state dict for ``load_state_dict``; the
    tensors not loaded are ``state_dict``'s own."""
    ckpt = load_state_dict_file(path)
    out = dict(state_dict)
    loaded, skipped = 0, []
    for k, v in ckpt.items():
        if k not in state_dict:
            skipped.append(k)
            continue
        if resume_scope and not path_in_scope(k, resume_scope, aliases):
            continue
        if tuple(state_dict[k].shape) != tuple(v.shape):
            skipped.append(k + " (shape)")
            continue
        out[k] = v.to(state_dict[k].dtype)
        loaded += 1
    missing = [k for k in state_dict if k not in ckpt]
    if skipped:
        print(f"resume: {len(skipped)} checkpoint keys unresolved: {skipped[:8]}...")
    if missing:
        print(f"resume: {len(missing)} model keys not in checkpoint (kept init)")
    print(f"resume: loaded {loaded}/{len(state_dict)} variables from {path}")
    return out
