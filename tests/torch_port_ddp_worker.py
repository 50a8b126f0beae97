"""One rank of the port's data-parallel runs (imports no JAX; runs on the card's machine).

    python tests/torch_port_ddp_worker.py --rank R --world W --port P --job JOB --out OUT \
        [--device cpu|cuda|cuda:K] [--backend gloo|nccl]
    python -m torch.distributed.run --nproc_per_node N tests/torch_port_ddp_worker.py \
        --lifecycle CFG --out OUT [--device ...] [--backend ...] [--synthetic-voc SEED,SIZE]

Train steps (``tests/test_torch_port_ddp.py``, ``chip_smoke.py`` phase 16b):
joins a process group of ``W`` ranks on ``localhost:P`` (gloo on the CPU,
NCCL on the cards unless ``--backend`` says otherwise; ``--device cuda:0``
with gloo puts every rank on card 0), then for each run of ``JOB`` (a
``torch.save``d dict of named runs) builds the port's model from the run's
``MODEL`` config, loads its state dict, makes it float64 on this rank's
device, wraps it in ``DistributedDataParallel`` and takes the run's train
steps through ``ssds_tpu_torch.solver.build_train_step`` on this rank's rows
of the global batch. Writes ``OUT``: for each run ``[(loss_l, loss_c, state
dict)]``, the start first (losses ``None``; the losses are the ranks' means),
and the augmentation parameters this rank applied. :func:`launch` and
:func:`collect` start and wait for such ranks; :func:`errors` compares two
runs' steps.

A run may switch one global reduction off, as a plain DDP would leave it:
``per_rank_stats`` (BatchNorm on this rank's statistics) or
``per_rank_normaliser`` (the MultiBox loss over this rank's positives).

Spatial runs (``tests/test_torch_port_spatial.py``, ``chip_smoke.py`` phase
18): ``spatial`` S > 1 puts the ``W`` ranks on a ``W/S x S`` layout: the
model is partitioned (``ssds_tpu_torch.parallel.spatial``) and not wrapped
in DDP, each data group takes its rows of the global batch, and the step
takes the spatial plan; the run's output adds the halo and gather transfers
it made. ``compact`` (a model too wide to write every rank's float64
states) keeps rank 0's weights and biases as float32 differences from the
run's start and no start, every other rank's state not at all, and adds
each rank's ``last_digest`` of its last state (:func:`expand` rebuilds
rank 0's steps). ``remat`` runs the step under ``TPU.REMAT``. Two controls
break the spatial step on purpose: ``zero_halo`` (each band padded with
zeros where its neighbours' rows belong, and no halo gradient sent back)
and ``normaliser_copies`` (the positives counted once on each of the S
ranks).

``--lifecycle`` (``tests/test_torch_port_ddp_lifecycle.py``, ``chip_smoke.py``
phase 16c): the rank of a ``torch.distributed.run`` launch joins the group
its environment describes, runs ``Solver.train_model`` (with the eval that
``CFG``, a YAML or JSON config, asks for), saves its state dict, times
``test_model``, then times 20 train steps after 3 (synchronised), and writes
``OUT.<rank>.json`` (every scalar the Solver wrote, the test mAP and seconds,
the step's milliseconds, the NMS kernel's launches, a step's spatial
transfers (``halo_messages`` / ``halo_bytes``, ``gather_messages`` /
``gather_bytes``, this rank's sends, forward and backward); under several ranks the
milliseconds of one BatchNorm-statistics all-reduce and of one all-reduce of
every trainable parameter's gradient, timed alone) and ``OUT.<rank>.pt``
(the state dict after training). ``--synthetic-voc SEED,SIZE`` draws the VOC
images in memory (``ssds_tpu_torch.tools.synth_voc``).
"""

import argparse
import contextlib
import json
import os
import sys
from unittest import mock

import torch


HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(tmp, name, runs, world, device="cpu", backend=None):
    """Start ``world`` ranks of this script on the named ``runs`` (a dict of
    run dicts, saved under the directory ``tmp``) on ``device`` with
    ``backend``; returns ``(processes, output paths)`` for :func:`collect`.
    Each rank's output goes to a file beside its results (a pipe that no one
    reads while a rank waits for another would stall both)."""
    import subprocess

    job = os.path.join(tmp, f"{name}.pt")
    torch.save(runs, job)
    port = free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=os.pathsep.join([REPO, HERE]), OMP_NUM_THREADS="1",
               PYTHONFAULTHANDLER="1")
    outs = [os.path.join(tmp, f"{name}_{r}.out") for r in range(world)]
    procs = []
    for r in range(world):
        with open(f"{outs[r]}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_port_ddp_worker.py"), "--rank", str(r),
                 "--world", str(world), "--port", str(port), "--job", job, "--out", outs[r],
                 "--device", str(device)] + (["--backend", backend] if backend else []),
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    return procs, outs


def collect(procs, outs, timeout=600):
    """Wait for :func:`launch`'s ranks; returns each rank's results. Ranks
    still running after ``timeout`` seconds dump their stacks (SIGABRT under
    ``PYTHONFAULTHANDLER``) into the failure's report."""
    import signal
    import subprocess
    import time

    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    if q.poll() is None:
                        q.send_signal(signal.SIGABRT)
                time.sleep(2)
                break
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        with open(f"{out}.log") as f:
            log = f.read()
        if p.returncode != 0 or f"DDP_WORKER_OK rank={r}" not in log:
            raise AssertionError(f"rank {r} failed (rc {p.returncode}):\n{log[-6000:]}")
    return [torch.load(o, weights_only=False) for o in outs]


def _values(sd):
    return {k for k in sd if not k.endswith("num_batches_tracked")}


def errors(got, want):
    """Per step: ``(loss rel. error, largest update error over the largest
    update, largest statistic error over that statistic's largest value)``."""
    start = want[0][2]
    rows = []
    for (gl, gc, gsd), (wl, wc, wsd) in zip(got[1:], want[1:]):
        assert _values(gsd) == _values(wsd)
        loss = max(abs(gl - wl) / abs(wl), abs(gc - wc) / abs(wc))
        params = [n for n in wsd if n.endswith(("weight", "bias"))]
        umax = max(float((wsd[n] - start[n]).abs().max()) for n in params)
        upd = max(float((gsd[n] - wsd[n]).abs().max()) for n in params) / umax
        stats = [n for n in wsd if n.endswith(("running_mean", "running_var"))]
        stat = max((float((gsd[n] - wsd[n]).abs().max() / wsd[n].abs().max()) for n in stats),
                   default=0.0)  # a model without BatchNorm has none
        rows.append((loss, upd, stat))
    return rows


def running_stats_err(got, want):
    """The largest running-statistic error of state dict ``got`` against
    ``want``: a mean in units of its channel's standard deviation, a
    variance relative to itself (``chip_smoke.py`` phase 9's measure: a BatchNorm fed by
    another has running means of rounding size, which no measure relative
    to the largest value can hold)."""
    err = 0.0
    for n in want:
        if n.endswith(("running_mean", "running_var")):
            scale = (want[n[:-len("mean")] + "var"].sqrt() if n.endswith("running_mean")
                     else want[n])
            err = max(err, float(((got[n] - want[n]).abs() / scale).max()))
    return err


def _zero_halo(transfer):
    """``SpatialPlan.transfer`` with the halo rows replaced by zeros (nothing
    sent, in either direction); the head gather still moves its rows."""

    def fake(self, sends, recvs, like, kind):
        if kind != "halo":
            return transfer(self, sends, recvs, like, kind)
        return [like.new_zeros((like.shape[0], like.shape[1], n, like.shape[3]))
                for _, n in recvs]

    return fake


def run_steps(run, world, rank, device):
    from ssds_tpu_torch import solver
    from ssds_tpu_torch.models import layers
    from ssds_tpu_torch.models.builder import create_model, init_model
    from ssds_tpu_torch.ops import augment_device
    from ssds_tpu_torch.parallel import spatial

    model = init_model(create_model(run["model"])[0])
    model.load_state_dict(run["state_dict"], strict=True)
    model.double().train().to(device)
    tc = run["train_cfg"]
    opt = solver.configure_optimizer(tc, model.named_parameters())
    width = run.get("spatial", 1)
    net, plan = model, None
    if width > 1:
        spatial.partition(model, run["model"].IMAGE_SIZE)
        plan = spatial.SpatialPlan.for_rank(rank, world, width)
    elif world > 1:
        net = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False)
    priors = None if run["priors"] is None else torch.from_numpy(run["priors"]).to(device)
    step = solver.build_train_step(net, priors, opt, solver.configure_lr_scheduler(tc, 1),
                                   torch.float64, run["means"],
                                   device_aug_prob=run.get("device_aug_prob", 0.0),
                                   plan=plan, remat=run.get("remat", False))
    b = run["batch"]["images"].shape[0] // (world // width)
    group = rank // width
    local = {k: torch.from_numpy(v[group * b:(group + 1) * b]).to(device)
             for k, v in run["batch"].items()}

    def snapshot():
        return {k: (v.detach().double() if v.is_floating_point() else v).cpu().clone()
                for k, v in model.state_dict().items()}

    compact, start = run.get("compact", False), run["state_dict"]

    def keep(sd):
        """A step's state: whole, or under ``compact`` on rank 0 with each
        weight and bias as its float32 difference from the run's start
        (another rank keeps none)."""
        if not compact:
            return sd
        if rank:
            return None
        return {k: (v - start[k].double()).float() if k.endswith(("weight", "bias")) else v
                for k, v in sd.items()}

    applied = []
    apply_params = augment_device.apply_params

    def record(images, boxes, valid, params, means):
        applied.append(params)
        return apply_params(images, boxes, valid, params, means)

    loss_fn = solver.detection_loss
    patches = [mock.patch.object(augment_device, "apply_params", record)]
    if run.get("per_rank_stats"):
        patches.append(mock.patch.object(layers, "global_statistics", lambda: False))
    if run.get("per_rank_normaliser"):
        patches.append(mock.patch.object(
            solver, "detection_loss",
            lambda *a, **k: loss_fn(*a, **{**k, "data_parallel": False})))
    if run.get("normaliser_copies"):  # the positives' sum over the world not divided by S
        patches.append(mock.patch.object(
            solver, "detection_loss", lambda *a, **k: tuple(v / width for v in loss_fn(*a, **k))))
    if run.get("zero_halo"):
        patches.append(mock.patch.object(spatial.SpatialPlan, "transfer",
                                         _zero_halo(spatial.SpatialPlan.transfer)))
    out = [(None, None, None if compact else snapshot())]
    spatial.reset_counters()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        for i in range(run["steps"]):
            m = step(local, run.get("start", 0) + i)
            ll, lc = solver.sharding.all_reduce_mean([m["loss_l"], m["loss_c"]])
            sd = snapshot()
            out.append((ll, lc, keep(sd)))
    result = {"steps": out, "applied": [type(p)(*(t.cpu() for t in p)) for p in applied],
              "transfers": dict(spatial.counters)}
    if compact:
        result["last_digest"] = digest(sd)
    return result


def expand(run, out):
    """Rank 0's steps of a ``compact`` run (``out``, its output) as
    :func:`errors` takes them: the start (the run's state dict) and each
    step's state, its weights and biases from their float32 differences, in
    float64."""
    start = {k: v.double() if v.is_floating_point() else v for k, v in run["state_dict"].items()}
    return [(None, None, start)] + [
        (ll, lc, {k: start[k] + d.double() if d.dtype == torch.float32 else d
                  for k, d in sd.items()}) for ll, lc, sd in out["steps"][1:]]


def digest(sd):
    """A SHA-256 of a state dict's tensors, in key order: equal states,
    equal digests."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].contiguous().numpy().tobytes())
    return h.hexdigest()


class RecordingWriter:
    """A summary writer that keeps every scalar."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, float(value)))


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the lifecycle's timed train steps, after its warm-up steps (the steps were
# 20 after 3: 10 after 2 keep chip_smoke.py inside its time)
TIMED_WARMUP, TIMED_STEPS = 2, 10


def lifecycle(cfg_path, out, device):
    import time

    from ssds_tpu_torch.config import cfg_from_file
    from ssds_tpu_torch.ops.cuda.nms import nms_mask
    from ssds_tpu_torch.parallel import sharding, spatial
    from ssds_tpu_torch.solver import Solver

    writer = RecordingWriter()
    solver = Solver(cfg_from_file(cfg_path), device=device, writer=writer)
    rank = sharding.rank()
    try:
        solver.train_model()
        torch.save(solver.model.state_dict(), f"{out}.{rank}.pt")
        t0 = time.perf_counter()
        test_map = solver.test_model()
        test_s = time.perf_counter() - t0
        host = next(iter(solver.get_loader("train")))
        for i in range(TIMED_WARMUP + TIMED_STEPS):
            if i == TIMED_WARMUP:
                _synchronize(solver.device)
                spatial.reset_counters()
                t0 = time.perf_counter()
            solver._train_step(solver._upload(host), solver.step)
        _synchronize(solver.device)
        step_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        transfers = {k: v / TIMED_STEPS for k, v in spatial.counters.items()}  # a step's
        collectives = {}
        if sharding.world_size() > 1:  # what the step's collectives cost alone
            n_grads = sum(p.numel() for p in solver.model.parameters() if p.requires_grad)
            for key, t, n in (("allreduce_bn_ms", torch.zeros(3, 96, device=solver.device), 50),
                              ("allreduce_grads_ms", torch.zeros(n_grads, device=solver.device), 5)):
                for i in range(n + 2):
                    if i == 2:
                        _synchronize(solver.device)
                        t0 = time.perf_counter()
                    sharding.all_reduce_sum_(t)
                _synchronize(solver.device)
                collectives[key] = (time.perf_counter() - t0) / n * 1e3
    finally:
        solver.close()
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump({"world": solver.world, "device": str(solver.device),
                   "scalars": writer.scalars, "test_map": test_map, "test_s": test_s,
                   "test_images": len(solver.get_loader("test").dataset),
                   "train_step_ms": step_ms, "nms_launches": nms_mask.launches,
                   "spatial": solver.spatial_size, **transfers, **collectives},
                  f)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int)
    parser.add_argument("--world", type=int)
    parser.add_argument("--port", type=int, help="without a launcher: the group's port")
    parser.add_argument("--job")
    parser.add_argument("--lifecycle", help="a config file: the Solver's lifecycle")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--backend", default=None)
    parser.add_argument("--synthetic-voc", default="", help="SEED,SIZE")
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    torch.set_num_threads(1)
    if args.port is not None:
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(args.port),
                          RANK=str(args.rank), WORLD_SIZE=str(args.world),
                          LOCAL_RANK=str(args.rank))
    if args.synthetic_voc:
        from ssds_tpu_torch.data import factory
        from ssds_tpu_torch.tools.synth_voc import in_memory_voc

        seed, size = (int(v) for v in args.synthetic_voc.split(","))
        factory.dataset_map["voc"] = in_memory_voc(seed, size)
    from ssds_tpu_torch.parallel import sharding

    sharding.initialize_distributed(backend=args.backend, device=args.device)
    try:
        if args.lifecycle:
            lifecycle(args.lifecycle, args.out, args.device)
        else:
            device = sharding.rank_device(args.device)
            runs = torch.load(args.job, weights_only=False)
            torch.save({name: run_steps(run, sharding.world_size(), sharding.rank(), device)
                        for name, run in runs.items()}, args.out)
        rank = sharding.rank()
    finally:
        sharding.destroy_distributed()
    assert "jax" not in sys.modules
    print(f"DDP_WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
