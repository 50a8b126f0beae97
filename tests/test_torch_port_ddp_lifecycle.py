"""The port's Solver under two gloo ranks: train, checkpoint, sharded eval and test.

``python -m torch.distributed.run --nproc_per_node 2`` launches
``tests/torch_port_ddp_worker.py --lifecycle`` (each rank: ``Solver.train_model``
for one epoch with the eval of that epoch, then ``test_model``, on the CPU)
over ``tests/test_solver_e2e.py::make_voc``'s tree, as
``tests/test_distributed_2proc.py`` drives the JAX package. Held: rank 0
alone writes, so the manifest has one line and there is one checkpoint; both
ranks report the same eval losses and mAP and the same test mAP; and a
1-process ``test_model`` on the checkpoint scores the same detections (the
VOC result files rank 0 wrote are byte-identical to the 1-process run's) and
gives that mAP. Then the merge alone, with ``procs`` / ``pid`` / ``gather``
injected as ``tests/test_solver_e2e.py`` injects them into the JAX solver.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from ssds_tpu_torch.config import cfg_from_file
from ssds_tpu_torch.solver import Solver
from test_solver_e2e import CFG_TEMPLATE, make_voc
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from torch_port_ddp_worker import free_port

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _config(tmp_path, epochs=1):
    root, exp = str(tmp_path / "VOCdevkit"), str(tmp_path / "exp")
    make_voc(root, n_images=8)
    make_voc(root, n_images=8, split="test")
    text = CFG_TEMPLATE.format(root=root, exp=exp, epochs=epochs, ckpt_epochs=1, prob=-1)
    # inline loading: no fork of a process that runs JAX's threads
    text = text.replace("NUM_WORKERS: 2", "NUM_WORKERS: 0")
    text = text.replace("PHASE: ['train']", "PHASE: ['train', 'eval']").replace(
        "TEST_SCOPE: [1000, 1001]", f"TEST_SCOPE: [{epochs}, {epochs}]")
    path = str(tmp_path / "cfg.yml")
    with open(path, "w") as f:
        f.write(text)
    return path, exp


def _results(exp):
    d = os.path.join(exp, "results")
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = f.read()
    return out


def test_two_rank_lifecycle_equals_one_process_test(tmp_path):
    cfg_path, exp = _config(tmp_path)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=os.pathsep.join([REPO, HERE]), OMP_NUM_THREADS="1")
    out = str(tmp_path / "rank")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_addr", "localhost", "--master_port", str(free_port()),
         os.path.join(HERE, "torch_port_ddp_worker.py"), "--lifecycle", cfg_path, "--out", out],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("DDP_WORKER_OK") == 2, proc.stdout[-3000:]
    ranks = []
    for r in range(2):
        with open(f"{out}.{r}.json") as f:
            ranks.append(json.load(f))
    assert [r["world"] for r in ranks] == [2, 2]

    with open(os.path.join(exp, "checkpoint_list.txt")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    assert lines == ["epoch 1:smoke_epoch_1.pth"], lines
    assert sorted(n for n in os.listdir(exp) if n.endswith(".pth")) == ["smoke_epoch_1.pth"]

    # the same losses and mAP on both ranks (the eval's and the train's)
    a, b = (r["scalars"] for r in ranks)
    assert a == b and a["Eval/mAP"][0][0] == 1, (a, b)
    assert ranks[0]["test_map"] == ranks[1]["test_map"] == a["Eval/mAP"][0][1]
    merged = _results(exp)
    assert sum(len(v) for v in merged.values()) > 0  # the untrained model still detects

    # one process on the checkpoint: the same detections, the same mAP
    shutil.rmtree(os.path.join(exp, "results"))
    solver = Solver(cfg_from_file(cfg_path), device="cpu", writer=_NoWriter())
    try:
        single = solver.test_model()
    finally:
        solver.close()
    print(f"2 ranks: eval mAP {a['Eval/mAP'][0][1]}, test mAP {ranks[0]['test_map']}; "
          f"1 process: {single}")
    assert _results(exp) == merged
    assert single == ranks[0]["test_map"]


class _NoWriter:
    def add_scalar(self, tag, value, step):
        pass


def test_eval_merge_with_injected_gather(tmp_path):
    """``_run_detection_eval`` with ``procs=2`` and an injected ``gather``:
    rank 0's range, rank 1's range forwarded alongside, the merged
    detections (result files), losses and mAP equal to one process's."""
    cfg_path, exp = _config(tmp_path)
    solver = Solver(cfg_from_file(cfg_path), device="cpu", writer=_NoWriter())
    try:
        loader = solver.get_loader("test")
        n = len(loader.dataset)
        single = solver._run_detection_eval(loader, with_loss=True)
        single_files = _results(exp)
        shutil.rmtree(os.path.join(exp, "results"))
        calls = []

        def gather(local):
            calls.append(local)
            if len(calls) == 1:  # the detections and loss sums
                return [local, solver._collect_detections(loader.range_view(n // 2, n),
                                                          offset=n // 2, with_loss=True)]
            return [local, None]  # the mAP, which rank 0 scores
        merged = solver._run_detection_eval(loader, procs=2, pid=0, gather=gather,
                                            with_loss=True)
        assert len(calls) == 2 and set(calls[0][0]) <= set(range(n // 2))
        assert _results(exp) == single_files
        assert merged == pytest.approx(single, rel=1e-12, abs=1e-12)

        # rank 1 forwards the second range and takes rank 0's mAP
        got = solver._run_detection_eval(
            loader, procs=2, pid=1, with_loss=False,
            gather=lambda local: [({}, None), local] if isinstance(local, tuple) else [0.25, local])
        assert got == 0.25
    finally:
        solver.close()


def test_mesh_config_maps_onto_the_world_size(monkeypatch):
    """``TPU.MESH`` against the launch: DATA -1 / 0 take the world size over
    SPATIAL and another value must equal it, the world must divide by
    SPATIAL, and the global batch must divide by the data width; one process
    needs no group."""
    from ssds_tpu_torch.config import default_config
    from ssds_tpu_torch.parallel import sharding

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert sharding.initialize_distributed(device="cpu") is False
    assert (sharding.world_size(), sharding.rank(), sharding.is_main()) == (1, 0, True)
    assert sharding.allgather_pickled({"a": 1}) == [{"a": 1}]
    assert str(sharding.rank_device("cuda")) == "cuda"  # one process: as given
    tpu = default_config().TPU
    monkeypatch.setattr(sharding, "world_size", lambda: 2)
    for data in (-1, 0, 2):
        tpu.MESH.DATA = data
        assert sharding.data_parallel_size(tpu, 32) == 2
    tpu.MESH.DATA = 4
    with pytest.raises(ValueError, match="2 ranks"):
        sharding.data_parallel_size(tpu, 32)
    tpu.MESH.DATA = -1
    with pytest.raises(ValueError, match="divide"):
        sharding.data_parallel_size(tpu, 33)
    tpu.MESH.SPATIAL = 2  # 1 x 2: one data group of two bands
    assert (sharding.data_parallel_size(tpu, 33), sharding.spatial_size(tpu)) == (1, 2)
    tpu.MESH.DATA = 2
    with pytest.raises(ValueError, match="data width of 1"):
        sharding.data_parallel_size(tpu, 32)
    tpu.MESH.DATA, tpu.MESH.SPATIAL = -1, 3
    with pytest.raises(ValueError, match="do not divide"):
        sharding.data_parallel_size(tpu, 32)
