"""Multi-process training through the command line: two processes of
``python -m music_tpu_torch wavenet train --device cpu --dist-backend gloo
--coordinator ... --num-processes 2 --process-id i`` form one gloo process
group and train data-parallel, each on its rows of every batch; they must
reproduce the single-process run's losses and final weights on the same
global batches (as ``tests/test_multihost.py`` holds the JAX cluster to one
process).  Also the host-side pieces of ``parallel.multihost`` against the
JAX package's."""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from music_tpu.parallel import multihost as jmultihost
from music_tpu_torch.core import checkpoint as tck
from music_tpu_torch.parallel import launch, multihost
from music_tpu_torch.parallel.mesh import GROUPS, Mesh
from music_tpu_torch.train import wavenet_train as ttrain
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TINY_WN = {"filter_width": 2, "dilations": [1, 2, 4, 8], "dilation_channels": 4,
           "residual_channels": 4, "skip_channels": 8, "quantization_channels": 32,
           "use_bias": False}


def _params_dir(root: Path, tag: str) -> Path:
    """A params dir whose runs write under ``root/tag``: 3 clips of 4
    windows (17 + 16 codes), batch 4, 2 epochs of 3 steps, a loss line a
    step."""
    clips = [np.random.default_rng(i).integers(0, 32, 81).astype(np.int32) for i in range(3)]
    with (root / "np_audio.pkl").open("wb") as f:
        pickle.dump(clips, f)
    d = root / f"params_{tag}"
    d.mkdir()
    (d / "wavenet_params.json").write_text(json.dumps(TINY_WN))
    (d / "dataset_params.json").write_text(json.dumps(
        {"audio_path": str(root / "np_audio.pkl"), "window_length": 16, "batch_size": 4}))
    (d / "train_params.json").write_text(json.dumps(
        {"optimizer": "adam", "learning_rate": 1e-2, "num_epochs": 2, "print_every": 1,
         "seed": 0, "log_dir": str(root / tag / "logs"),
         "restore_dir": str(root / tag / "ckpt")}))
    return d


def _losses(log_dir: Path) -> list[float]:
    return [json.loads(line)["loss"] for line in (log_dir / "metrics.jsonl").open()
            if '"kind": "loss"' in line]


def test_two_process_cli_reproduces_the_single_process_run(tmp_path):
    single = _params_dir(tmp_path, "single")
    p = {f.stem: json.loads(f.read_text()) for f in single.glob("*.json")}
    ref_state = ttrain.train(wavenet_params=p["wavenet_params"],
                             dataset_params=p["dataset_params"],
                             train_params=p["train_params"], device="cpu")
    multi = _params_dir(tmp_path, "multi")
    port = launch.free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "music_tpu_torch", "wavenet", "train", "--params-dir",
         str(multi), "--device", "cpu", "--dist-backend", "gloo", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(pid)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for proc in procs:
            proc.kill()
    ref = _losses(tmp_path / "single" / "logs")
    assert len(ref) == 6
    # rank 0 logged every step once (rank 1 prints nothing of its own)
    np.testing.assert_allclose(_losses(tmp_path / "multi" / "logs"), ref, rtol=1e-5)
    assert "loss=" in outs[0] and "loss=" not in outs[1]
    assert tck.all_steps(tmp_path / "multi" / "ckpt") == [3, 6]
    ours = tck.restore_subtree(tmp_path / "multi" / "ckpt", ".params")
    for k, v in ref_state.params.items():
        np.testing.assert_allclose(ours[k], v.numpy(), rtol=0,
                                   atol=1e-5 * float(v.abs().max()), err_msg=k)


@pytest.mark.parametrize("n,data", [(8, 1), (8, 2), (12, 3), (16, 4)])
def test_host_shard_gives_each_rank_its_data_coordinates_rows(n, data):
    """On a (data, 2, 1) mesh ranks along ``seq`` share their rows; without
    a mesh or process group, one process holds every row, as JAX's
    ``host_shard`` on one process."""
    ranks = np.arange(data * 2).reshape(data, 2, 1)
    batch = np.arange(n * 3).reshape(n, 3)
    for r in range(ranks.size):
        mesh = Mesh(ranks, r, torch.device("cpu"), {g: None for g in GROUPS})
        d = r // 2
        assert multihost.host_shard(n, mesh) == slice(d * n // data, (d + 1) * n // data)
        np.testing.assert_array_equal(multihost.put_global_batch(mesh, batch).numpy(),
                                      batch[multihost.host_shard(n, mesh)])
    assert multihost.host_shard(n) == jmultihost.host_shard(n) == slice(0, n)
    if data > 1:
        with pytest.raises(ValueError, match="divisible"):
            multihost.host_shard(n + 1, Mesh(ranks, 0, torch.device("cpu"),
                                             {g: None for g in GROUPS}))


def test_initialize_is_a_no_op_alone_and_refuses_half_a_cluster():
    multihost.initialize()  # one process: nothing to join
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize("127.0.0.1:1", 2, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        multihost.initialize("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")
    assert multihost.fetch_scalar(torch.tensor(2.5)) == 2.5
