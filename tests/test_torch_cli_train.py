"""The port's training CLI on the CPU at a tiny size: three steps write a
snapshot, and ``--resume`` continues from step 3."""

import os

import numpy as np
import pytest
import torch

from gpcr_tpu_torch.cli import train as T

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

TINY = ["--device", "cpu", "--batch_size", "1", "--n_points", "256",
        "--n_views", "1", "--hw", "16", "--channels", "9 8 8 8 8 8",
        "--log_every", "1", "--warmup", "2", "--lr", "1e-3"]


def test_train_cli_checkpoints_and_resumes(tmp_path):
    out_dir = str(tmp_path / "run")
    first = T.main(["--steps", "3", "--out_dir", out_dir, *TINY])
    ckpt = os.path.join(out_dir, "checkpoint", "step_3.pt")
    assert os.path.isfile(ckpt)
    assert first["start_step"] == 0
    assert [h["step"] for h in first["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in first["history"])
    state = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert state["step"] == 3 and state["optimizer"]["count"] == 3
    trained = {k: v.clone() for k, v in
               first["trainer"].model.state_dict().items()}

    second = T.main(["--steps", "5", "--resume", "--out_dir", out_dir, *TINY])
    assert second["start_step"] == 3
    assert [h["step"] for h in second["history"]] == [4, 5]
    assert second["trainer"].optimizer.count == 5
    assert os.path.isfile(os.path.join(out_dir, "checkpoint", "step_5.pt"))
    # the resumed run started from the trained weights, and moved on
    moved = [k for k, v in second["trainer"].model.state_dict().items()
             if not torch.equal(v, trained[k])]
    assert moved

    # without --resume the run starts over
    third = T.main(["--steps", "1", "--out_dir", out_dir, *TINY])
    assert third["start_step"] == 0


def test_train_cli_refuses_what_is_not_ported():
    # dp x sp must equal the world: one process cannot take --sp 2
    with pytest.raises(ValueError, match="world"):
        T.main(["--sp", "2", *TINY])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.main(["--steps", "1", "--device", "cuda"])


def test_train_cli_sp_in_a_world_of_one(tmp_path):
    """``--sp 1`` in a one-rank gloo group (the dp x sp path: replicate,
    shard_batch, the all-reduced gradients and metrics) takes the same two
    steps as the run without a process group; rank 0 writes the
    checkpoint."""
    import torch.distributed as dist

    from gpcr_tpu_torch.parallel import distributed

    argv = ["--steps", "2", "--sp", "1", *TINY]
    ref = T.main(["--out_dir", str(tmp_path / "ref"), *argv])
    assert ref["trainer"].mesh is None  # no group: the one-process step
    assert distributed.initialize(
        init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
        rank=0, backend="gloo")
    try:
        got = T.main(["--out_dir", str(tmp_path / "sp"), *argv])
        assert got["trainer"].mesh.world is not None
    finally:
        dist.destroy_process_group()
    assert [h["loss"] for h in got["history"]] == [
        h["loss"] for h in ref["history"]]
    want = ref["trainer"].model.state_dict()
    for k, v in got["trainer"].model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert os.path.isfile(tmp_path / "sp" / "checkpoint" / "step_2.pt")
