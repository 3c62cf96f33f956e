"""The port's fault-tolerant loop (``repro_torch.runtime``) on the CPU, as
the reference's checks drive its own: the runner recovers from an injected
failure by restoring the latest checkpoint and replaying (exactly-once
semantics), also when the failing step had already updated the state in
place; and the straggler watchdog."""
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime import (FailureInjector, StepWatchdog,
                                 TrainLoopRunner, elastic_restore,
                                 reshard_tree)


@pytest.mark.parametrize("in_place", [False, True])
def test_train_loop_recovers_from_injected_failure(tmp_path, in_place):
    calls = []
    fail = {"at": 7, "fired": False}

    def step(state, batch):
        calls.append(float(batch))
        if in_place:
            state["x"].add_(batch)
            # a failure after the update was applied in place
            if len(calls) == fail["at"] + 1 and not fail["fired"]:
                fail["fired"] = True
                raise RuntimeError("failed mid-update")
            return state, {"loss": float(batch)}
        return {"x": state["x"] + batch}, {"loss": float(batch)}

    ckpt = CheckpointManager(str(tmp_path), interval=5, async_save=False)
    runner = TrainLoopRunner(
        step, lambda i: torch.tensor(1.0), ckpt,
        failure_injector=None if in_place else FailureInjector([7]))
    state, metrics = runner.run({"x": torch.tensor(0.0)}, 12)
    assert runner.restarts == 1
    assert float(state["x"]) == 12.0          # exactly-once semantics
    assert len(metrics) == 14                 # 12 + 2 replayed


def test_straggler_watchdog():
    wd = StepWatchdog(factor=3.0, window=16)
    for i in range(10):
        wd.observe(i, 0.1)
    wd.observe(10, 1.0)
    assert len(wd.events) == 1 and wd.events[0][0] == 10


def test_restarts_are_bounded(tmp_path):
    def step(state, batch):
        raise RuntimeError("always")

    runner = TrainLoopRunner(step, lambda i: None,
                             CheckpointManager(str(tmp_path), interval=1),
                             max_restarts=2)
    with pytest.raises(RuntimeError, match="always"):
        runner.run({"x": torch.tensor(0.0)}, 3)
    assert runner.restarts == 3


def test_elastic_waits_for_the_mesh(tmp_path):
    """``reshard_tree`` and ``elastic_restore`` on a one-rank ``DeviceMesh``
    (a gloo group): every leaf a DTensor of its spec's placements with the
    saved value, bit for bit; no checkpoint gives (None, None)."""
    import socket
    import torch.distributed as dist
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.dist.sharding import P
    from repro_torch.launch.mesh import make_device_mesh
    tree = {"w": torch.randn(4, 6, generator=torch.Generator().manual_seed(0)),
            "b": torch.arange(6, dtype=torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32)}
    specs = {"w": P(("data",), "model"), "b": P(None), "step": P()}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_device_mesh((1, 1), ("data", "model"), device="cpu")
        placed = reshard_tree(tree, mesh, specs)
        assert elastic_restore(str(tmp_path / "none"), tree, mesh,
                               specs) == (None, None)
        save_checkpoint(str(tmp_path / "ck"), 5, placed)
        restored, step = elastic_restore(str(tmp_path / "ck"), tree, mesh,
                                         specs)
        assert step == 5
        for k, v in tree.items():
            for got in (placed[k], restored[k]):
                assert got.device_mesh is mesh
                assert got.dtype == v.dtype
                assert torch.equal(got.full_tensor(), v)
        placed["w"].to_local().add_(1)      # a copy: the tree is untouched
        assert not torch.equal(placed["w"].full_tensor(), tree["w"])
    finally:
        dist.destroy_process_group()
