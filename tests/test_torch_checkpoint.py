"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the
reference's format, so that checkpoints cross between the packages.

Round trip, ``keep_n`` and latest, a shape mismatch raising and the
asynchronous save, as the reference's own checks; a state mutated in place
right after ``maybe_save`` (the port's steps update their tensors in
place) restoring the values saved; bf16 leaves written byte for byte as
the reference writes them; and float32 and integer train states of a GNN
and of DIEN restored both ways: a port checkpoint through the reference's
``restore_checkpoint``, and the reverse, bit for bit.
"""
import filecmp
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.launch.steps as RS
from repro.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint import save_checkpoint as r_save
from repro.configs import get_arch as r_get_arch
from repro.optim import adamw_init as r_adamw_init
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                   restore_checkpoint, save_checkpoint)
from repro_torch.launch import steps as S
from repro_torch.runtime import load_into


def _toy():
    return {"a": {"w": torch.ones((4, 3)), "b": torch.zeros(3)},
            "c": torch.full((2,), 2.0),
            "s": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    tree = _toy()
    save_checkpoint(str(tmp_path), 7, tree)
    restored, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    assert restored["s"].dtype == np.int32 and restored["s"].shape == ()
    for k in ("c", "s"):
        np.testing.assert_array_equal(restored[k], tree[k].numpy())
    np.testing.assert_array_equal(restored["a"]["w"], tree["a"]["w"].numpy())


def test_checkpoint_keep_n_and_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, {"x": torch.full((3,), float(s))},
                        keep_n=2)
    restored, step = restore_checkpoint(str(tmp_path), {"x": torch.zeros(3)})
    assert step == 5 and restored["x"][0] == 5.0 and latest_step(
        str(tmp_path)) == 5
    assert len([d for d in os.listdir(tmp_path)
                if d.startswith("step_")]) == 2


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"x": torch.zeros(4)})


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=2, async_save=True)
    tree = {"x": torch.arange(5.0)}
    assert not mgr.maybe_save(1, tree)
    assert mgr.maybe_save(2, tree)
    mgr.wait()
    _, step = mgr.restore_latest(tree)
    assert step == 2


def test_in_place_mutation_after_save_does_not_reach_the_file(tmp_path):
    """The snapshot is copied before the writer thread starts: the next
    step's in-place update (here, at once) never reaches the file."""
    mgr = CheckpointManager(str(tmp_path), interval=1, async_save=True)
    x = torch.arange(1 << 20, dtype=torch.float32)
    state = {"x": x, "step": torch.tensor(3, dtype=torch.int32)}
    want = x.clone()
    assert mgr.maybe_save(1, state)
    x.mul_(-1.0)
    state["step"].add_(1)
    restored, _ = mgr.restore_latest(state)
    np.testing.assert_array_equal(restored["x"], want.numpy())
    assert int(restored["step"]) == 3
    load_into(state, restored)
    assert torch.equal(state["x"], want) and int(state["step"]) == 3


def test_bf16_leaf_is_written_as_the_reference_writes_it(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    save_checkpoint(str(tmp_path / "port"), 2, {"w": t})
    r_save(str(tmp_path / "ref"), 2, {"w": jnp.asarray(a)})
    leaf = os.path.join("step_0000000002", "leaf_00000.npy")
    assert filecmp.cmp(tmp_path / "port" / leaf, tmp_path / "ref" / leaf,
                       shallow=False)
    for d in ("port", "ref"):
        restored, _ = restore_checkpoint(str(tmp_path / d), {"w": t})
        assert restored["w"].dtype == torch.bfloat16
        assert torch.equal(restored["w"].view(torch.int16),
                           t.view(torch.int16))


def _reference_state(arch):
    spec = r_get_arch(arch)
    cfg = spec.make_smoke_config()
    params = (RS.gnn_init(cfg, jax.random.key(3)) if spec.family == "gnn"
              else __import__("repro.models.recsys", fromlist=["x"])
              .dien_init(cfg, jax.random.key(3)))
    opt = r_adamw_init(params)
    # moments and step as after a few steps
    opt = {"m": jax.tree.map(lambda p: p * 0.5, params),
           "v": jax.tree.map(lambda p: p * p, params),
           "step": jnp.int32(11)}
    return spec.family, {"params": params, "opt": opt}


@pytest.mark.parametrize("arch", ["gin-tu", "dien"])
def test_port_checkpoint_restores_through_the_reference(arch, tmp_path):
    family, r_state = _reference_state(arch)
    state = S.state_from_reference(family, jax.tree.map(np.asarray, r_state))
    save_checkpoint(str(tmp_path), 11, state)
    restored, step = r_restore(str(tmp_path), r_state)
    assert step == 11
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(r_state)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["gin-tu", "dien"])
def test_reference_checkpoint_restores_into_the_port(arch, tmp_path):
    family, r_state = _reference_state(arch)
    r_save(str(tmp_path), 11, r_state)
    target = S.state_from_reference(family, jax.tree.map(
        lambda a: np.zeros_like(np.asarray(a)), r_state))
    restored, step = restore_checkpoint(str(tmp_path), target)
    assert step == 11
    load_into(target, restored)
    for a, b in zip(jax.tree.leaves(S.state_to_numpy(target)),
                    jax.tree.leaves(r_state)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
