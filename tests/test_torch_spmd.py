"""The port's sharded execution on 8 gloo ranks (``repro_torch.dist.sharding``
placements on a ``torch.distributed`` ``DeviceMesh``, the LM train step
on DTensors, ``runtime.elastic`` and ``optim.compressed_psum``) against
the reference and against the port's one-process step.

One module-scoped world of 8 ranks (``torch.multiprocessing.spawn``)
runs every case; the problems go to the ranks in a file and the results
come back in files.  The cases:

- the reference's SPMD case (``tests/test_sharding_rules.py``: its config,
  an (8, 16) batch, its weights carried over) on a (2, 4) ``("data",
  "model")`` mesh, under ``remat`` none, full and dots and 1 and 2
  microbatches: the loss within 1e-4 of the reference's single-device
  ``make_lm_train_step`` loss (the reference's own bound), within 1e-5 of
  the port's one-process step, and every parameter after the step within
  1e-5 of its leaf's largest magnitude;
- the MoE layer's two rule branches on (2, 4): 8 experts (expert parallel
  over ``"model"``) and 6 (the ff dim's tensor parallelism), with global
  and grouped dispatch: loss and aux within 1e-5 of one process, every
  gradient leaf within 1e-5 of its largest magnitude;
- elastic restore: a state sharded on (2, 4) saved (its files byte-equal
  to an unsharded save of the same values), restored onto (8, 1) and (1,
  8), every leaf's whole value bit-equal to the saved one; a checkpoint
  the reference wrote restored onto (2, 4);
- ``compressed_psum`` over ``"data"`` and over ``"model"``, every rank its
  own gradient and residual, against the reference's under ``shard_map``
  on 8 emulated host devices (a subprocess): within 1e-6 of the largest
  element.

The module imports neither jax nor the reference at its top, so that the
ranks (which import it) start without them.
"""
import functools
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
MESH = (2, 4)
#: the reference's SPMD config (tests/test_sharding_rules.py)
CFG = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           d_ff=128, vocab=128)
BATCH = (8, 16)
SPMD_CASES = [(remat, mb) for remat in ("none", "full", "dots")
              for mb in (1, 2)]
#: (experts, dispatch groups): 8 divides the model axis (expert parallel),
#: 6 does not (the ff dim's tensor parallelism)
MOE_CASES = [(8, 1), (8, 4), (6, 1), (6, 4)]
ELASTIC_MESHES = [(8, 1), (1, 8)]
PSUM_AXES = ("data", "model")
PSUM_N = 4096
REF_LOSS_TOL, TOL = 1e-4, 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _moe_cfg(experts: int, groups: int):
    from repro_torch.models.transformer import MoEConfig, TransformerConfig
    return TransformerConfig(
        name="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=128, qk_norm=True,
        moe=MoEConfig(num_experts=experts, top_k=2, d_ff_expert=16,
                      num_shared=1, dispatch_groups=groups))


def _batch(tokens):
    t = torch.from_numpy(np.asarray(tokens))
    return {"tokens": t, "targets": torch.roll(t, -1, 1)}


def _whole(tree):
    from repro_torch.dist.sharding import replicated_value
    from repro_torch.optim.adamw import tree_leaves
    return [replicated_value(t).detach().clone() for t in tree_leaves(tree)]


def _place(tree, mesh, specs):
    from repro_torch.runtime import reshard_tree
    return reshard_tree(tree, mesh, specs)


def _state_specs(mesh, params):
    from repro_torch.dist.sharding import lm_param_specs, opt_state_specs
    p = lm_param_specs(mesh, params)
    return {"params": p, "opt": opt_state_specs(p)}


def _spmd_step(mesh, prob, remat, mb):
    """One sharded train step of the reference's case: (loss, whole
    parameters after it)."""
    from repro_torch.dist.sharding import lm_batch_specs
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cfg = T.TransformerConfig(**CFG, remat=remat)
    params = T.params_from_reference(prob["params"])
    state = _place({"params": params, "opt": adamw_init(params)}, mesh,
                   _state_specs(mesh, params))
    batch = _batch(prob["tokens"])
    batch = _place(batch, mesh, lm_batch_specs(mesh, batch))
    step = S.make_lm_train_step(cfg, microbatches=mb)
    with mesh:
        state, metrics = step(state, batch)
    return float(metrics["loss"]), _whole(state["params"]), state


def _moe_case(mesh, experts, groups):
    """The MoE model's forward aux, loss and gradients on the mesh."""
    from repro_torch.dist.sharding import (lm_batch_specs, lm_param_specs,
                                           replicated_value)
    from repro_torch.models import transformer as T
    from repro_torch.training import value_and_grad
    cfg = _moe_cfg(experts, groups)
    params = T.init_params(cfg, torch.Generator().manual_seed(experts))
    specs = lm_param_specs(mesh, params)
    params = _place(params, mesh, specs)
    batch = _batch(np.random.default_rng(5).integers(0, 128, BATCH))
    batch = _place(batch, mesh, lm_batch_specs(mesh, batch))
    with mesh:
        with torch.no_grad():
            _, aux = T.forward(cfg, params, batch["tokens"])
        loss, grads = value_and_grad(functools.partial(T.lm_loss, cfg),
                                     params, batch)
    return {"aux": float(replicated_value(aux)), "loss": float(loss),
            "grads": [g.numpy() for g in _whole(grads)],
            "expert_spec": tuple(specs["layers"]["experts"]["up"])}


def _rank_worker(rank, port, out_dir):
    """One gloo rank: every case in turn, rank 0 saving the results."""
    import torch.distributed as dist
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import compressed_psum
    from repro_torch.runtime import elastic_restore
    torch.set_num_threads(1)          # 8 ranks share the host's cores
    out = Path(out_dir)
    with open(out / "problem.pkl", "rb") as f:
        prob = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_device_mesh(MESH, ("data", "model"), device="cpu")
        res = {"spmd": {}, "moe": {}, "elastic": {}}
        # the dots policy's decisions on DTensor products
        saved = []
        policy = T._dots_policy

        def counting(ctx, op, *args, **kwargs):
            from torch.distributed.tensor import DTensor
            decision = policy(ctx, op, *args, **kwargs)
            if op in T._DOTS and any(isinstance(a, DTensor) for a in args):
                saved.append(decision.name)
            return decision
        T._dots_policy = counting
        state = None
        for remat, mb in SPMD_CASES:
            loss, leaves, st = _spmd_step(mesh, prob, remat, mb)
            res["spmd"][(remat, mb)] = (loss, [p.numpy() for p in leaves])
            if state is None:
                state = st
        T._dots_policy = policy
        res["dots_decisions"] = sorted(set(saved)), len(saved)
        # the batch alone split (8, 1): the vocab whole on every rank
        data_only = make_device_mesh((WORLD, 1), ("data", "model"),
                                     device="cpu")
        loss, leaves, _ = _spmd_step(data_only, prob, "none", 1)
        res["spmd_data_only"] = (loss, [p.numpy() for p in leaves])
        for experts, groups in MOE_CASES:
            res["moe"][(experts, groups)] = _moe_case(mesh, experts, groups)
        # elastic: the (2, 4) state after a step, saved, restored elsewhere
        saved_state = [t.numpy() for t in _whole(state)]
        save_checkpoint(str(out / "ckpt"), 1, state)
        if rank == 0:             # the same values saved unsharded
            from repro_torch.checkpoint.manager import (
                _flatten_with_paths, _unflatten_like)
            keys = sorted(_flatten_with_paths(state))
            save_checkpoint(str(out / "ckpt_plain"), 1, _unflatten_like(
                state, {k: torch.from_numpy(v)
                        for k, v in zip(keys, saved_state)}))
        for shape in ELASTIC_MESHES:
            other = make_device_mesh(shape, ("data", "model"), device="cpu")
            target = {"params": prob["params_torch"],
                      "opt": prob["opt_torch"]}
            restored, at = elastic_restore(
                str(out / "ckpt"), target, other,
                _state_specs(other, prob["params_torch"]))
            from repro_torch.optim.adamw import tree_leaves
            sharded = sum(any(not p.is_replicate() for p in t.placements)
                          for t in tree_leaves(restored))
            whole = [t.numpy() for t in _whole(restored)]
            res["elastic"][shape] = (at, sharded, all(
                np.array_equal(a, b) for a, b in zip(whole, saved_state)))
        restored, at = elastic_restore(
            prob["ref_ckpt"], {"params": prob["params_torch"],
                               "opt": prob["opt_torch"]}, mesh,
            _state_specs(mesh, prob["params_torch"]))
        res["ref_ckpt"] = (at, [t.numpy() for t in _whole(restored)])
        # compressed_psum: this rank's rows
        psum = {}
        with mesh:
            for axis in PSUM_AXES:
                mean, resid = compressed_psum(
                    torch.from_numpy(prob["psum_g"][rank]), axis,
                    torch.from_numpy(prob["psum_r"][rank]))
                psum[axis] = (mean.numpy(), resid.numpy())
        with open(out / f"psum{rank}.pkl", "wb") as f:
            pickle.dump(psum, f)
        if rank == 0:
            with open(out / "results.pkl", "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_PSUM_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.optim.grad_compress import compressed_psum
    d = np.load(sys.argv[1])
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    row = P(("data", "model"))
    out = {}
    for axis in ("data", "model"):
        def body(g, r, axis=axis):
            mean, res = compressed_psum(g[0], axis, r[0])
            return mean[None], res[None]
        f = shard_map(body, mesh=mesh, in_specs=(row, row),
                      out_specs=(row, row), check_rep=False)
        mean, res = f(d["g"], d["r"])
        out[axis + "_mean"] = np.asarray(mean)
        out[axis + "_res"] = np.asarray(res)
    np.savez(sys.argv[2], **out)
    print("PSUM_OK")
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank world's results, the reference's side computed here
    meanwhile: its single-device loss of the SPMD case, its checkpoint,
    and its ``compressed_psum`` under ``shard_map`` (a subprocess)."""
    import jax
    import jax.numpy as jnp
    import torch.multiprocessing as mp
    from repro.checkpoint import save_checkpoint as ref_save
    from repro.launch import steps as RS
    from repro.models import transformer as RT
    from repro.optim import adamw_init as ref_adamw_init
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    out = tmp_path_factory.mktemp("spmd")
    rcfg = RT.TransformerConfig(**CFG)
    ref_params = RT.init_params(rcfg, jax.random.key(0))
    tokens = np.asarray(jax.random.randint(jax.random.key(1), BATCH, 0,
                                           CFG["vocab"]))
    params_np = jax.tree.map(np.asarray, ref_params)
    ref_state = {"params": ref_params, "opt": ref_adamw_init(ref_params)}
    ref_save(str(out / "ref_ckpt"), 3, ref_state)
    rng = np.random.default_rng(9)
    g = rng.standard_normal((WORLD, PSUM_N)).astype(np.float32)
    g *= np.float32(10.0) ** rng.integers(-2, 2, (WORLD, 1))
    r = (rng.standard_normal((WORLD, PSUM_N)) * 1e-3).astype(np.float32)
    np.savez(out / "psum_in.npz", g=g, r=r)
    params_torch = T.params_from_reference(params_np)
    prob = {"params": params_np, "tokens": tokens,
            "params_torch": params_torch,
            "opt_torch": adamw_init(params_torch),
            "ref_ckpt": str(out / "ref_ckpt"), "psum_g": g, "psum_r": r}
    with open(out / "problem.pkl", "wb") as f:
        pickle.dump(prob, f)
    ref_psum = subprocess.Popen(
        [sys.executable, "-c", _PSUM_SCRIPT, str(out / "psum_in.npz"),
         str(out / "psum_ref.npz")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    ctx = mp.spawn(_rank_worker, args=(_free_port(), str(out)),
                   nprocs=WORLD, join=False)
    batch = {"tokens": jnp.asarray(tokens),
             "targets": jnp.roll(jnp.asarray(tokens), -1, 1)}
    _, metrics = jax.jit(RS.make_lm_train_step(rcfg))(
        {"params": ref_params, "opt": ref_adamw_init(ref_params)}, batch)
    ref_loss = float(metrics["loss"])
    stdout, stderr = ref_psum.communicate(timeout=300)
    assert "PSUM_OK" in stdout, stderr[-2000:]
    while not ctx.join():
        pass
    with open(out / "results.pkl", "rb") as f:
        res = pickle.load(f)
    psum = []
    for rank in range(WORLD):
        with open(out / f"psum{rank}.pkl", "rb") as f:
            psum.append(pickle.load(f))
    return {"prob": prob, "res": res, "ref_loss": ref_loss, "out": out,
            "ref_state": jax.tree.map(np.asarray, ref_state),
            "psum": psum, "psum_ref": dict(np.load(out / "psum_ref.npz"))}


def _one_process_step(prob, remat, mb):
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cfg = T.TransformerConfig(**CFG, remat=remat)
    params = T.params_from_reference(prob["params"])
    state = {"params": params, "opt": adamw_init(params)}
    state, metrics = S.make_lm_train_step(cfg, microbatches=mb)(
        state, _batch(prob["tokens"]))
    return float(metrics["loss"]), _whole(state["params"])


def _within(got, want, tol):
    """Each leaf of ``got`` within ``tol`` of its ``want`` leaf's largest
    magnitude; the largest share."""
    worst = 0.0
    for a, b in zip(got, want):
        b = np.asarray(b, np.float64)
        err = float(np.abs(np.asarray(a, np.float64) - b).max())
        worst = max(worst, err / max(float(np.abs(b).max()), 1e-30))
    assert worst <= tol, worst
    return worst


@pytest.mark.parametrize("remat,mb", SPMD_CASES)
def test_spmd_train_step_matches_reference_and_one_process(world, remat,
                                                           mb):
    loss, leaves = world["res"]["spmd"][(remat, mb)]
    assert abs(loss - world["ref_loss"]) < REF_LOSS_TOL, (
        loss, world["ref_loss"])
    want_loss, want = _one_process_step(world["prob"], remat, mb)
    assert abs(loss - want_loss) <= TOL * abs(want_loss), (loss, want_loss)
    _within(leaves, [w.numpy() for w in want], TOL)


def test_spmd_train_step_on_a_data_only_mesh(world):
    """(8, 1): every rank's rows with the whole vocab (the loss's other
    branch: each rank's mean, averaged over the shards)."""
    loss, leaves = world["res"]["spmd_data_only"]
    assert abs(loss - world["ref_loss"]) < REF_LOSS_TOL
    want_loss, want = _one_process_step(world["prob"], "none", 1)
    assert abs(loss - want_loss) <= TOL * abs(want_loss), (loss, want_loss)
    _within(leaves, [w.numpy() for w in want], TOL)


def test_dots_policy_keeps_the_dtensor_products(world):
    """``remat="dots"`` on DTensors: the selective-checkpoint policy sees
    the products as DTensor ``mm``/``addmm`` and saves them."""
    decisions, n = world["res"]["dots_decisions"]
    assert n > 0 and decisions == ["MUST_SAVE"], (decisions, n)


@pytest.mark.parametrize("experts,groups", MOE_CASES)
def test_moe_on_the_mesh_matches_one_process(world, experts, groups):
    from repro_torch.models import transformer as T
    from repro_torch.training import value_and_grad
    got = world["res"]["moe"][(experts, groups)]
    # the rule branch taken: experts over "model" iff they divide it
    assert (got["expert_spec"][1] == "model") == (experts % MESH[1] == 0)
    assert (got["expert_spec"][3] == "model") == (experts % MESH[1] != 0)
    cfg = _moe_cfg(experts, groups)
    params = T.init_params(cfg, torch.Generator().manual_seed(experts))
    batch = _batch(np.random.default_rng(5).integers(0, 128, BATCH))
    with torch.no_grad():
        _, aux = T.forward(cfg, params, batch["tokens"])
    loss, grads = value_and_grad(functools.partial(T.lm_loss, cfg), params,
                                 batch)
    assert abs(got["loss"] - float(loss)) <= TOL * abs(float(loss))
    assert abs(got["aux"] - float(aux)) <= TOL * abs(float(aux))
    _within(got["grads"], [g.numpy() for g in _whole(grads)], TOL)


@pytest.mark.parametrize("shape", ELASTIC_MESHES)
def test_elastic_restore_onto_another_mesh_is_bit_equal(world, shape):
    at, sharded, equal = world["res"]["elastic"][shape]
    assert at == 1 and equal
    assert sharded > 0          # the new layout really splits leaves


def test_sharded_checkpoint_files_equal_an_unsharded_save(world):
    """The (2, 4) state's checkpoint (gathered, written by rank 0) holds
    the same files, byte for byte, as a save of its whole values."""
    out = Path(world["out"])
    sharded = sorted((out / "ckpt" / "step_0000000001").glob("leaf_*.npy"))
    plain = sorted((out / "ckpt_plain" / "step_0000000001").glob(
        "leaf_*.npy"))
    assert [p.name for p in sharded] == [p.name for p in plain]
    assert len(sharded) > 10
    for a, b in zip(sharded, plain):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_elastic_restore_of_a_reference_checkpoint(world):
    from repro_torch.checkpoint.manager import _flatten_with_paths
    at, leaves = world["res"]["ref_ckpt"]
    assert at == 3
    ref = _flatten_with_paths(world["ref_state"])
    want = [ref[k] for k in sorted(ref)]
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("axis", PSUM_AXES)
def test_compressed_psum_matches_reference_shard_map(world, axis):
    ref_mean = world["psum_ref"][axis + "_mean"]
    ref_res = world["psum_ref"][axis + "_res"]
    for rank in range(WORLD):
        mean, res = world["psum"][rank][axis]
        for got, want in ((mean, ref_mean[rank]), (res, ref_res[rank])):
            scale = float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= 1e-6 * scale
