"""The LM's attention on a ``DeviceMesh`` whose ``"model"`` axis the heads
do not divide (``models.transformer._head_units``): each model rank
computes its run of its data shard's (row, head) units and the outputs are
gathered back over the axis.  On 8 gloo ranks, a (2, 4) ``("data",
"model")`` mesh, 6 and 2 heads over 4 model ranks: units part of one row
(GQA groups of 3, 2 and 1 query heads) or whole rows, in the loss's
forward and backward and in a decode step on a random cache.  The loss
within 1e-5 of one process's, every gradient leaf, the logits and the
cache within 1e-5 of their largest magnitude.

One module-scoped world (``torch.multiprocessing.spawn``) runs every
case; rank 0's results come back in a file.
"""
import contextlib
import functools
import pickle
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 8
MESH = (2, 4)
#: (heads, kv heads, batch, qk norm): each data rank's (row, head) units
#: split over the model axis as part of one row (the first two and the
#: last) or as whole rows (the third)
CASES = [(6, 2, 4, False), (6, 3, 4, True), (6, 2, 8, False),
         (2, 1, 4, True)]
SEQ, POS = 16, 9
TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _whole(tree):
    from repro_torch.dist.sharding import replicated_value
    from repro_torch.optim.adamw import tree_leaves
    return [replicated_value(t).detach().clone() for t in tree_leaves(tree)]


def _place(tree, mesh, specs):
    from repro_torch.runtime import reshard_tree
    return reshard_tree(tree, mesh, specs)


def _case(mesh, case):
    """A case's loss, gradients, decode logits and cache after the step,
    on ``mesh`` (None: one process), and on a mesh this rank's units."""
    from repro_torch.dist import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.training import value_and_grad
    H, Hkv, B, qk_norm = case
    cfg = T.TransformerConfig(name="units", n_layers=2, d_model=48,
                              n_heads=H, n_kv_heads=Hkv, d_ff=64, vocab=64,
                              qk_norm=qk_norm)
    params = T.init_params(cfg, torch.Generator().manual_seed(H * 10 + Hkv))
    tokens = torch.from_numpy(np.random.default_rng(B).integers(
        0, cfg.vocab, (B, SEQ)))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    cache = T.init_cache(cfg, B, SEQ)
    gen = torch.Generator().manual_seed(3)
    for c in cache.values():
        c.normal_(generator=gen)
    step = {"tokens": torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (B, 1)))}
    units = None
    if mesh is not None:
        params = _place(params, mesh, SH.lm_param_specs(mesh, params))
        batch = _place(batch, mesh, SH.lm_batch_specs(mesh, batch))
        cache = _place(cache, mesh, SH.lm_cache_specs(mesh, cache))
        step = _place(step, mesh, SH.lm_batch_specs(mesh, step))
        batch_axes = SH.fsdp_entry(mesh, B) or ()
        units = T._head_units(mesh, B // int(np.prod(
            [SH.axis_size(mesh, a) for a in batch_axes])), H)
    with mesh if mesh is not None else contextlib.nullcontext():
        loss, grads = value_and_grad(functools.partial(T.lm_loss, cfg),
                                     params, batch)
        with torch.no_grad():
            logits, cache = T.decode_step(cfg, params, cache,
                                          step["tokens"], POS)
    return {"loss": float(loss), "units": units,
            "grads": [g.numpy() for g in _whole(grads)],
            "logits": SH.replicated_value(logits).numpy(),
            "cache": [t.numpy() for t in _whole(cache)]}


def _rank_worker(rank, port, out_dir):
    """One gloo rank: every case, rank 0 saving the results."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    torch.set_num_threads(1)          # 8 ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_device_mesh(MESH, ("data", "model"), device="cpu")
        res = {case: _case(mesh, case) for case in CASES}
        if rank == 0:
            with open(Path(out_dir) / "results.pkl", "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import torch.multiprocessing as mp
    out = tmp_path_factory.mktemp("units")
    mp.spawn(_rank_worker, args=(_free_port(), str(out)), nprocs=WORLD)
    with open(out / "results.pkl", "rb") as f:
        return pickle.load(f)


def _within(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale


@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_head_units_on_the_mesh_match_one_process(world, case):
    """Each model rank computes its run of the (row, head) units, and the
    loss, gradients, decode logits and cache equal one process's."""
    H, _, B, _ = case
    got = world[case]
    n = B // MESH[0] * H // MESH[1]            # units a model rank holds
    assert got["units"] is not None and got["units"][1] * got["units"][3] \
        == n, got["units"]
    want = _case(None, case)
    assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
    _within(got["grads"], want["grads"], TOL)
    _within([got["logits"]], [want["logits"]], TOL)
    _within(got["cache"], want["cache"], TOL)


def test_a_dividing_axis_takes_no_unit_split():
    """Heads that divide ``"model"``, or a one-rank axis, keep the head
    split (``_head_units`` is None), as do units that do not divide it
    and a rank's run that neither holds whole rows nor divides a row."""
    from repro_torch.models import transformer as T

    class Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, model):
            self.shape = (2, model)

        def get_coordinate(self):
            return [0, 0]
    for model, Bl, H in ((4, 2, 8), (1, 2, 6), (4, 1, 6), (8, 6, 12)):
        assert T._head_units(Mesh(model), Bl, H) is None, (model, Bl, H)
