"""The port's sharding rules (``repro_torch.dist.sharding``) against the
reference's (``repro.dist.sharding``), on the reference's stand-in meshes:
every spec tree of the five LM architectures (parameters and AdamW state,
the port's from ``init_params_abstract``, the reference's from
``jax.eval_shape``), the KV cache, DIEN's parameters and the three batch
rules, leaf for leaf as tuples; the shape-only initialisers against the
reference's shapes and dtypes at full size and the port's real init at
smoke size; the specs as DTensor placements; ``constrain`` off a mesh."""
import functools
import socket
from contextlib import contextmanager

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro.configs import get_arch as ref_arch
from repro.dist import sharding as RSH
from repro.launch import steps as RS
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import transformer as RT
from repro_torch.configs import get_arch
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import P
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T

LM_ARCHS = ["qwen1.5-110b", "starcoder2-3b", "minitron-8b",
            "qwen2-moe-a2.7b", "olmoe-1b-7b"]
GNN_ARCHS = ["gin-tu", "gatedgcn", "egnn", "nequip"]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "3x5": ((3, 5), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(name):
    """The reference tests' stand-in: a class with ``axis_names`` and a
    numpy ``devices`` of the mesh's shape."""
    shape, axes = MESHES[name]
    return type(f"Mesh{name}", (), {"axis_names": axes,
                                   "devices": np.empty(shape, object)})


def _ref_flat(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, RP))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _port_flat(specs, prefix=()) -> dict:
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_port_flat(v, prefix + (str(k),)))
        return out
    if isinstance(specs, (list, tuple)) and not SH.is_spec(specs):
        out = {}
        for i, v in enumerate(specs):
            out.update(_port_flat(v, prefix + (str(i),)))
        return out
    assert SH.is_spec(specs), specs
    return {"/".join(prefix): tuple(specs)}


def _assert_same_specs(port, ref):
    got, want = _port_flat(port), _ref_flat(ref)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return RT.init_params_abstract(ref_arch(arch).make_config())


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return T.init_params_abstract(get_arch(arch).make_config())


# ---------------------------------------------------------------------------
# tests/test_sharding_rules.py:16-47, on the port
# ---------------------------------------------------------------------------

def test_best_spec_divisibility():
    ref = RSH.best_spec(ref_host_mesh((1, 1), ("data", "model")), (60, 64),
                        [(0, "model"), (1, "data")])
    got = SH.best_spec(make_host_mesh((1, 1), ("data", "model"),
                                      device="cpu"), (60, 64),
                       [(0, "model"), (1, "data")])
    assert got == P("model", "data") and tuple(got) == tuple(ref)


def test_best_spec_skips_nondivisible():
    prefs = [(0, "model"), (1, "model"), (2, "data")]
    got = SH.best_spec(_mesh("16x16"), (60, 1408, 2048), prefs)
    assert got == P(None, "model", "data")
    assert tuple(got) == tuple(RSH.best_spec(_mesh("16x16"),
                                             (60, 1408, 2048), prefs))


def test_best_spec_no_axis_reuse():
    got = SH.best_spec(_mesh("16x16"), (64, 32), [(0, "model"), (1, "model")])
    assert got == P("model", None)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fsdp_axes(mesh):
    assert SH.fsdp_axes(_mesh(mesh)) == RSH.fsdp_axes(_mesh(mesh))


def test_axis_sizes_of_every_mesh_kind():
    """Stand-ins, the port's ``HostMesh`` and a ``DeviceMesh``'s
    ``mesh_dim_names`` + ``shape`` all give the same sizes."""
    class DeviceMeshLike:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)
    want = {"pod": 2, "data": 16, "model": 16}
    assert SH._axis_sizes(_mesh("2x16x16")) == want
    assert SH._axis_sizes(DeviceMeshLike()) == want
    assert SH._axis_sizes(make_host_mesh((2, 16, 16), ("pod", "data",
                                                       "model"),
                                         device="cpu")) == want
    assert SH.fsdp_axes(DeviceMeshLike()) == ("pod", "data")


# ---------------------------------------------------------------------------
# LM parameter and AdamW state specs, every architecture x mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_and_opt_specs_match_reference(arch, mesh):
    m = _mesh(mesh)
    ref = RSH.lm_param_specs(m, _ref_params(arch))
    got = SH.lm_param_specs(m, _port_params(arch))
    _assert_same_specs(got, ref)
    _assert_same_specs(SH.opt_state_specs(got), RSH.opt_state_specs(ref))


def test_lm_param_specs_structure():
    """tests/test_sharding_rules.py:51-74 on the port."""
    specs = SH.lm_param_specs(_mesh("16x16"), _port_params("qwen1.5-110b"))
    assert specs["embed"]["table"] == P("model", ("data",))
    assert specs["lm_head"]["w"] == P(("data",), "model")
    assert specs["layers"]["wq"]["w"] == P(None, ("data",), "model")
    assert specs["layers"]["wo"]["w"] == P(None, "model", ("data",))
    assert specs["layers"]["ln1"]["scale"] == P()


def test_moe_expert_specs_divisibility():
    """tests/test_sharding_rules.py:77-99 on the port: olmoe's 64 experts
    go expert parallel on model = 16, qwen2-moe's 60 fall back to the ff
    dim."""
    m = _mesh("16x16")
    specs = SH.lm_param_specs(m, _port_params("olmoe-1b-7b"))
    assert specs["layers"]["experts"]["up"][1] == "model"
    specs = SH.lm_param_specs(m, _port_params("qwen2-moe-a2.7b"))
    assert specs["layers"]["experts"]["up"][1] is None
    assert "model" in specs["layers"]["experts"]["up"]


# ---------------------------------------------------------------------------
# cache, DIEN and batch specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_cache_specs_match_reference(arch, mesh):
    m = _mesh(mesh)
    for batch, length in ((128, 32_768), (1, 4096), (3, 17)):
        ref = RSH.lm_cache_specs(m, RT.cache_abstract(
            ref_arch(arch).make_config(), batch, length))
        got = SH.lm_cache_specs(m, T.cache_abstract(
            get_arch(arch).make_config(), batch, length))
        _assert_same_specs(got, ref)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_recsys_param_specs_match_reference(mesh):
    m = _mesh(mesh)
    for kind in ("serve", "train"):
        ref = RS.init_state_abstract("recsys", ref_arch("dien").make_config(),
                                     kind)
        got = S.init_state_abstract("recsys", get_arch("dien").make_config(),
                                    kind)
        if kind == "train":
            ref, got = ref["params"], got["params"]
        _assert_same_specs(SH.recsys_param_specs(m, got),
                           RSH.recsys_param_specs(m, ref))


def _meta(tree):
    """A tree of the reference's shape structs (or arrays) as meta
    tensors."""
    return jax.tree.map(
        lambda s: torch.empty(tuple(s.shape), device="meta"), tree)


_BATCH_RULES = {"lm": (SH.lm_batch_specs, RSH.lm_batch_specs),
                "gnn": (SH.gnn_batch_specs, RSH.gnn_batch_specs),
                "recsys": (SH.recsys_batch_specs, RSH.recsys_batch_specs)}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_match_reference(mesh):
    """The three batch rules over every registered shape's inputs (the
    reference's ``input_specs``): LM tokens, GNN batches, DIEN batches."""
    m = _mesh(mesh)
    n = 0
    for arch in LM_ARCHS + GNN_ARCHS + ["dien"]:
        spec = ref_arch(arch)
        port_rule, ref_rule = _BATCH_RULES[spec.family]
        for shape in spec.shapes:
            inputs = spec.input_specs(shape, spec.config_for_shape(shape))
            if spec.family == "gnn":
                inputs = inputs["batch"]
            elif "cache" in inputs:
                _assert_same_specs(
                    SH.lm_cache_specs(m, _meta(inputs["cache"])),
                    RSH.lm_cache_specs(m, inputs["cache"]))
                inputs = {"tokens": inputs["tokens"]}
            _assert_same_specs(port_rule(m, _meta(inputs)),
                               ref_rule(m, inputs))
            n += 1
    assert n >= 20


# ---------------------------------------------------------------------------
# shape-only initialisers
# ---------------------------------------------------------------------------

def _shapes(tree, ref: bool) -> dict:
    flat = (jax.tree_util.tree_flatten_with_path(tree)[0] if ref else
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0])
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path):
            (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
            for path, leaf in flat}


@pytest.mark.parametrize("arch", LM_ARCHS + GNN_ARCHS + ["dien"])
def test_init_state_abstract_matches_reference_at_full_size(arch):
    spec = get_arch(arch)
    got = S.init_state_abstract(spec.family, spec.make_config(), "train")
    want = RS.init_state_abstract(spec.family, ref_arch(arch).make_config(),
                                  "train")
    assert all(t.device.type == "meta" for t in
               jax.tree.leaves(got, is_leaf=lambda x: isinstance(
                   x, torch.Tensor)))
    assert _shapes(got, False) == _shapes(want, True)
    if spec.family == "lm":
        assert _shapes(T.init_params_abstract(spec.make_config()), False) \
            == _shapes(RT.init_params_abstract(ref_arch(arch).make_config()),
                       True)


@pytest.mark.parametrize("arch", LM_ARCHS + GNN_ARCHS + ["dien"])
def test_init_state_abstract_matches_real_init_at_smoke_size(arch):
    spec = get_arch(arch)
    cfg = spec.make_smoke_config()
    real = S.init_state(spec.family, cfg, torch.Generator().manual_seed(0))
    for kind in ("train", "serve"):
        got = S.init_state_abstract(spec.family, cfg, kind)
        want = real if kind == "train" else real["params"]
        assert _shapes(got, False) == _shapes(want, False)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_abstract_matches_init_cache(arch):
    cfg = get_arch(arch).make_smoke_config()
    got = T.cache_abstract(cfg, 3, 40)
    assert _shapes(got, False) == _shapes(T.init_cache(cfg, 3, 40), False)
    assert all(t.device.type == "meta" for t in got.values())


# ---------------------------------------------------------------------------
# placements and constrain
# ---------------------------------------------------------------------------

def test_placements_of_single_tuple_and_replicated_entries():
    from torch.distributed.tensor import Replicate, Shard
    pod = type("Pod", (), {"axis_names": ("pod", "data", "model"),
                           "devices": np.empty((2, 2, 4), object)})
    assert SH.placements(pod, P(("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert SH.placements(pod, P(None, ("data",))) == (
        Replicate(), Shard(1), Replicate())
    assert SH.placements(pod, P("model", None, "pod")) == (
        Shard(2), Replicate(), Shard(0))
    assert SH.placements(pod, P()) == (Replicate(),) * 3
    # a mesh dim of one rank holds the whole tensor
    one = type("One", (), {"axis_names": ("data", "model"),
                           "devices": np.empty((1, 4), object)})
    assert SH.placements(one, P(("data",), "model")) == (
        Replicate(), Shard(1))
    with pytest.raises(ValueError, match="used twice"):
        SH.placements(pod, P("model", "model"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextmanager
def _one_rank():
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_constrain_is_the_identity_off_a_mesh():
    x = torch.randn(4, 6)
    assert SH.constrain(x, (0, "fsdp"), (1, "model")) is x
    from repro_torch.launch.mesh import make_device_mesh
    with _one_rank():
        mesh = make_device_mesh((1, 1), device="cpu")
        d = SH.distribute(x, mesh, P(("data",), "model"))
        assert SH.constrain(d, (0, "fsdp")) is d      # no ambient mesh
        with mesh:
            assert SH.constrain(x, (0, "fsdp")) is x  # not a DTensor
            # axes of one rank are skipped, as the reference skips them
            assert SH.constrain(d, (0, "fsdp"), (1, "model")) is d
        torch.testing.assert_close(d.full_tensor(), x, rtol=0, atol=0)


def test_make_production_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="need"):
            make_production_mesh(multi_pod=multi_pod)
