"""Elastic re-scaling: move a training state onto another mesh, the
counterpart of ``repro.runtime.elastic``.

Checkpoints are topology-independent (whole arrays and a manifest:
``checkpoint.manager``), so scaling from k to k' ranks is: restore, build
the new ``DeviceMesh`` and its specs (``dist.sharding``'s rules re-derive
a valid layout for the new axis sizes), then place each leaf with
``distribute_tensor``.
"""
from __future__ import annotations

from ..dist import sharding as SH


def reshard_tree(tree, mesh, specs):
    """Place a tree of host arrays, tensors or DTensors (of any mesh) onto
    ``mesh`` with ``specs`` (a spec tree of the same structure): each leaf
    a DTensor of ``SH.placements(mesh, spec)``, every rank keeping its
    shard."""
    if isinstance(tree, dict):
        return {k: reshard_tree(v, mesh, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [reshard_tree(v, mesh, s) for v, s in zip(tree, specs)]
    return SH.distribute(SH.replicated_value(tree), mesh, specs)


def elastic_restore(ckpt_dir, target_tree, mesh, specs):
    """Restore the latest checkpoint directly onto a (possibly different)
    mesh: ``(tree, step)``, or ``(None, None)`` when there is none."""
    from ..checkpoint import restore_checkpoint
    restored, step = restore_checkpoint(ckpt_dir, target_tree)
    if restored is None:
        return None, None
    return reshard_tree(restored, mesh, specs), step
