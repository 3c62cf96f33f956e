"""Elastic re-scaling (moving a training state onto another mesh), the
counterpart of ``repro.runtime.elastic``.  It needs the mesh, which the
port does not have yet: both entries raise (ROADMAP.md Queue 1 item 12,
the mesh and sharding slice).  Checkpoints are already
topology-independent (``checkpoint.manager``)."""
from __future__ import annotations

_WHY = ("elastic re-scaling needs the mesh, which is not ported to "
        "repro_torch yet: see ROADMAP.md Queue 1 item 12 (mesh and "
        "sharding)")


def reshard_tree(tree, mesh, specs):
    """Place a tree onto ``mesh`` with ``specs``: not ported yet."""
    raise NotImplementedError(_WHY)


def elastic_restore(ckpt_dir, target_tree, mesh, specs):
    """Restore the latest checkpoint onto another mesh: not ported yet."""
    raise NotImplementedError(_WHY)
