"""Plain torch versions of the ``spmm`` kernel: the CPU path of ``spmm`` and
``segment_sum_tiles`` (``sorted_sum_ref`` for the bound route), and the
yardstick the CUDA kernel is held to on the card.  Sums are float32
(``index_add_`` into a float32 buffer), cast to the messages' dtype, as
the reference's ``jax.ops.segment_sum`` of float32 messages; the gather
follows JAX's index semantics (``wrap_clamp_index``).
"""
from __future__ import annotations

import torch

from .. import wrap_clamp_index


def segment_sum_ref(messages, dst, num_nodes: int):
    """messages: (E, D); dst: (E,) in [0, num_nodes) -> (num_nodes, D)."""
    out = torch.zeros((num_nodes, messages.shape[1]), dtype=torch.float32,
                      device=messages.device)
    out.index_add_(0, dst.long(), messages.float())
    return out.to(messages.dtype)


def spmm_ref(x, src, dst, weights, num_nodes: int):
    """Y = A @ X with A given as an edge list: Y[dst] += w * X[src]."""
    msg = x[wrap_clamp_index(src, x.shape[0])]
    if weights is not None:
        msg = msg * weights[:, None]
    return segment_sum_ref(msg, dst, num_nodes)


def sorted_sum_ref(rows, idx, weights, row_ptr):
    """The bound route: Y[i] = sum_p w[p] * rows[idx[p]] over p in
    [row_ptr[i], row_ptr[i + 1]), with ``idx`` (in range) and ``weights``
    (or None) already in destination order."""
    n = row_ptr.numel() - 1
    dst = torch.repeat_interleave(torch.arange(n, device=rows.device),
                                  row_ptr[1:] - row_ptr[:-1],
                                  output_size=idx.numel())
    msg = rows[idx.long()]
    if weights is not None:
        msg = msg * weights[:, None]
    return segment_sum_ref(msg, dst, n)
