"""Hand-written Hopper kernels of the port, one subpackage per TPU kernel
of the reference package.

Each subpackage follows the contract:
  csrc/*.cu — the CUDA C++ kernel (sm_90a) with a plain C entry point
  kernel.py — ctypes binding; built by ``cuda_build`` at first launch
  ops.py    — public wrapper: CUDA tensor -> kernel (or raise), CPU tensor
              -> the plain version; counts its launches
  ref.py    — plain torch version, the yardstick on the card

Kernels:
  edge_score — 2PS-L two-candidate scoring (the paper's O(|E|) hot loop;
               2PS-L step 3's whole choice per chunk)
  hdrf_score — HDRF / Greedy k-way scoring and first-index argmax (2PS-HDRF
               step 3, and the HDRF and Greedy baselines' micro-batches)
  augru      — DIEN's attention-gated GRU scan, all T states out (the GRU
               stage at att == 1 and the interest evolution)
  flash_attention — causal / non-causal GQA attention with an online
               softmax (the LM prefill forward, one launch per layer)
  spmm       — destination-sorted segment sum, ``Y[dst] += w * R[g]``, with
               the gather ``x[src]`` fused (a GNN layer's neighbour sum:
               ``spmm`` and ``segment_sum_tiles``)
  embedding_bag — weighted sum / mean of the rows of a bag of table
               lookups, the gather fused (recsys history pooling)
"""
import torch


class LaunchCounter:
    """Number of kernel launches, incremented by a wrapper right where it
    launches and nowhere else; ``reset`` before a run, read after it."""

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0


class EntryCounter(LaunchCounter):
    """Launches in all (``count``) and by entry (``by_entry``) of a kernel
    with two entries: ``bits`` reads the packed replica bit matrix itself
    (the chunk functions' entry), ``flags`` takes gathered flags (the
    reference's op)."""

    ENTRIES = ("bits", "flags")

    def __init__(self):
        super().__init__()
        self.by_entry = dict.fromkeys(self.ENTRIES, 0)

    def reset(self) -> None:
        super().reset()
        self.by_entry = dict.fromkeys(self.ENTRIES, 0)

    def add(self, entry: str) -> None:
        self.count += 1
        self.by_entry[entry] += 1


def wrap_clamp_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather semantics for ``x[idx]`` on ``n`` rows, as int64: a
    negative index wraps once (``i + n``), then every index is clamped to
    [0, n - 1].  Torch indexing raises on both instead; the CUDA kernels
    apply the same rule."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp_(0, max(n - 1, 0))
