"""Hand-written Hopper kernels of the port, one subpackage per TPU kernel
of the reference package.

Each subpackage follows the contract:
  csrc/*.cu — the CUDA C++ kernel (sm_90a) with a plain C entry point
  kernel.py — ctypes binding; built by ``cuda_build`` at first launch
  ops.py    — public wrapper: CUDA tensor -> kernel (or raise), CPU tensor
              -> the plain version; counts its launches
  ref.py    — plain torch version, the yardstick on the card

Kernels:
  edge_score — 2PS-L two-candidate scoring (the paper's O(|E|) hot loop)
  hdrf_score — HDRF / Greedy k-way scoring and first-index argmax (2PS-HDRF
               step 3, and the HDRF and Greedy baselines' micro-batches)
  augru      — DIEN's attention-gated GRU scan, all T states out (the GRU
               stage at att == 1 and the interest evolution)
  flash_attention — causal / non-causal GQA attention with an online
               softmax (the LM prefill forward, one launch per layer)
"""


class LaunchCounter:
    """Number of kernel launches, incremented by a wrapper right where it
    launches and nowhere else; ``reset`` before a run, read after it."""

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0
