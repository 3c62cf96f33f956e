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
"""
