"""Architecture registry of the port, selectable via ``--arch <id>`` in the
launchers: all ten of the reference's architectures (DIEN, the three dense
LMs, the two MoE LMs and the four GNNs).  ``get_arch`` raises ``KeyError``
for an unknown id."""
from .base import ARCHS, ArchSpec, get_arch, register

# importing the modules populates the registry
from . import (dien, egnn, gatedgcn, gin_tu, minitron_8b,  # noqa: F401
               nequip, olmoe_1b_7b, qwen1_5_110b, qwen2_moe_a2_7b,
               starcoder2_3b)
