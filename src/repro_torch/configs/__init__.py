"""Architecture registry of the port, selectable via ``--arch <id>`` in the
launchers: DIEN, the three dense LMs and the four GNNs.  ``get_arch`` names
the ROADMAP item of the reference's other architectures."""
from .base import ARCHS, ArchSpec, get_arch, register

# importing the modules populates the registry
from . import (dien, egnn, gatedgcn, gin_tu, minitron_8b,  # noqa: F401
               nequip, qwen1_5_110b, starcoder2_3b)
