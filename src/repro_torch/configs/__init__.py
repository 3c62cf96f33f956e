"""Architecture registry of the port, selectable via ``--arch <id>`` in the
launchers: DIEN and the three dense LMs.  ``get_arch`` names the ROADMAP
item of the reference's other architectures."""
from .base import ARCHS, ArchSpec, get_arch, register

# importing the modules populates the registry
from . import dien, minitron_8b, qwen1_5_110b, starcoder2_3b  # noqa: F401
