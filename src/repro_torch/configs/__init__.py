"""Architecture registry of the port, selectable via ``--arch <id>`` in the
launchers.  Only DIEN is ported; ``get_arch`` names the ROADMAP item of the
reference's other architectures."""
from .base import ARCHS, ArchSpec, get_arch, register

# importing the modules populates the registry
from . import dien  # noqa: F401
