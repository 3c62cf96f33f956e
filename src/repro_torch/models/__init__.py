"""Models of the port: the counterparts of ``repro.models`` (DIEN so far)."""
