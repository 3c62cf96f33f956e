"""Models of the port: the counterparts of ``repro.models`` (DIEN and the
dense LM so far)."""
