"""repro_torch — the PyTorch/CUDA port of ``repro`` (2PS-L out-of-core edge
partitioning), for one NVIDIA Hopper card.

It stands alone: nothing here imports jax or the ``repro`` package.  Its
entry points (``repro_torch.core.run_spec`` and
``python -m repro_torch.launch.partition``) run on the card unless the
caller passes ``device="cpu"`` / ``--device cpu``.
"""
