"""PyTorch/CUDA port of the unified-memory SIMPLE reproduction.

The package mirrors the module tree of the JAX package ``repro`` (the
reference) and never imports it: everything it needs is copied here.
Entry point: ``python -m repro_torch.cfd``.  Tensors live on ``cuda``
unless a caller passes ``device="cpu"``; asking for CUDA where there is
none raises (:func:`repro_torch.core.umem.resolve_device`).
"""
