"""Fused field macros K4: Triton (``kernel.py``) and plain versions (``ref.py``)."""
