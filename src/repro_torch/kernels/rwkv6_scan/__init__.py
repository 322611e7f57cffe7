"""RWKV6 time-mix scan K5: CUDA C++ (``kernel.py``) and plain versions (``ref.py``)."""
