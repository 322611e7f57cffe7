"""DIA stencil kernels K1-K3: CUDA C++ (``kernel.py``) and plain versions (``ref.py``)."""
