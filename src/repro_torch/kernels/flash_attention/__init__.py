"""Flash attention: sm_90a CUDA kernel (``kernel.py``), its (B, S, H, D)
wrapper (``ops.py``) and the plain oracle (``ref.py``)."""
