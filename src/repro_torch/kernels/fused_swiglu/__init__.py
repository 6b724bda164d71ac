"""Fused SwiGLU gate/up GEMM: sm_90a CUDA kernel (``kernel.py``), its
model-facing wrapper (``ops.py``) and the plain oracle (``ref.py``)."""
