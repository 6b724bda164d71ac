"""Hand-written Hopper kernels replacing the reference's Pallas TPU kernels.

Each kernel package has ``csrc/`` (the CUDA C++ source), ``kernel.py``
(build, launch and launch count, plus the plain PyTorch twin the wrapper
runs for CPU tensors), ``ops.py`` (the public wrapper) and ``ref.py``
(the plain oracle the tests compare against).
"""
