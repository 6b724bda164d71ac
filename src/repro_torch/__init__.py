"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package under ``src/repro`` is the reference; this package imports
``torch`` and never ``jax`` or anything of ``repro``.  Module names mirror
the reference.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
twin.

Ported so far (serving of the dense LM, llama3.2-3b family, of the MoE
LM, granite-moe-1b-a400m, of the hybrid, zamba2-7b, and of the xLSTM,
xlstm-1.3b):

    configs/                     architecture dataclasses (plain copy)
    models/layers.py             rmsnorm, dense, embed, rope, swiglu, log_sigmoid
    models/attention.py          naive / blockwise / flash dispatch, KV cache
    models/transformer.py        decoder LM (dense or MoE): forward, prefill,
                                 decode; the xLSTM stack (XLSTMLM)
    models/moe.py                MoE FFN: top-k routing with capacity,
                                 einsum and gather dispatch
    models/ssm.py                mamba2 layer: chunked prefill, decode step
    models/zamba.py              hybrid LM: mamba2 + one shared attention block
    models/xlstm.py              mLSTM (chunked prefill) and sLSTM blocks
    models/model.py              Model / build_model / reduce_config
    kernels/_build.py            nvcc build into build/torch_ext/, ctypes load
    kernels/flash_attention/     hand-written sm_90a CUDA forward kernel
    kernels/ssm_scan/            hand-written sm_90a CUDA SSD chunk kernel
    kernels/mlstm_scan/          hand-written sm_90a CUDA mLSTM chunk kernel
    kernels/fused_swiglu/        hand-written sm_90a CUDA fused SwiGLU
                                 gate/up GEMM (dense MLPs and MoE experts)
    convert.py                   reference param tree (numpy) -> port modules
                                 or layer-graph parameters
    train/step.py                prefill / decode step callables
    launch/serve.py              ``generate``: prefill + greedy decode
    core/                        the paper's path: LayerGraph ->
                                 compile_plan -> replay -> grads (the
                                 planning modules copied from the
                                 reference; layer math, the activation
                                 store with its CUDA copy-stream engine and
                                 the sim / async backends in torch)
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
