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
                                 or layer-graph parameters; a reference
                                 optimizer runtime's host state
    train/step.py                train / prefill / decode steps, on one
                                 device or sharded on a mesh
    train/pipeline.py            GPipe pipeline over a stage axis
    sharding/                    the reference's rule tables, placements,
                                 and every collective (tallied)
    launch/mesh.py               (data, model) meshes over torch.distributed
    launch/comm_analysis.py      collectives by kind per step
    launch/serve.py              ``generate``: prefill + greedy decode;
                                 ``personalize``: the multi-tenant server
    core/                        the paper's path: LayerGraph ->
                                 compile_plan -> replay -> grads (the
                                 planning modules copied from the
                                 reference; layer math, the activation
                                 store with its CUDA copy-stream engine and
                                 the sim / async backends in torch), and
                                 the offloaded optimizer state
                                 (core/optim_offload.py)
    optim/                       int8 block quantizer, AdamW, momentum SGD
    serve/                       personalization serving: buckets, admission,
                                 per-user sessions, the interleaved scheduler
    runtime/fault.py             fault injection (plain copy)
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
