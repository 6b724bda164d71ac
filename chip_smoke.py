#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) through its main paths and checks
them:

1. device and build: the card's name and power limit, then the eight
   sm_90a sources built at once from the checkout (flash attention's
   ``csrc/flash_fwd_wgmma.cu`` and ``csrc/flash_fwd.cu``, the SSD chunk's
   ``csrc/ssd_chunk_wgmma.cu`` and ``csrc/ssd_chunk.cu``, the mLSTM
   chunk's ``csrc/mlstm_chunk_wgmma.cu`` and ``csrc/mlstm_chunk.cu``, and
   fused SwiGLU's ``csrc/fused_swiglu_wgmma.cu`` and
   ``csrc/fused_swiglu.cu``, one nvcc each; the four wgmma kernels include
   ``kernels/csrc/hopper.cuh``), with ptxas' reports;
2. kernels: each kernel against its plain PyTorch twin, in every variant
   its wrapper can choose (flash: wgmma for bf16, simt for fp32 and, forced,
   for bf16; SwiGLU: wgmma for bf16 rows TMA can describe, mma_sync for the
   others and, forced, for those too, simt for fp32; SSD and mLSTM: wgmma
   (3xTF32) for the shapes it takes and, forced, simt beside it, simt
   alone for the others), and the wrapper's choice checked.  Flash: the six
   ``FLASH_CASES`` x {f32, bf16}, D = 112 cases, and the full-width
   llama3.2-3b (D = 128) and zamba2-7b (D = 112) layer shapes, ragged and
   full.  SSD: the four ``SSD_CASES`` of tests/test_kernels.py, zamba2-7b's
   mamba layer at B = 2, S = 4096 and at a ragged S = 4000, all three
   outputs.  mLSTM: the four ``MLSTM_CASES`` of tests/test_kernels.py,
   xlstm-1.3b's mLSTM layer at B = 2, S = 4096 and at a ragged S = 4000,
   all seven outputs.  Fused SwiGLU: the four ``SWIGLU_CASES`` of
   tests/test_kernels.py, llama3.2-3b's and zamba2-7b's MLPs and
   granite-moe-1b-a400m's experts at their prefill steps' shapes, a ragged
   batch, a decode step's and the pretrain example's MLP, in f32 and bf16.
   Then the times of each kernel, its twin and a library yardstick where
   there is one (``scaled_dot_product_attention`` for flash, one cuBLAS
   product with [Wg | Wu] for SwiGLU; the port never calls either; no
   single PyTorch call computes the SSD or the mLSTM chunk), beside the
   bound (for SSD and mLSTM at the tf32 tensor-core peak); the earlier
   design (flash simt, SwiGLU mma_sync, SSD and mLSTM simt) forced and
   timed in turns with the new one; SwiGLU also at two decode shapes;
3. llama3.2-3b prefill step: full width (28 layers, random weights from a
   seeded generator), B = 2, S = 4096, bf16, ``attention_impl="pallas"``,
   with 28 flash and 28 SwiGLU launches counted, all wgmma; then the
   kernel path
   against the plain (naive) attention path with the same weights in fp32
   at full width;
4. llama3.2-3b generate: 4 requests of 512 prompt tokens + 16 greedy
   tokens through ``repro_torch.launch.serve.generate``, and the batched
   prefill == sequential decode fill invariant on a short prompt;
5. zamba2-7b prefill step: full width and depth (81 mamba layers, the
   shared attention block applied 13 times), B = 2, S = 4096, bf16,
   ``attention_impl="pallas"``, with 81 SSD, 13 flash and 13 SwiGLU
   launches counted, all wgmma;
6. zamba2-7b generate: 4 requests of 128 prompt tokens + 16 greedy tokens,
   the state filled token by token (the family has no batched prefill);
7. zamba2-7b fp32 parity: at full width and a depth of 7 (one group of 6
   and one tail layer), the kernel path on the card against the plain path
   (the same weights on the CPU, where every wrapper runs its twin);
8. xlstm-1.3b prefill step: full width and depth (6 groups of 7 mLSTM
   blocks and 1 sLSTM block), B = 2, S = 4096, bf16, with the 42 mLSTM
   kernel launches counted, all wgmma;
9. xlstm-1.3b generate: 4 requests of 128 prompt tokens + 16 greedy
   tokens, the state filled token by token (the family has no batched
   prefill, so the kernel is not launched);
10. xlstm-1.3b fp32 parity: at full width and a depth of 8 (7 mLSTM blocks
   and 1 sLSTM block), S = 640 (three chunks, the last ragged), the kernel
   path on the card against the plain path on the CPU;
11. granite-moe-1b-a400m prefill step: full width and depth (24 layers,
   32 experts top-8), B = 2, S = 4096, bf16, with 24 flash and 24 SwiGLU
   launches counted (every expert of a layer in one launch);
12. granite-moe-1b-a400m generate: 4 requests of 512 prompt tokens + 16
   greedy tokens through the batched prefill, with the SwiGLU launches
   counted (24 in the prefill and in each decode step);
13. granite-moe-1b-a400m fp32 parity: at full width and a depth of 4, S =
   640, the kernel path on the card against the plain path on the CPU,
   the routing (each layer's top-k mask) compared exactly;
14. bf16 parity: llama3.2-3b (depth 2), zamba2-7b (7), granite-moe-1b-a400m
   (4) and xlstm-1.3b (8) at full width, S = 640, the card path (every
   kernel launch wgmma) against the plain path on the CPU, normwise within
   2e-2; granite-moe's CPU path replays the card's expert choices and the
   choices it would have flipped are counted; xlstm-1.3b is held per
   mLSTM block (its depth-8 logits move by ~0.1 between two correct fp32
   mLSTM implementations) and its logits are reported;
15. paper_zoo, the paper's own path (``repro_torch.core``: LayerGraph ->
   compile_plan -> replay -> grads): all 16 ``ZOO`` graphs at the zoo's own
   widths (150528-wide inputs, 3x224x224 images), batch 64, planned with
   the swap-forcing ``MemoryPlanConfig(min_idle_phases=3, min_bytes=4096)``
   and replayed on ``sim`` and on ``async`` (the CUDA copy stream into one
   pinned host pool); each replay is held to the compiled op list, to no
   late swap-in, to its planned peak and DMA bytes, to the other backend's
   transfer accounting, and to ``reference_loss_and_grads`` (autograd) on
   the card, elementwise (rtol 1e-4, atol 1e-5 per unit of the tensor's
   largest entry) and normwise (1e-4); each row also gives how far the
   port's and autograd's fp32 grads lie from an fp64 autograd run.  Then
   on ``jit_blocks`` (each proven block one CUDA-graph replay over the
   plan's packed device arena), cuDNN deterministic: step 1 captures
   every block, step 2 captures none and equals step 1 bit for bit, a
   third step after SGD in place replays over the new values; each held
   to autograd under the same cuDNN algorithms, the replay to the op
   list's ops in an order the dependence prover signed (exactly the
   fusion plan's stream, in fewer dispatches than ops), its transfer
   accounting to async's.  resnet18_transfer's async and jit_blocks steps
   are timed in turns;
16. paper_trunk: the llama3.2-3b MLP trunk (``transformer_mlp_stack()``: 28
   x (3072 -> 8192 relu -> 3072), MSE head) at batch 4096 rows in fp32,
   planned with the default config (swaps) and with ``swap=False``: three
   SGD steps on ``async`` over the swapped plan (its host pool pinned
   first, timed apart), one on ``sim`` and one on the no-swap plan (after
   a warm-up step); step-1 grads against autograd elementwise and
   normwise, and the allocator's measured peak during each replay
   (parameters and inputs subtracted), which must fall by at least half
   the planned saving against the no-swap replay.  The same on
   ``jit_blocks``, both plans, three steps each with SGD in place (steps 2
   and 3 replay; their losses follow async's), the device memory counted
   by ``memory_reserved`` from before the backend's first run (the arena,
   the gradient buffers and the graphs' pool).  Then five rounds of one
   swapped and one no-swap step in turns (ABBA), whose median step times
   are the phase's comparison of the two plans, and five of async and
   jit_blocks on the swapped plan.
17. paper_optim: the same trunk fine-tuned with AdamW three ways from
   the same params and the same grads (the async replay of
   ``MemoryPlanConfig(optim_offload=True)`` at each step, its 56
   ``OptPrefetch``/``OptSwapOut`` pairs counted and fenced): resident
   moments on the card (``optim.adamw``), offloaded with int8 host copies
   and error feedback, and offloaded with fp32 host copies
   (``core.optim_offload``: H2D on a copy stream, the math on the card,
   D2H into pinned memory, re-quantized on the host).  Gates: step 1
   compressed equal to resident within 1e-6, three steps uncompressed
   within 1e-5 and compressed within 2e-2, the step-1 grads against
   autograd, and the allocator peak of optimizer state (parameters
   subtracted) falling by at least half the planned saving.  At lr 1e-5
   the fp32 offload also runs on ``jit_blocks``, held to the same
   counters and to 1e-5 from the resident AdamW.  Each step
   reports the update's split (H2D, card math, D2H, host re-quantize) and
   the host's resident memory; the normwise drift is reported, not gated;
18. personalize: the multi-tenant service (``serve``) on the card, the
   interleaved drain through one shared copy-stream engine: (a)
   resnet18_transfer, 8 users over buckets (8, 16), 2 steps each, the
   swap-forcing config, then a third wave in which one session is killed
   at a phase boundary; (b) resnet18 fully trainable, 4 users over
   buckets (64, 128), 2 steps, optimizer state offloaded.  Gates: every
   request served, each step's grads against autograd over the session's
   merged params (elementwise and normwise), every peak within its share,
   no verify error, the plan cache's hits and misses, the kill releasing
   its reservation, (b)'s offload accounting, and the same traffic
   drained FIFO, held to autograd too and giving the interleaved drain's
   grads on the first wave (the same params; later waves start from
   params that float noise has moved, which resnet18 amplifies).  Each
   reports steps/s, p50/p99
   request latency, the DMA hidden under other sessions' phases (on the
   card's clock) and the allocator peak beside the planned one.
19. train: llama3.2-3b trained at full width and depth (28 layers, fp32
   parameters and AdamW state, bf16 compute): (a) ``python -m
   repro_torch.launch.train --arch llama3.2-3b --shape train_4k --steps 3
   --batch 2 --microbatches 2`` in-process (``launch.train.main``), the
   default keep-all checkpoint plan, every loss finite, step 1 within 0.5
   of ln(128256), 168 flash and 168 SwiGLU launches (28 x 2 micro-batches
   x 3 steps, all wgmma, none in the replays), no forward through a
   plain twin (the SwiGLU twin runs once in each backward), each block
   holding exactly its tagged q, attention output and SwiGLU hidden, the
   peak within 80 GB and printed beside the reckoned parts, tokens/s and
   6NT against the bf16 peak; (b) the same with mlp_hidden offloaded
   (``offload=True``, a 100 MB budget, DMA priced at 10 TB/s; at the
   default prices the plan recomputes every eviction): first one
   micro-batch's loss and every grad against the keep-all plan's from the
   same parameters, normwise within 1e-4, with NaN written over the
   released device copies between forward and backward; then 3 steps:
   the bytes moved to pinned host memory per block equal h's, one fetch
   fence per block, the peak falls by at least half of them x 28, each
   loss equals (a)'s to 1e-6, the step times and fence waits printed; (c)
   fp32 at full width and depth 4, every tag recomputed (each kernel
   launched again in the replays), flash and SwiGLU simt against the
   twins on the card, loss and every grad normwise within 1e-4, for
   llama3.2-3b and granite-moe-1b-a400m (expert choices equal); (d) depth
   2 (vocabulary 4096, to keep the checkpoints small), 4 steps straight
   against 2 steps, a checkpoint and a restart, under deterministic
   algorithms: steps 3-4 bit for bit, the data state restored as saved.
   The two kernels are timed at the train step's shape (one sequence of
   4096) for their rows in the kernel table.
20. train_recurrent: the hybrid and ssm families trained through
   ``Trainer`` at full width (fp32 parameters and AdamW state, bf16
   compute, the default plan: each mamba, mLSTM and sLSTM block
   checkpointed with nothing saved, zamba's shared block under the plan's
   policy), every SSD and mLSTM scan's forward by its kernel and its
   backward by the vjp of ``ssd_chunked`` / ``mlstm_chunked``
   (``kernels/recompute.py``, timed on the card's clock): (e) zamba2-7b,
   depth 81 -> 39 (6 groups of 6 and a tail of 3; 81 layers' fp32 state is
   108 GB) and batch 256 -> 2, train_4k's 4096 tokens, 3 steps of 2
   micro-batches; (f) xlstm-1.3b at full width, depth 48 -> 16 (two
   groups), batch 2, sequence 4096 -> 1024, 2 steps.  Gates: finite losses, the first within
   1.0 of ln(vocab) (the untied unembedding starts at logits ~N(0, 1)),
   SSD / mLSTM / flash / SwiGLU launches exactly as the checkpoint
   structure implies (each scan in its forward and its block's replay;
   flash and SwiGLU by ``_expected_launches``), all wgmma, no forward
   through a twin, the peak within 80 GB beside the reckoned parts; (g)
   fp32 at full width, S = 1024, every tag recomputed, zamba at depth 7
   and xlstm at depth 8: the kernel path (SSD, mLSTM wgmma; flash, SwiGLU
   simt) against the twins in the wrappers' place on the card, the loss
   within 1e-4 and every grad of the whole model normwise within the
   larger of 1e-4 and 2x a second plain path's distance from the twins
   (the scans' forwards by ``ssd_chunked`` / ``mlstm_chunked``).
   xlstm-1.3b's mLSTM normaliser max(|n|, exp(-m)) is a kink whose branch
   a forward difference of fp32 size can flip in the backward, so its
   runs take every backward's branches from the twin run, the second
   plain paths include the twins with the kernel's own forward error
   (permuted) added, the flips and the unpinned grads are reported, and
   each mLSTM block is held at 1e-4 from its input and upstream gradient
   in the kernel run.  The four kernels are timed at these train
   steps' shapes for their rows, and one layer's backward recompute of
   each scan is timed alone.
21. multimodal (run after 14): the two multimodal families served at
   full width, random weights from seed 0, every cross block's ``xgate``
   set to 0.5 (at the reference's init of 0 the cross path adds nothing):
   (d) flash at llama-3.2-vision-11b's self (2, 32, 4096, 128, kv heads
   8, causal) and cross (4096 queries against 1600 image keys,
   non-causal) shapes and whisper-tiny's encoder shape (8, 6, 1500, 64,
   non-causal), SwiGLU at the vlm MLP's (8192, 4096, 14336) and
   whisper's encoder (12000, 384, 1536) and decoder (3584, 384, 1536)
   shapes, each against its twin in f32 and bf16 in every variant and
   timed for its kernel-table row; (a) llama-3.2-vision-11b's prefill
   step at full depth (8 super-blocks of 4 self blocks and 1 cross
   block), B = 2, S = 4096, 1600 image tokens, bf16: 40 self and 8 cross
   flash launches and 40 SwiGLU launches, each shape and count exact,
   all wgmma; the logits finite, moved by a second image, and their
   argmax against the naive path; (e) generate, 4 requests of 128
   prompt tokens + 16 greedy tokens through ``launch.serve.generate``
   (filled token by token: the family has no batched prefill), one
   SwiGLU launch per layer per decode step; (b) fp32 at depth 10, the
   kernel path (flash and SwiGLU simt) against the naive path at
   positions 0, 511 and S - 1 within ``LOGITS_REL_TOL``; (c)
   whisper-tiny's prefill step, B = 8, 1500 frames, a decoder S of 448:
   4 encoder flash launches (the decoder's 448 queries take the naive
   path, as the reference's) and 8 SwiGLU launches, all wgmma, the
   logits moved by other frames, (e) its generate, and fp32 at full
   depth against the naive path.  The phase prints its wall time.
22. train_multimodal: the multimodal families trained through ``Trainer``
   with a producer that adds the stubbed frontends' embeddings (from a
   seed), fp32 parameters and AdamW state, bf16 compute, the default
   keep-all plan, every xgate at 0.5 (at 0 no gradient reaches a
   cross-attention, nor whisper's encoder): (h) llama-3.2-vision-11b at
   full width, depth 40 -> 5 (one super-block, one checkpoint region;
   40 layers' fp32 state is 162 GB), train_4k's 4096 tokens
   against 1600 image embeddings, batch 256 -> 2, 3 steps of 2
   micro-batches; (i) whisper-tiny at full width and depth, 4096 decoder
   tokens against 1500 frames, batch 256 -> 8 in 2 micro-batches of 4.
   Gates: finite losses, the first within 1.0 of ln(vocab); every flash
   (self, causal; cross, Sq != Skv; whisper's encoder) and SwiGLU launch
   counted by shape, exactly, all wgmma; no forward through a twin (the
   SwiGLU twin runs once in each backward); one region per super-block
   (vlm) or block (whisper) of each micro-batch, each keeping exactly its
   reckoned tags and inputs and replayed once; the peak within 80 GB
   beside the reckoned parts; every cross-attention's and whisper's
   encoder grads non-zero.  Each reports step s, tokens/s, 6NT against
   the bf16 peak, the flash backward's host ms (cross calls apart) and,
   from one more step under ``torch.profiler``, the device's idle share;
   (j) fp32, every tag recomputed: the vlm at depth 5 (one super-block),
   S = 1024 against 1600 image tokens, and whisper at full depth, S =
   1024 against 1500 frames, the kernel path (flash and SwiGLU simt, each
   launched again in the replays) against the twins in the wrappers'
   place, the loss and every grad of the whole model normwise within
   1e-4.  The two kernels are timed at the train steps' eight shapes for
   their rows, and one cross-attention call's backward alone.
23. examples (run after 18, the paper's phases): the four examples of
   ``examples/torch_*.py`` on the card at their default sizes, each with
   its own assertions (``torch_quickstart``: the reduced LM trained 30
   steps, checkpointed and resumed to 40, its loss falling, the graph
   plan, the verifier catching a dropped Prefetch, the async replay,
   vgg16's optimizer-offload plan, the serving and interleaved two-QoS
   serving demos; ``torch_personalize_transfer``: Fig. 12's planned
   peaks and 60 epochs of resnet18_transfer's head on 4 x 5 sketches,
   the loss falling; ``torch_tts_unroll``: 300 clipped SGD iterations of
   the E-shared unrolled tacotron2 decoder, the loss below 0.9 of its
   start; ``torch_distributed_pretrain``: the ~100M LM (12 layers, d 640,
   fp32, naive attention) trained 300 steps of 8 x 128 tokens by the
   ``Trainer`` on a (1, 1) mesh over a world of one NCCL rank, async
   checkpoints every 100 steps, heartbeats, its last loss below its
   first).  Gates: the paper's graph path launches no kernel of the
   transformer path; the quickstart's reduced LM (S = 64, the naive
   attention path) launches the SwiGLU kernel exactly once a layer per
   train step's forward and nothing else, and so does the pretrain
   example's (12 a step, the fp32 simt kernel; its row in the kernel
   line is timed at its shape, x (1024, 640), W (640, 2560)).  Each
   example's output goes to ``build/example_logs/<example>.log``.
24. roofline (last): ``launch/hw.py``'s ``measure()`` (an 8192-cubed bf16
   GEMM and a 4 GiB device copy) beside the data-sheet peaks, then the
   cost probe (``launch/probe.py``: one micro-batch at 1 and 2 periods in
   probe mode, FLOPs from ``FlopCounterMode``, bytes from the eager ops,
   the kernels' analytic terms from ``launch/costs.py``) and the roofline
   row (``launch/roofline.py``) of each cell an earlier phase timed:
   llama3.2-3b's train step (a) and the B = 2, S = 4096 prefill steps of
   llama3.2-3b, granite-moe-1b-a400m, zamba2-7b and xlstm-1.3b, each
   row's ``mfu`` from that phase's step time.  Gates: no kernel launched
   in probe mode, a third probe at 3 periods within 1e-6 of the
   extrapolation (the train step), one llama3.2-3b forward period's
   matmul FLOPs within 1% of the count reckoned from the config, every
   ``mfu`` and ``roofline_fraction`` at most 1.
25. dist (run after 21, before the paper's phases): the train step on a
   (data, model) mesh (``make_train_step(..., mesh=...)``): (k) a
   one-rank NCCL group, mesh (1, 1): llama3.2-3b at full width, 2
   sequences of 4096 in 2 micro-batches, against the step without a mesh
   from the same parameters, fp32 at depth 2 (loss and every grad within
   1e-6) and bf16 at depth 4 (normwise 2e-2), the flash and SwiGLU
   launches by shape equal (bf16: train (a)'s shapes, all wgmma), and
   the same step on the multi-pod mesh (pod, data, model) = (1, 1, 1)
   bit for bit the (1, 1) step (loss, every gradient, launches); (l)
   four ranks sharing the card over gloo (every collective staged through
   host copies), mesh (2, 2), FSDP by the reference's size rule, at full
   width, 2 sequences of 4096: llama3.2-3b (1 layer, bf16),
   llama-3.2-vision-11b (one self and one cross block, xgate 0.5, 1600
   image embeddings; fp32 and bf16), zamba2-7b (one group of three mamba
   layers and the shared block; fp32 and bf16: each rank's 56 SSD heads),
   granite-moe-1b-a400m (2 layers, bf16: each rank's 16 experts, the
   one-rank run's routing replayed, flips counted) and whisper-tiny
   (whole, 1500 frames, bf16: 3 heads a rank), each rank's blocks of the
   loss and grads against the one-rank step's (fp32 per leaf 1e-4, bf16
   normwise 2e-2; zamba2-7b's SSD decay leaves in fp32 to the larger of
   1e-4 and 2x the distance of two other correct one-rank runs, as (g);
   zamba2-7b's and whisper-tiny's bf16 gradients to the fixed
   ``DIST_BF16_TOL``, each also read against the one-rank fp32 gradient;
   granite's routing flips at most ``DIST_FLIP_FRACTION`` of a rank's
   choices), and xlstm-1.3b (one group of 7 mLSTM blocks and the sLSTM
   block, 4 sequences of 1024 in 2 micro-batches; fp32 and bf16: each
   rank's 2 mLSTM heads, every backward's normaliser branches pinned to
   the one-rank run's, its rows and heads of them; fp32 per leaf 1e-4,
   bf16 at the fixed ``DIST_BF16_TOL``); then every family's decode step
   on the mesh (``make_decode_step(..., mesh=...)``, the same depths, 4
   sequences, 4 tokens from a zero state with seeded cross caches)
   against the one-rank decode, each rank's blocks of every step's
   logits and of the final state (fp32 normwise 1e-4; bf16 within twice
   the one-rank bf16 decode's own distance from the fp32 one, at least
   2e-2; granite's routing replayed); every flash, SwiGLU, SSD and mLSTM
   launch at the per-rank shapes, the train steps' all wgmma, each held
   against its twin there and timed for its kernel-table row; the
   tally's collectives by kind per rank; and llama3.2-3b at one layer in
   fp32 on the multi-pod mesh (pod, data, model) = (2, 1, 2), 2
   sequences (one a (pod, data) rank): the loss and each rank's blocks of
   every gradient leaf within 1e-4 of the one-rank step's, the flash and
   SwiGLU kernels launched and bytes all-reduced over ``pod`` on every
   rank.

The bf16 prefill steps (3, 5, 8, 11, 21), the bf16 train steps (19 (a),
20 (e), (f), 22 (h), (i)) and generate's SwiGLU launches must
count under the wgmma variants only; in the fp32 parity phases (7, 10,
13, 21, 22 (j)) flash and SwiGLU count under simt and SSD and mLSTM under
wgmma
(``LAUNCHES_BY_VARIANT``).  Every phase prints one
JSON line.  Any failed check exits non-zero.  TF32 is off for cuDNN and
for matmuls throughout.  Before the kernel table comes the paper path's
table (one row per graph, backend and plan).  The line before the last is
the kernel table (each row with its ``variant`` and ``prev_ms``, the
earlier design's time in this run), the last the device line.  It
needs the card: without one, or without the repo's sources beside it, it
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The card's published peaks are ``repro_torch.launch.hw``'s and the
# kernels' per-launch operations and bytes ``repro_torch.launch.costs``'s;
# both are imported once ``main`` has found the sources.

FLASH_CASES = [
    # (b, hq, hkv, sq, skv, d, causal, block_q, block_kv), tests/test_kernels.py
    (1, 2, 2, 128, 128, 64, True, 64, 64),
    (2, 4, 2, 256, 256, 64, True, 128, 128),
    (1, 8, 1, 128, 128, 128, True, 64, 64),
    (1, 2, 2, 200, 200, 64, True, 64, 64),
    (1, 2, 2, 128, 256, 64, False, 64, 128),
    (2, 2, 2, 256, 256, 32, True, 256, 256),
]
FULL_SHAPE = (2, 24, 8, 4096, 4096, 128, True, 512, 1024)   # llama3.2-3b
RAGGED_SHAPE = (2, 24, 8, 1000, 1000, 128, True, 512, 1024)
D112_CASES = [(1, 2, 2, 200, 200, 112, True, 64, 64),
              (2, 32, 32, 1000, 1000, 112, True, 512, 1024)]
ZAMBA_SHAPE = (2, 32, 32, 4096, 4096, 112, True, 512, 1024)  # zamba2-7b
SSD_CASES = [
    # (b, s, h, p, n, chunk), tests/test_kernels.py:84-90
    (1, 64, 2, 16, 16, 32),
    (2, 128, 4, 32, 64, 64),
    (1, 100, 2, 16, 16, 32),
    (1, 32, 1, 64, 32, 32),
]
SSD_FULL = (2, 4096, 112, 64, 64, 256)      # zamba2-7b mamba layer, B = 2
SSD_RAGGED = (2, 4000, 112, 64, 64, 256)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_kernels.py:105
MLSTM_CASES = [
    # (b, s, h, p, chunk), tests/test_kernels.py:130
    (1, 64, 2, 16, 32),
    (2, 128, 4, 32, 64),
    (1, 100, 2, 16, 32),
    (1, 32, 1, 64, 32),
]
MLSTM_FULL = (2, 4096, 4, 1024, 256)        # xlstm-1.3b mLSTM layer, B = 2
MLSTM_RAGGED = (2, 4000, 4, 1024, 256)
MLSTM_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py:151
GRANITE_SHAPE = (2, 16, 8, 4096, 4096, 64, True, 512, 1024)  # granite-moe
# the reference's full granite-moe-1b-a400m tree (tests/test_torch_moe.py):
# ModelConfig.param_count()'s 1,334,627,328 + the padded vocab rows + ln_f
GRANITE_PARAMS = 1_334_887_424
SWIGLU_CASES = [
    # (e, m, k, f), tests/test_kernels.py:175, a dense MLP each (e = 1)
    (1, 128, 256, 512),
    (1, 256, 512, 256),
    (1, 100, 200, 300),
    (1, 64, 64, 64),
]
# the prefill steps' shapes at B = 2, S = 4096 (M = B S; granite-moe: one
# launch for all 32 experts, M = G C = 2 x 1280), then a ragged batch with
# an unaligned K and a decode step's (4 requests)
SWIGLU_PATHS = {"llama3.2-3b MLP": (1, 8192, 3072, 8192),
                "zamba2-7b shared MLP": (1, 8192, 3584, 14336),
                "granite-moe-1b-a400m experts": (32, 2560, 1024, 512)}
# the pretrain example's MLP at its default size: 8 x 128 tokens, fp32
PRETRAIN_SWIGLU = (1, 1024, 640, 2560)
SWIGLU_EXTRA = [(3, 1000, 1003, 700), (32, 4, 1024, 512), PRETRAIN_SWIGLU]
# decode steps' shapes (4 requests), timed beside the path shapes
SWIGLU_DECODE = {"llama3.2-3b MLP, decode": (1, 4, 3072, 8192),
                 "granite-moe-1b-a400m experts, decode": (32, 4, 1024, 512)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),       # tests/test_kernels.py
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# the paper's path (phases 15-16): the executor tests' swap-forcing config
PAPER_EXEC = dict(min_idle_phases=3, min_bytes=1 << 12)
PAPER_ZOO_BATCH = 64
TRUNK_BATCH = 4096
TRUNK_STEPS = 3
# paper_optim's learning rates: the reference's AdamW default, at which the
# trunk's loss diverges, and one at which it falls
TRUNK_LRS = (3e-4, 1e-5)
# after the SGD steps: rounds of one swapped (async) and one no-swap step,
# in turns, for the medians of their step times
TRUNK_TIMED_ROUNDS = 5
# personalize: after the gated runs, waves of the same traffic drained
# interleaved and FIFO in turns, for the medians of their wall times
SERVE_TIMED_ROUNDS = 7
# paper_zoo: resnet18_transfer's async and jit_blocks steps in turns
JIT_TIMED_ROUNDS = 7
# grads against autograd on the card: elementwise rtol 1e-4 with atol 1e-5
# per unit of the tensor's largest entry, and normwise max|a-b| <= 1e-4
# max|b|.  The port's backward (layer by layer, from the lowered schedule)
# and autograd's sum in different orders, and each fp32 result lies far
# further from the exact gradients than from the other (paper_zoo's rows
# carry both: grad_err against autograd, grad_err_fp64 and
# ref_grad_err_fp64 against an fp64 autograd run), so on resnet18 a plain
# atol of 1e-5 would hold mid-sized entries to more than fp32 computes.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_NORM_TOL = 1e-4
PAIRED_STATS = ("swap_outs", "prefetches", "inplace_prefetches", "dma_bytes",
                "hbm_high_water", "host_high_water", "peak_inflight_prefetch")
# fp32 full-width logits, kernel path vs plain path: max|a-b| / max|b|.
# Both sum in fp32 in another order through 28 layers; computing either in
# bf16 (or TF32) gives errors near 1e-2.
LOGITS_REL_TOL = 1e-3
# step seconds measured by the phases, by cell, for the roofline's mfu
STEP_S = {}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, stamped with the seconds since the script started
    (``t_s``: the phases' timeline)."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


def check(ok: bool, phase: str, what: str) -> None:
    if not ok:
        emit({"phase": phase, "ok": False, "failed": what})
        sys.exit(1)


def main() -> int:
    # cuBLAS is deterministic only with a fixed workspace (train (d))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
        from repro_torch.kernels.flash_attention import kernel as fa
        from repro_torch.kernels.ssm_scan import kernel as ssd
        from repro_torch.kernels.mlstm_scan import kernel as ml
        from repro_torch.kernels.fused_swiglu import kernel as sw
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gpu = gpu.splitlines()[0]
    print(gpu, flush=True)

    # ---- 1. build: one nvcc per source, started together -------------------
    t0 = time.perf_counter()
    sources = [fa.WGMMA_SOURCE, fa.SOURCE, ssd.WGMMA_SOURCE, ssd.SOURCE,
               ml.WGMMA_SOURCE, ml.SOURCE, sw.WGMMA_SOURCE, sw.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        for fut in [pool.submit(_build.load, src) for src in sources]:
            fut.result()
    for m in (fa, ssd, ml, sw):
        for variant in m.VARIANTS:
            m.build(variant)
    emit({"phase": "build", "ok": True, "gpu": gpu,
          "build_s": time.perf_counter() - t0,
          "ptxas": {src.name: _build.ptxas_report(src) for src in sources}})

    llama_row, zamba_flash_row, granite_flash_row = \
        phase_kernels(torch, fa, gpu)
    ssd_row = phase_ssd_kernels(torch, ssd, gpu)
    mlstm_row = phase_mlstm_kernels(torch, ml, gpu)
    sw_rows = phase_swiglu_kernels(torch, sw, gpu)
    llama_row["launches"], sw_rows[0]["launches"] = \
        phase_prefill(torch, fa, sw, gpu)
    phase_generate(torch, fa, sw, gpu)
    ssd_row["launches"], zamba_flash_row["launches"], \
        sw_rows[1]["launches"] = phase_zamba(torch, fa, ssd, sw, gpu)
    phase_zamba_fp32_parity(torch, fa, ssd, sw)
    mlstm_row["launches"] = phase_xlstm(torch, ml, gpu)
    phase_xlstm_fp32_parity(torch, ml)
    granite_flash_row["launches"], sw_rows[2]["launches"] = \
        phase_granite(torch, fa, sw, gpu)
    phase_granite_fp32_parity(torch, fa, sw)
    phase_bf16_parity(torch, fa, ssd, ml, sw)
    mm_rows = phase_multimodal(torch, fa, sw, gpu)
    # before the paper's phases, whose host pools (~76 GB resident) would
    # leave too little host memory for the four ranks of (l)
    dist_rows = phase_dist(torch, fa, ssd, ml, sw, gpu)
    _zero(fa, ssd, ml, sw)
    paper_rows = phase_paper_zoo(torch, gpu) + phase_paper_trunk(torch, gpu)
    paper_rows += phase_paper_optim(torch, gpu) + phase_personalize(torch, gpu)
    check(all(m.LAUNCHES == 0 for m in (fa, ssd, ml, sw)), "paper_path",
          "the paper's path launched a kernel of the transformer path")
    example_row = phase_examples(torch, (fa, ssd, ml, sw), gpu)
    train_rows = _train_rows(torch, fa, sw, gpu)
    train_rows += _train_recurrent_rows(torch, fa, ssd, ml, sw, gpu)
    mm_train_rows = _train_multimodal_rows(torch, fa, sw, gpu)
    phase_roofline(torch, (fa, ssd, ml, sw), gpu)

    emit({"phase": "done", "ok": True,
          "wall_s": time.perf_counter() - t_start})
    print(json.dumps({"paper_path": paper_rows}), flush=True)
    print(json.dumps({"kernels": [llama_row, zamba_flash_row, ssd_row,
                                  mlstm_row, *sw_rows,
                                  granite_flash_row, *train_rows,
                                  *mm_rows, *mm_train_rows,
                                  *dist_rows, example_row]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _train_rows(torch, fa, sw, gpu):
    """The train phase, then its two kernel rows: each kernel timed at the
    train step's shape (one sequence of 4096), with the launches of (a)."""
    flash_row = _flash_times(torch, fa, gpu, TRAIN_FLASH_SHAPE, "llama3.2-3b")
    sw_row = _swiglu_times(torch, sw, gpu, TRAIN_SWIGLU_SHAPE,
                           "llama3.2-3b MLP")
    launches = phase_train(torch, fa, sw, gpu)
    flash_row.update(path="llama3.2-3b train step (forward and replays)",
                     launches=launches["flash"])
    sw_row.update(path="llama3.2-3b MLP, train step (forward and replays)",
                  launches=launches["swiglu"])
    return [flash_row, sw_row]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _inputs(torch, case, dtype, seed):
    b, hq, hkv, sq, skv, d = case[:6]
    g = torch.Generator("cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)


def _compare(got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return ok, err.max().item()


def _zero(*mods):
    """Set the kernels' launch counts to 0, the counts by variant too."""
    for m in mods:
        if hasattr(m, "reset_launches"):
            m.reset_launches()
        else:
            m.LAUNCHES = 0


def _only(m, variant, n):
    """Whether kernel module ``m`` counted ``n`` launches, all of them
    under ``variant``."""
    return m.LAUNCHES == n and m.LAUNCHES_BY_VARIANT == {
        v: (n if v == variant else 0) for v in m.VARIANTS}


def _median_ms(torch, fn, reps, warmup=1, inner=5):
    """Median over ``reps`` of the time of one call, each taken from CUDA
    events around ``inner`` calls in a row, so the card never waits for
    the host's launch of the next one."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def _in_turns(torch, fns):
    """Each (fn, reps)'s median time, measured twice in turns (a, b, c, c,
    b, a) in this call; the lesser of the two medians for each."""
    times = [[] for _ in fns]
    for i in list(range(len(fns))) + list(reversed(range(len(fns)))):
        fn, reps = fns[i]
        times[i].append(_median_ms(torch, fn, reps=reps))
    return [min(t) for t in times]


def _peak_flops(dtype_name):
    from repro_torch.launch import hw
    return hw.PEAK_FLOPS[dtype_name]


def flash_bound(case, dtype_name):
    """Least time (ms) the card needs for one call: the larger of the
    operations this call's mask keeps over the dtype's peak and the bytes
    of q, k, v and o over HBM bandwidth (``costs.flash_launch``)."""
    from repro_torch.launch import costs, hw
    flops, nbytes = costs.flash_launch(case, dtype_name)
    return (*hw.bound_ms(flops, nbytes, dtype_name), flops)


# ---------------------------------------------------------------------------
# 2. kernels against their plain twins
# ---------------------------------------------------------------------------

def flash_variants(dtype_name):
    """Every flash kernel the wrapper can choose for a dtype: fp32 runs the
    SIMT kernel; bf16 the wgmma kernel, and the SIMT (PR 14) design forced
    beside it."""
    return ["wgmma", "simt"] if dtype_name == "bfloat16" else ["simt"]


def phase_kernels(torch, fa, gpu):
    """The flash kernel against its twin in each variant, then its times at
    the llama3.2-3b (D = 128), zamba2-7b (D = 112) and granite-moe-1b-a400m
    (D = 64) layer shapes: one kernel-table row for each."""
    results = _flash_twin_checks(
        torch, fa, FLASH_CASES + D112_CASES + [RAGGED_SHAPE, FULL_SHAPE,
                                               ZAMBA_SHAPE, GRANITE_SHAPE])
    emit({"phase": "kernels", "ok": True, "kernel": "flash_attention_fwd",
          "checked": len(results),
          "worst": {vr: max(r["max_abs_err"] for r in results
                            if r["variant"] == vr) for vr in fa.VARIANTS},
          "results": results})
    return (_flash_times(torch, fa, gpu, FULL_SHAPE, "llama3.2-3b"),
            _flash_times(torch, fa, gpu, ZAMBA_SHAPE, "zamba2-7b"),
            _flash_times(torch, fa, gpu, GRANITE_SHAPE,
                         "granite-moe-1b-a400m"))


def _flash_twin_checks(torch, fa, cases, phase="kernels"):
    """Each case in f32 and bf16, in each variant, against the twin within
    ``TOL``, the wrapper's choice checked; the results, one per run."""
    results = []
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q, k, v = _inputs(torch, case, dtype, seed=len(results))
            causal, bq, bkv = case[6:]
            chosen = fa.variant_for(q, k, v)
            check(chosen == flash_variants(name)[0], phase,
                  f"{case} {name}: the wrapper chose {chosen}")
            want = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                block_q=bq, block_kv=bkv)
            for variant in flash_variants(name):
                got = fa._launch(q, k, v, causal, variant)
                torch.cuda.synchronize()
                ok, err = _compare(got, want, **TOL[name])
                results.append({"case": list(case[:7]), "dtype": name,
                                "variant": variant, "max_abs_err": err,
                                "ok": ok})
                check(ok, phase,
                      f"{case} {name} {variant}: max_abs_err {err}")
                del got
            del q, k, v, want
    return results


def _flash_times(torch, fa, gpu, shape, arch):
    """Times at a full-width layer shape, bf16 (what the prefill step
    runs): the kernel the wrapper chooses, the PR 14 design (SIMT, forced),
    the plain twin and SDPA, in turns, in this call."""
    import torch.nn.functional as F

    q, k, v = _inputs(torch, shape, torch.bfloat16, seed=123)
    causal, bq, bkv = shape[6:]
    variant = fa.variant_for(q, k, v)
    out = fa.flash_attention_fwd(q, k, v, causal=causal)
    want = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                        block_q=bq, block_kv=bkv)
    _, err = _compare(out, want, **TOL["bfloat16"])
    groups = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(groups, dim=1)
    vv = v.repeat_interleave(groups, dim=1)
    lib_out = F.scaled_dot_product_attention(q, kk, vv, is_causal=causal)
    _, lib_err = _compare(out, lib_out, **TOL["bfloat16"])

    def new():
        return fa.flash_attention_fwd(q, k, v, causal=causal)

    def prev():
        return fa._launch(q, k, v, causal, "simt")

    def library():
        return F.scaled_dot_product_attention(q, kk, vv, is_causal=causal)

    ms, prev_ms, library_ms = _in_turns(
        torch, [(new, 10), (prev, 3), (library, 10)])
    plain_ms = _median_ms(torch, lambda: fa.flash_attention_fwd_plain(
        q, k, v, causal=causal, block_q=bq, block_kv=bkv), reps=5)
    bound_ms, bound_by, flops = flash_bound(shape, "bfloat16")
    emit({"phase": "kernel_times", "ok": True, "gpu": gpu,
          "kernel": "flash_attention_fwd", "arch": arch,
          "shape": list(shape[:7]), "dtype": "bfloat16", "variant": variant,
          "kernel_ms": ms, "prev_ms": prev_ms, "plain_ms": plain_ms,
          "sdpa_ms": library_ms, "sdpa_max_abs_diff": lib_err,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "kernel_tflops": flops / ms / 1e9,
          "prev_tflops": flops / prev_ms / 1e9,
          "sdpa_tflops": flops / library_ms / 1e9,
          "roofline_share": bound_ms / ms, "speedup_vs_prev": prev_ms / ms})
    del q, k, v, kk, vv, out, want, lib_out
    torch.cuda.empty_cache()
    return {"name": "flash_attention_fwd", "route": "cuda",
            "variant": variant,
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      + fa.SOURCES[variant].name,
            "replaces": "src/repro/kernels/flash_attention/kernel.py:91",
            "path": f"{arch} prefill step", "shape": list(shape[:7]),
            "launches": 0, "max_abs_err": err, "ms": ms,
            "prev_ms": prev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def ssd_bound(case):
    """Least time (ms) the card needs for one SSD chunk call on ``case``'s
    chunks: the larger of the matrix operations the function needs on the
    pairs the causal mask keeps over the tf32 tensor-core peak, and the
    fp32 bytes of its inputs and outputs over HBM bandwidth.  The tf32
    peak, not the fp32 CUDA-core one, because the tensor cores compute the
    same fp32-accurate products (3xTF32: three tf32 passes on split
    operands, each pass counted at the full rate): it is the least time
    for this work on this card.  B and C are one group, so C Bᵀ (2n per
    kept pair) is counted once per (batch, chunk); the decay-weighted
    product with X (2p per kept pair) and the state (2 Q n p) once per
    (batch, chunk, head) (``costs.ssd_launch``)."""
    from repro_torch.launch import costs, hw
    flops, nbytes = costs.ssd_launch(case)
    return (*hw.bound_ms(flops, nbytes, "tfloat32"), flops, nbytes)


def _ssd_inputs(torch, case, seed):
    """Chunked (padded) float32 inputs with tests/test_kernels.py's
    distributions: x, B, C normal, dt = softplus(normal), A_log 0.5 normal."""
    from repro_torch.kernels.ssm_scan.ops import chunk_inputs

    b, s, h, p, n, chunk = case
    g = torch.Generator("cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x, B, C = rnd(b, s, h, p), rnd(b, s, n), rnd(b, s, n)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    A_log = rnd(h) * 0.5
    xc, dtc, Bc, Cc = chunk_inputs(x, dt, B, C, chunk)
    return xc, dtc, A_log, Bc, Cc


def ssd_variant(case):
    """The SSD kernel the wrapper should choose: wgmma for n = p = 64 and
    chunks of whole 64-row tiles up to 256, else simt."""
    _, s, _, p, n, chunk = case
    q = min(chunk, s)
    return "wgmma" if p == n == 64 and q % 64 == 0 and q <= 256 else "simt"


def mlstm_variant(case):
    """The mLSTM kernel the wrapper should choose: wgmma for head dims
    that are multiples of 128 and chunks of whole 64-row tiles up to 256,
    else simt."""
    _, s, _, p, chunk = case
    q = min(chunk, s)
    return "wgmma" if p % 128 == 0 and q % 64 == 0 and q <= 256 else "simt"


def _twin_checks(torch, m, kernel, cases, make_inputs, names, tol,
                 expected):
    """Each case's every variant (the one the wrapper should choose, and
    the earlier simt design forced beside a wgmma one) against the
    plain twin, all outputs finite and within ``tol``; the wrapper's
    choice checked.  Returns the results."""
    plain = getattr(m, f"{kernel}_plain")
    results = []
    for case in cases:
        ins = make_inputs(torch, case, seed=len(results))
        chosen = m.variant_for(*ins[:5])
        check(chosen == expected(case), kernel,
              f"{case}: the wrapper chose {chosen}")
        want = plain(*ins)
        for variant in dict.fromkeys([chosen, "simt"]):
            got = m._launch(*ins, variant)
            torch.cuda.synchronize()
            errs = []
            for name, g, w in zip(names, got, want):
                ok, err = _compare(g, w, **tol)
                check(ok and bool(g.isfinite().all()), kernel,
                      f"{case} {variant} {name}: max_abs_err {err}")
                errs.append(err)
            results.append({"case": list(case), "variant": variant,
                            "max_abs_err": max(errs),
                            "per_output": dict(zip(names, errs)),
                            "ok": True})
            del got
        del ins, want
    emit({"phase": "kernels", "ok": True, "kernel": kernel,
          "checked": len(results), "tol": tol,
          "worst": {vr: max(r["max_abs_err"] for r in results
                            if r["variant"] == vr)
                    for vr in m.VARIANTS
                    if any(r["variant"] == vr for r in results)},
          "results": results})
    return results


def _scan_times(torch, m, kernel, ins, reps):
    """The kernel the wrapper chooses and the earlier simt design,
    in turns, in this call; then the plain twin."""
    fn, plain = getattr(m, kernel), getattr(m, f"{kernel}_plain")
    ms, prev_ms = _in_turns(torch, [
        (lambda: fn(*ins), reps), (lambda: m._launch(*ins, "simt"), reps)])
    plain_ms = _median_ms(torch, lambda: plain(*ins), reps=3)
    return ms, prev_ms, plain_ms


SSD_OUTPUTS = ("y_diag", "states", "chunk_lf")


def phase_ssd_kernels(torch, ssd, gpu):
    """The SSD kernel against its twin (all three outputs) in every
    variant, then its times at zamba2-7b's full-width shape: the wgmma
    kernel and the earlier simt design in turns; the kernel-table row."""
    _twin_checks(torch, ssd, "ssd_chunk", SSD_CASES + [SSD_RAGGED, SSD_FULL],
                 _ssd_inputs, SSD_OUTPUTS, SSD_TOL, ssd_variant)
    ins = _ssd_inputs(torch, SSD_FULL, seed=321)
    variant = ssd.variant_for(*ins)
    err = max(_compare(g, w, **SSD_TOL)[1] for g, w in
              zip(ssd.ssd_chunk(*ins), ssd.ssd_chunk_plain(*ins)))
    ms, prev_ms, plain_ms = _scan_times(torch, ssd, "ssd_chunk", ins, 20)
    bound_ms, bound_by, flops, nbytes = ssd_bound(SSD_FULL)
    emit({"phase": "kernel_times", "ok": True, "gpu": gpu,
          "kernel": "ssd_chunk", "arch": "zamba2-7b",
          "shape": dict(zip("b s h p n chunk".split(), SSD_FULL)),
          "variant": variant, "kernel_ms": ms, "prev_ms": prev_ms,
          "plain_ms": plain_ms, "library_ms": None,
          "library_note": "no single PyTorch call computes the SSD chunk "
                          "(a masked decay-weighted product and the chunk "
                          "state)",
          "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
          "bytes": nbytes, "kernel_tflops": flops / ms / 1e9,
          "prev_tflops": flops / prev_ms / 1e9,
          "roofline_share": bound_ms / ms,
          "prev_roofline_share": bound_ms / prev_ms,
          "speedup_vs_prev": prev_ms / ms})
    del ins
    torch.cuda.empty_cache()
    return {"name": "ssd_chunk", "route": "cuda", "variant": variant,
            "source": "src/repro_torch/kernels/ssm_scan/csrc/"
                      + ssd.SOURCES[variant].name,
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:61",
            "path": "zamba2-7b prefill step", "shape": list(SSD_FULL),
            "launches": 0, "max_abs_err": err, "ms": ms, "prev_ms": prev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def mlstm_bound(case):
    """Least time (ms) the card needs for one mLSTM chunk call on ``case``'s
    chunks: the larger of the operations the function needs over the tf32
    tensor-core peak (per (batch, chunk, head): 2p flops on each pair the
    causal mask keeps for q kᵀ and again for W v, 2 Q p² for the state and
    2 Q p for the norm) and the fp32 bytes of its inputs and outputs over
    HBM bandwidth.  The tf32 peak, not the fp32 CUDA-core one, because the
    tensor cores compute the same fp32-accurate products (3xTF32, each
    pass counted at the full rate): it is the least time for this work on
    this card (``costs.mlstm_launch``)."""
    from repro_torch.launch import costs, hw
    flops, nbytes = costs.mlstm_launch(case)
    return (*hw.bound_ms(flops, nbytes, "tfloat32"), flops, nbytes)


def _mlstm_inputs(torch, case, seed):
    """Chunked (padded) float32 inputs with tests/test_kernels.py's
    distributions: q, k, v ~ N(0, 1), ig ~ 2 N, fg ~ 2 N + 2."""
    from repro_torch.kernels.mlstm_scan.ops import chunk_inputs

    b, s, h, p, chunk = case
    g = torch.Generator("cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    q, k, v = rnd(b, s, h, p), rnd(b, s, h, p), rnd(b, s, h, p)
    ig, fg = rnd(b, s, h) * 2, rnd(b, s, h) * 2 + 2
    return (*chunk_inputs(q, k, v, ig, fg, chunk), 1 / math.sqrt(p))


MLSTM_OUTPUTS = ("y_intra", "n_intra", "m_intra", "states", "norms",
                 "chunk_lf", "m_state")


def phase_mlstm_kernels(torch, ml, gpu):
    """The mLSTM kernel against its twin (all seven outputs) in every
    variant, then its times at xlstm-1.3b's full-width shape: the wgmma
    kernel and the earlier simt design in turns; the kernel-table row."""
    _twin_checks(torch, ml, "mlstm_chunk",
                 MLSTM_CASES + [MLSTM_RAGGED, MLSTM_FULL], _mlstm_inputs,
                 MLSTM_OUTPUTS, MLSTM_TOL, mlstm_variant)
    ins = _mlstm_inputs(torch, MLSTM_FULL, seed=321)
    variant = ml.variant_for(*ins[:5])
    err = max(_compare(g, w, **MLSTM_TOL)[1] for g, w in
              zip(ml.mlstm_chunk(*ins), ml.mlstm_chunk_plain(*ins)))
    ms, prev_ms, plain_ms = _scan_times(torch, ml, "mlstm_chunk", ins, 10)
    bound_ms, bound_by, flops, nbytes = mlstm_bound(MLSTM_FULL)
    emit({"phase": "kernel_times", "ok": True, "gpu": gpu,
          "kernel": "mlstm_chunk", "arch": "xlstm-1.3b",
          "shape": dict(zip("b s h p chunk".split(), MLSTM_FULL)),
          "variant": variant, "kernel_ms": ms, "prev_ms": prev_ms,
          "plain_ms": plain_ms, "library_ms": None,
          "library_note": "no single PyTorch call computes the mLSTM chunk "
                          "(a masked, stabilised decay-weighted product, "
                          "the chunk state and its norm)",
          "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
          "bytes": nbytes, "kernel_tflops": flops / ms / 1e9,
          "prev_tflops": flops / prev_ms / 1e9,
          "roofline_share": bound_ms / ms,
          "prev_roofline_share": bound_ms / prev_ms,
          "speedup_vs_prev": prev_ms / ms})
    del ins
    torch.cuda.empty_cache()
    return {"name": "mlstm_chunk", "route": "cuda", "variant": variant,
            "source": "src/repro_torch/kernels/mlstm_scan/csrc/"
                      + ml.SOURCES[variant].name,
            "replaces": "src/repro/kernels/mlstm_scan/kernel.py:65",
            "path": "xlstm-1.3b prefill step", "shape": list(MLSTM_FULL),
            "launches": 0, "max_abs_err": err, "ms": ms, "prev_ms": prev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def swiglu_bound(case, dtype_name):
    """Least time (ms) the card needs for one fused SwiGLU call: the larger
    of the two products' 4 E M K F flops over the dtype's peak and the
    bytes of x, Wg, Wu and h over HBM bandwidth (``costs.swiglu_launch``)."""
    from repro_torch.launch import costs, hw
    flops, nbytes = costs.swiglu_launch(case, dtype_name)
    return (*hw.bound_ms(flops, nbytes, dtype_name), flops, nbytes)


def _swiglu_inputs(torch, case, dtype, seed):
    """x ~ 0.5 N, wg, wu ~ 0.05 N (tests/test_kernels.py); the dense
    (M, K) form for e = 1, the expert form (E, M, K) otherwise."""
    e, m, k, f = case
    g = torch.Generator("cuda").manual_seed(seed)

    def rnd(shape, scale):
        t = torch.randn(shape, generator=g, device="cuda") * scale
        return t.to(dtype)

    x, wg, wu = rnd((e, m, k), 0.5), rnd((e, k, f), 0.05), \
        rnd((e, k, f), 0.05)
    return (x[0], wg[0], wu[0]) if e == 1 else (x, wg, wu)


def swiglu_variants(case, dtype_name):
    """Every SwiGLU kernel the wrapper can choose for a case and dtype: fp32
    runs the SIMT kernel; bf16 the wgmma kernel where TMA can describe the
    rows (K, F multiples of 8), with the mma.sync (PR 14) design forced
    beside it, else the mma.sync kernel alone."""
    if dtype_name == "float32":
        return ["simt"]
    _, _, k, f = case
    return ["wgmma", "mma_sync"] if k % 8 == 0 and f % 8 == 0 \
        else ["mma_sync"]


def phase_swiglu_kernels(torch, sw, gpu):
    """The fused SwiGLU kernel against its twin in f32 and bf16, in each
    variant, then its times at each path's shape in bf16 (what the prefill
    steps run): one kernel-table row for each; then the decode shapes."""
    results = _swiglu_twin_checks(
        torch, sw, SWIGLU_CASES + list(SWIGLU_PATHS.values()) + SWIGLU_EXTRA)
    emit({"phase": "kernels", "ok": True, "kernel": "fused_swiglu",
          "checked": len(results),
          "worst": {vr: max(r["max_abs_err"] for r in results
                            if r["variant"] == vr) for vr in sw.VARIANTS},
          "results": results})
    rows = [_swiglu_times(torch, sw, gpu, case, path)
            for path, case in SWIGLU_PATHS.items()]
    for path, case in SWIGLU_DECODE.items():
        _swiglu_times(torch, sw, gpu, case, path)
    torch.cuda.empty_cache()
    return rows


def _swiglu_twin_checks(torch, sw, cases, phase="swiglu_kernels"):
    """Each case in f32 and bf16, in each variant, against the twin within
    ``TOL``, the wrapper's choice checked; the results, one per run."""
    results = []
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            ins = _swiglu_inputs(torch, case, dtype, seed=len(results))
            variants = swiglu_variants(case, name)
            chosen = sw.variant_for(*ins)
            check(chosen == variants[0], phase,
                  f"{case} {name}: the wrapper chose {chosen}")
            want = sw.fused_swiglu_plain(*ins)
            for variant in variants:
                got = sw._launch(*ins, variant)
                torch.cuda.synchronize()
                ok, err = _compare(got, want, **TOL[name])
                check(ok and bool(got.isfinite().all()), phase,
                      f"{case} {name} {variant}: max_abs_err {err}")
                results.append({"case": list(case), "dtype": name,
                                "variant": variant, "max_abs_err": err,
                                "ok": ok})
                del got
            del ins, want
    return results


def _swiglu_times(torch, sw, gpu, case, path):
    """Times at one shape, bf16: the kernel the wrapper chooses, the PR 14
    design (mma.sync, forced), the plain twin and the cuBLAS yardstick, in
    turns, in this call."""
    x, wg, wu = _swiglu_inputs(torch, case, torch.bfloat16, seed=321)
    variant = sw.variant_for(x, wg, wu)
    out = sw.fused_swiglu(x, wg, wu)
    want = sw.fused_swiglu_plain(x, wg, wu)
    _, err = _compare(out, want, **TOL["bfloat16"])
    # yardstick: the two products as one cuBLAS call on [Wg | Wu]; no
    # single PyTorch call computes the fused function
    w_cat = torch.cat([wg, wu], dim=-1)
    ms, prev_ms, library_ms = _in_turns(torch, [
        (lambda: sw.fused_swiglu(x, wg, wu), 20),
        (lambda: sw._launch(x, wg, wu, "mma_sync"), 20),
        (lambda: torch.matmul(x, w_cat), 20)])
    plain_ms = _median_ms(torch, lambda: sw.fused_swiglu_plain(x, wg, wu),
                          reps=5)
    bound_ms, bound_by, flops, nbytes = swiglu_bound(case, "bfloat16")
    emit({"phase": "kernel_times", "ok": True, "gpu": gpu,
          "kernel": "fused_swiglu", "path": path,
          "shape": dict(zip("e m k f".split(), case)), "dtype": "bfloat16",
          "variant": variant, "kernel_ms": ms, "prev_ms": prev_ms,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "library_note": "torch.matmul(x, [Wg | Wu]): the two products "
                          "only, no epilogue",
          "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
          "bytes": nbytes, "kernel_tflops": flops / ms / 1e9,
          "prev_tflops": flops / prev_ms / 1e9,
          "library_tflops": flops / library_ms / 1e9,
          "roofline_share": bound_ms / ms, "speedup_vs_prev": prev_ms / ms})
    del x, wg, wu, out, want, w_cat
    return {"name": "fused_swiglu", "route": "cuda", "variant": variant,
            "source": "src/repro_torch/kernels/fused_swiglu/csrc/"
                      + sw.SOURCES[variant].name,
            "replaces": "src/repro/kernels/fused_swiglu/kernel.py:56",
            "path": f"{path}, prefill step", "shape": list(case),
            "launches": 0, "max_abs_err": err, "ms": ms,
            "prev_ms": prev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# 3. full-width prefill step
# ---------------------------------------------------------------------------

def phase_prefill(torch, fa, sw, gpu):
    """Returns the (flash, SwiGLU) launches of one counted prefill step."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model
    from repro_torch.train.step import make_prefill_step

    base = ARCHS["llama3.2-3b"]
    cfg = dataclasses.replace(base, attention_impl="pallas")
    b, s = 2, 4096
    g = torch.Generator("cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g, device="cuda")
    batch = {"tokens": tokens}

    model = build_model(cfg)
    params = model.init(0)
    step = make_prefill_step(model)
    step(params, batch)                         # warm-up (cuBLAS, build)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero(fa, sw)                               # counted main-path run
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, sw_launches = fa.LAUNCHES, sw.LAUNCHES
    by_variant = {"flash": dict(fa.LAUNCHES_BY_VARIANT),
                  "swiglu": dict(sw.LAUNCHES_BY_VARIANT)}
    check(_only(fa, "wgmma", cfg.n_layers), "prefill",
          f"flash launches {by_variant['flash']}, expected {cfg.n_layers} "
          "wgmma")
    check(_only(sw, "wgmma", cfg.n_layers), "prefill",
          f"SwiGLU launches {by_variant['swiglu']}, expected "
          f"{cfg.n_layers} wgmma")
    check(logits.shape == (b, s, 128256) and bool(logits.isfinite().all()),
          "prefill", f"logits {tuple(logits.shape)} not finite")
    times = [first_s]
    for _ in range(2):
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    STEP_S["llama3.2-3b prefill"] = step_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    arg_kernel = logits[..., :cfg.vocab].argmax(-1)
    del logits

    naive = build_model(dataclasses.replace(cfg, attention_impl="naive"))
    logits_plain = naive.forward(params, batch)
    agree = (logits_plain[..., :cfg.vocab].argmax(-1) == arg_kernel) \
        .float().mean().item()
    del logits_plain, params, arg_kernel
    torch.cuda.empty_cache()
    emit({"phase": "prefill", "ok": True, "gpu": gpu, "arch": cfg.name,
          "batch": b, "seq": s, "dtype": cfg.dtype,
          "kernel_launches": launches, "swiglu_launches": sw_launches,
          "launches_by_variant": by_variant, "step_s": step_s,
          "step_times_s": times, "tokens_per_s": b * s / step_s,
          "peak_gb": peak_gb, "bf16_argmax_agreement_vs_plain": agree})

    # fp32 at full width: kernel path against the plain path, same weights
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(0)
    pos = [0, 511, s - 1]
    with torch.no_grad():
        a = model32.forward(params32, batch)[:, pos].float()
        ref = build_model(dataclasses.replace(cfg32, attention_impl="naive")) \
            .forward(params32, batch)[:, pos].float()
    rel = ((a - ref).abs().max() / ref.abs().max()).item()
    del params32, a, ref
    torch.cuda.empty_cache()
    ok = rel <= LOGITS_REL_TOL
    emit({"phase": "prefill_fp32_parity", "ok": ok, "positions": pos,
          "max_rel_err": rel, "tol": LOGITS_REL_TOL})
    check(ok, "prefill_fp32_parity", f"max_rel_err {rel}")
    return launches, sw_launches


# ---------------------------------------------------------------------------
# 4. generate through the server code
# ---------------------------------------------------------------------------

def phase_generate(torch, fa, sw, gpu):
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(ARCHS["llama3.2-3b"], attention_impl="pallas")
    model = build_model(cfg)
    params = model.init(0)
    n_req, plen, gen_tokens = 4, 512, 16
    g = torch.Generator("cuda").manual_seed(11)
    prompts = torch.randint(0, cfg.vocab, (n_req, plen), generator=g,
                            device="cuda")
    generate(model, params, prompts, 2)                   # warm-up
    _zero(fa, sw)
    out = generate(model, params, prompts, gen_tokens)
    launches = fa.LAUNCHES
    toks = out.tokens
    check(_only(sw, "wgmma", cfg.n_layers * (gen_tokens + 1)), "generate",
          f"SwiGLU launches {sw.LAUNCHES_BY_VARIANT} in the prefill and "
          f"{gen_tokens} decode steps")
    check(toks.shape == (n_req, gen_tokens)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "generate", f"tokens {tuple(toks.shape)} out of range")
    emit({"phase": "generate", "ok": True, "gpu": gpu, "requests": n_req,
          "prompt": plen, "gen_tokens": gen_tokens, "mode": out.mode,
          "prefill_ms": out.prefill_s * 1e3,
          "prefill_tokens_per_s": n_req * plen / out.prefill_s,
          "decode_ms": out.decode_s * 1e3,
          "decode_tokens_per_s": n_req * gen_tokens / out.decode_s,
          "kernel_launches": launches, "swiglu_launches": sw.LAUNCHES,
          "swiglu_launches_by_variant": sw.LAUNCHES_BY_VARIANT,
          "first_request_tokens": toks[0].tolist()})
    del params
    torch.cuda.empty_cache()

    # batched prefill == sequential decode fill (tests/test_serve.py:551),
    # full width in fp32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(0)
    b, short, max_seq = 2, 8, 16
    ids = prompts[:b, :short]
    with torch.no_grad():
        seq = model32.decode_init(b, max_seq)
        for t in range(short):
            l_seq, seq = model32.decode_fn(
                params32, seq, ids[:, t],
                torch.full((b,), t, dtype=torch.int32, device="cuda"))
        pre = model32.decode_init(b, max_seq)
        l_pre, pre = model32.prefill_fn(params32, pre, ids)
    rel = ((l_pre - l_seq).abs().max() / l_seq.abs().max()).item()
    cache_err = max((pre[n] - seq[n]).abs().max().item() for n in ("k", "v"))
    ok = rel <= LOGITS_REL_TOL and cache_err <= LOGITS_REL_TOL
    emit({"phase": "prefill_equals_sequential_fill", "ok": ok,
          "prompt": short, "dtype": "float32", "max_rel_err": rel,
          "cache_max_abs_err": cache_err, "tol": LOGITS_REL_TOL})
    check(ok, "prefill_equals_sequential_fill",
          f"max_rel_err {rel}, cache {cache_err}")



# ---------------------------------------------------------------------------
# 5-6. zamba2-7b: full-width prefill step and generate
# ---------------------------------------------------------------------------

def phase_zamba(torch, fa, ssd, sw, gpu):
    """Returns the (SSD, flash, SwiGLU) launches of one counted prefill
    step."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    from repro_torch.models.zamba import layout
    from repro_torch.train.step import make_prefill_step

    cfg = dataclasses.replace(ARCHS["zamba2-7b"], attention_impl="pallas")
    n_groups, _ = layout(cfg)
    b, s = 2, 4096
    g = torch.Generator("cuda").manual_seed(13)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                     device="cuda")}
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(p.numel() * p.element_size()
                     for p in params.parameters()) / 1e9
    step = make_prefill_step(model)
    step(params, batch)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero(ssd, fa, sw)                          # counted main-path run
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    ssd_launches, flash_launches = ssd.LAUNCHES, fa.LAUNCHES
    sw_launches = sw.LAUNCHES
    by_variant = {"flash": dict(fa.LAUNCHES_BY_VARIANT),
                  "swiglu": dict(sw.LAUNCHES_BY_VARIANT)}
    check(_only(sw, "wgmma", n_groups), "zamba_prefill",
          f"SwiGLU launches {by_variant['swiglu']} for {n_groups} "
          "applications, expected all wgmma")
    by_variant["ssd"] = dict(ssd.LAUNCHES_BY_VARIANT)
    check(_only(ssd, "wgmma", cfg.n_layers), "zamba_prefill",
          f"SSD launches {by_variant['ssd']} for {cfg.n_layers} mamba "
          "layers, expected all wgmma")
    check(_only(fa, "wgmma", n_groups), "zamba_prefill",
          f"flash launches {by_variant['flash']} for {n_groups} "
          "applications, expected all wgmma")
    check(logits.shape == (b, s, 32000) and bool(logits.isfinite().all()),
          "zamba_prefill", f"logits {tuple(logits.shape)} not finite")
    for _ in range(2):
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    STEP_S["zamba2-7b prefill"] = step_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del logits
    emit({"phase": "zamba_prefill", "ok": True, "gpu": gpu,
          "arch": cfg.name, "layers": cfg.n_layers, "groups": n_groups,
          "batch": b, "seq": s, "dtype": cfg.dtype,
          "logits_shape": [b, s, 32000], "ssd_launches": ssd_launches,
          "flash_launches": flash_launches, "swiglu_launches": sw_launches,
          "launches_by_variant": by_variant, "init_s": init_s,
          "weights_gb": weights_gb, "step_s": step_s, "step_times_s": times,
          "tokens_per_s": b * s / step_s, "peak_gb": peak_gb})

    n_req, plen, gen_tokens = 4, 128, 16
    prompts = torch.randint(0, cfg.vocab, (n_req, plen), generator=g,
                            device="cuda")
    generate(model, params, prompts[:, :4], 2)           # warm-up
    _zero(ssd, fa, sw)
    out = generate(model, params, prompts, gen_tokens)
    toks = out.tokens
    check(out.mode == "sequential", "zamba_generate", f"mode {out.mode}")
    check(toks.shape == (n_req, gen_tokens)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "zamba_generate", f"tokens {tuple(toks.shape)} out of range")
    emit({"phase": "zamba_generate", "ok": True, "gpu": gpu,
          "requests": n_req, "prompt": plen, "gen_tokens": gen_tokens,
          "mode": out.mode, "prefill_ms": out.prefill_s * 1e3,
          "prefill_tokens_per_s": n_req * plen / out.prefill_s,
          "decode_ms": out.decode_s * 1e3,
          "decode_tokens_per_s": n_req * gen_tokens / out.decode_s,
          "ssd_launches": ssd.LAUNCHES, "flash_launches": fa.LAUNCHES,
          "swiglu_launches": sw.LAUNCHES,
          "first_request_tokens": toks[0].tolist()})
    del params
    torch.cuda.empty_cache()
    return ssd_launches, flash_launches, sw_launches


# ---------------------------------------------------------------------------
# 7. zamba2-7b fp32: kernel path on the card against the plain path
# ---------------------------------------------------------------------------

def phase_zamba_fp32_parity(torch, fa, ssd, sw):
    """Full width, depth 7 (one group of 6 mamba layers + the shared block,
    then one tail layer), S = 640 > block_q so the flash kernel runs and
    the last of three SSD chunks is ragged.  The plain path is the same
    weights on the CPU, where every kernel wrapper runs its plain twin."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model
    from repro_torch.models.zamba import layout

    cfg = dataclasses.replace(ARCHS["zamba2-7b"], attention_impl="pallas",
                              dtype="float32", n_layers=7)
    expected = {"ssd": cfg.n_layers, "flash": layout(cfg)[0],
                "swiglu": layout(cfg)[0]}
    model = build_model(cfg)
    params = model.init(0)
    g = torch.Generator("cuda").manual_seed(17)
    tokens = torch.randint(0, cfg.vocab, (1, 640), generator=g,
                           device="cuda")
    _zero(ssd, fa, sw)
    with torch.no_grad():
        got = model.forward(params, {"tokens": tokens}).cpu()
    launches = {"ssd": ssd.LAUNCHES, "flash": fa.LAUNCHES,
                "swiglu": sw.LAUNCHES}
    check(launches == expected and _only(fa, "simt", expected["flash"])
          and _only(sw, "simt", expected["swiglu"])
          and _only(ssd, "wgmma", expected["ssd"]), "zamba_fp32_parity",
          f"kernel launches {launches}, expected {expected}: SSD all wgmma "
          f"{ssd.LAUNCHES_BY_VARIANT}, flash and SwiGLU all fp32 (simt) "
          f"{fa.LAUNCHES_BY_VARIANT} {sw.LAUNCHES_BY_VARIANT}")
    params_cpu = copy.deepcopy(params).to("cpu")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.no_grad():
        want = model.forward(params_cpu, {"tokens": tokens.cpu()})
    cpu_s = time.perf_counter() - t0
    rel = ((got - want).abs().max() / want.abs().max()).item()
    ok = rel <= LOGITS_REL_TOL and bool(got.isfinite().all())
    emit({"phase": "zamba_fp32_parity", "ok": ok, "layers": cfg.n_layers,
          "batch": 1, "seq": 640, "kernel_launches": launches,
          "max_rel_err": rel, "tol": LOGITS_REL_TOL,
          "plain_path_cpu_s": cpu_s})
    check(ok, "zamba_fp32_parity", f"max_rel_err {rel}")


# ---------------------------------------------------------------------------
# 8-9. xlstm-1.3b: full-width prefill step and generate
# ---------------------------------------------------------------------------

def phase_xlstm(torch, ml, gpu):
    """Returns the mLSTM kernel launches of one counted prefill step."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import padded_vocab, xlstm_layout
    from repro_torch.train.step import make_prefill_step

    cfg = ARCHS["xlstm-1.3b"]
    n_groups, per = xlstm_layout(cfg)
    vocab = padded_vocab(cfg)
    b, s = 2, 4096
    g = torch.Generator("cuda").manual_seed(19)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                     device="cuda")}
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(p.numel() * p.element_size()
                     for p in params.parameters()) / 1e9
    step = make_prefill_step(model)
    # no separate warm-up: the kernel phases built and launched the mLSTM
    # kernel already, and the median of the three steps below drops a
    # slower first one (a step is ~10 s, host-bound by the sLSTM loops)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero(ml)                                   # counted main-path run
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    launches = ml.LAUNCHES
    by_variant = dict(ml.LAUNCHES_BY_VARIANT)
    check(_only(ml, "wgmma", n_groups * per), "xlstm_prefill",
          f"mLSTM launches {ml.LAUNCHES_BY_VARIANT} for {n_groups * per} "
          "mLSTM blocks, expected all wgmma")
    check(logits.shape == (b, s, vocab) and bool(logits.isfinite().all()),
          "xlstm_prefill", f"logits {tuple(logits.shape)} not finite")
    del logits
    for _ in range(2):
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    STEP_S["xlstm-1.3b prefill"] = step_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "xlstm_prefill", "ok": True, "gpu": gpu,
          "arch": cfg.name, "layers": cfg.n_layers,
          "mlstm_blocks": n_groups * per, "slstm_blocks": n_groups,
          "batch": b, "seq": s, "dtype": cfg.dtype,
          "logits_shape": [b, s, vocab], "mlstm_launches": launches,
          "mlstm_launches_by_variant": by_variant,
          "init_s": init_s, "weights_gb": weights_gb, "step_s": step_s,
          "step_times_s": times, "tokens_per_s": b * s / step_s,
          "peak_gb": peak_gb})

    n_req, plen, gen_tokens = 4, 128, 16
    prompts = torch.randint(0, cfg.vocab, (n_req, plen), generator=g,
                            device="cuda")
    generate(model, params, prompts[:, :4], 2)           # warm-up
    _zero(ml)
    out = generate(model, params, prompts, gen_tokens)
    toks = out.tokens
    check(out.mode == "sequential", "xlstm_generate", f"mode {out.mode}")
    check(toks.shape == (n_req, gen_tokens)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "xlstm_generate", f"tokens {tuple(toks.shape)} out of range")
    emit({"phase": "xlstm_generate", "ok": True, "gpu": gpu,
          "requests": n_req, "prompt": plen, "gen_tokens": gen_tokens,
          "mode": out.mode, "prefill_ms": out.prefill_s * 1e3,
          "prefill_tokens_per_s": n_req * plen / out.prefill_s,
          "decode_ms": out.decode_s * 1e3,
          "decode_tokens_per_s": n_req * gen_tokens / out.decode_s,
          "mlstm_launches": ml.LAUNCHES,
          "first_request_tokens": toks[0].tolist()})
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 10. xlstm-1.3b fp32: kernel path on the card against the plain path
# ---------------------------------------------------------------------------

def phase_xlstm_fp32_parity(torch, ml):
    """Full width, depth 8 (one group: 7 mLSTM blocks and the sLSTM block),
    S = 640: three mLSTM chunks of 256, the last ragged.  The plain path is
    the same weights on the CPU, where the kernel wrapper runs its twin."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import xlstm_layout

    cfg = dataclasses.replace(ARCHS["xlstm-1.3b"], dtype="float32",
                              n_layers=8)
    n_groups, per = xlstm_layout(cfg)
    model = build_model(cfg)
    params = model.init(0)
    g = torch.Generator("cuda").manual_seed(23)
    tokens = torch.randint(0, cfg.vocab, (1, 640), generator=g,
                           device="cuda")
    _zero(ml)
    with torch.no_grad():
        got = model.forward(params, {"tokens": tokens}).cpu()
    launches = ml.LAUNCHES
    check(n_groups * per == 7 and _only(ml, "wgmma", 7), "xlstm_fp32_parity",
          f"mLSTM launches {ml.LAUNCHES_BY_VARIANT}, expected 7 wgmma")
    params_cpu = copy.deepcopy(params).to("cpu")
    t0 = time.perf_counter()
    with torch.no_grad(), _block_inputs() as cpu_inputs:
        want = model.forward(params_cpu, {"tokens": tokens.cpu()})
    cpu_s = time.perf_counter() - t0
    rel = ((got - want).abs().max() / want.abs().max()).item()
    blocks = _xlstm_block_errs(torch, ml, cfg, model, params, params_cpu,
                               tokens, cpu_inputs)
    del params
    torch.cuda.empty_cache()
    ok = rel <= LOGITS_REL_TOL and bool(got.isfinite().all())
    emit({"phase": "xlstm_fp32_parity", "ok": ok, "layers": cfg.n_layers,
          "batch": 1, "seq": 640, "mlstm_launches": launches,
          "max_rel_err": rel, "tol": LOGITS_REL_TOL,
          "plain_path_cpu_s": cpu_s, "blocks": blocks})
    check(ok, "xlstm_fp32_parity", f"max_rel_err {rel}")


@contextlib.contextmanager
def _block_inputs():
    """Each xLSTM block's input in a forward, in order: yields the list of
    ("mlstm" or "slstm", its index among its kind, the input)."""
    from repro_torch.models import transformer

    real = {"mlstm": transformer._mlstm_block,
            "slstm": transformer._slstm_block}
    found = []

    def spy(kind):
        def block(cfg, p, x):
            n = sum(1 for f in found if f[0] == kind)
            found.append((kind, n, x.detach().clone()))
            return real[kind](cfg, p, x)
        return block

    transformer._mlstm_block = spy("mlstm")
    transformer._slstm_block = spy("slstm")
    try:
        yield found
    finally:
        transformer._mlstm_block = real["mlstm"]
        transformer._slstm_block = real["slstm"]


def _xlstm_block_errs(torch, ml, cfg, model, params, params_cpu, tokens,
                      cpu_inputs):
    """Where the depth-8 fp32 logits' distance between the card and the
    CPU comes from, block by block (max|a-b| / max|b| of each mixer's
    output, the residual taken off): from the card run's own input, the
    mLSTM kernel against its plain twin on the card (the kernel's error)
    and the twin on the card against the CPU (the other ops' devices);
    and how far apart the two runs' inputs to the block already are.  In
    the forward the normaliser max(|n|, exp(-m)) is continuous, so a
    branch that the two runs take differently moves no value (C.3's
    pinning is for the backward)."""
    from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
    from repro_torch.models import transformer

    with torch.no_grad(), _block_inputs() as card_inputs:
        model.forward(params, {"tokens": tokens})

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return ((a - b).abs().max() / b.abs().max()).item()

    out = []
    for (kind, i, x), (_, _, x_cpu) in zip(card_inputs, cpu_inputs):
        fn = getattr(transformer, f"_{kind}_block")
        p, p_cpu = (getattr(params, f"{kind[0]}blocks")[i],
                    getattr(params_cpu, f"{kind[0]}blocks")[i])
        with torch.no_grad():
            mixer = fn(cfg, p, x) - x
            twin = mixer
            if kind == "mlstm":
                kernel = mlstm_ops.mlstm_chunk
                mlstm_ops.mlstm_chunk = ml.mlstm_chunk_plain
                try:
                    twin = fn(cfg, p, x) - x
                finally:
                    mlstm_ops.mlstm_chunk = kernel
            x_c = x.cpu()
            on_cpu = fn(cfg, p_cpu, x_c) - x_c
        out.append({"block": f"{kind} {i}", "input_rel": rel(x, x_cpu),
                    "kernel_vs_twin": rel(mixer, twin)
                    if kind == "mlstm" else None,
                    "card_vs_cpu": rel(twin, on_cpu)})
    return out


# ---------------------------------------------------------------------------
# 11-12. granite-moe-1b-a400m: full-width prefill step and generate
# ---------------------------------------------------------------------------

def phase_granite(torch, fa, sw, gpu):
    """Returns the (flash, SwiGLU) launches of one counted prefill step."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.train.step import make_prefill_step

    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"],
                              attention_impl="pallas")
    vocab = padded_vocab(cfg)
    b, s = 2, 4096
    g = torch.Generator("cuda").manual_seed(29)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                     device="cuda")}
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == GRANITE_PARAMS, "granite_prefill",
          f"{n_params} parameters, not {GRANITE_PARAMS}")
    weights_gb = sum(p.numel() * p.element_size()
                     for p in params.parameters()) / 1e9
    step = make_prefill_step(model)
    step(params, batch)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero(fa, sw)                               # counted main-path run
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    flash_launches, sw_launches = fa.LAUNCHES, sw.LAUNCHES
    by_variant = {"flash": dict(fa.LAUNCHES_BY_VARIANT),
                  "swiglu": dict(sw.LAUNCHES_BY_VARIANT)}
    check(_only(fa, "wgmma", cfg.n_layers), "granite_prefill",
          f"flash launches {by_variant['flash']} for {cfg.n_layers} "
          "layers, expected all wgmma")
    check(_only(sw, "wgmma", cfg.n_layers), "granite_prefill",
          f"SwiGLU launches {by_variant['swiglu']} for {cfg.n_layers} MoE "
          "layers, expected all wgmma")
    check(logits.shape == (b, s, vocab) and bool(logits.isfinite().all()),
          "granite_prefill", f"logits {tuple(logits.shape)} not finite")
    del logits
    for _ in range(2):
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    STEP_S["granite-moe-1b-a400m prefill"] = step_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "granite_prefill", "ok": True, "gpu": gpu,
          "arch": cfg.name, "layers": cfg.n_layers,
          "experts": cfg.n_experts, "top_k": cfg.top_k, "batch": b,
          "seq": s, "dtype": cfg.dtype, "logits_shape": [b, s, vocab],
          "flash_launches": flash_launches, "swiglu_launches": sw_launches,
          "launches_by_variant": by_variant, "params": n_params, "init_s": init_s, "weights_gb": weights_gb,
          "step_s": step_s, "step_times_s": times,
          "tokens_per_s": b * s / step_s, "peak_gb": peak_gb})

    n_req, plen, gen_tokens = 4, 512, 16
    prompts = torch.randint(0, cfg.vocab, (n_req, plen), generator=g,
                            device="cuda")
    generate(model, params, prompts, 2)                   # warm-up
    _zero(fa, sw)
    out = generate(model, params, prompts, gen_tokens)
    toks = out.tokens
    check(out.mode == "batched", "granite_generate", f"mode {out.mode}")
    check(_only(sw, "wgmma", cfg.n_layers * (gen_tokens + 1)),
          "granite_generate",
          f"SwiGLU launches {sw.LAUNCHES_BY_VARIANT} in the prefill and "
          f"{gen_tokens} decode steps")
    check(toks.shape == (n_req, gen_tokens)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "granite_generate", f"tokens {tuple(toks.shape)} out of range")
    emit({"phase": "granite_generate", "ok": True, "gpu": gpu,
          "requests": n_req, "prompt": plen, "gen_tokens": gen_tokens,
          "mode": out.mode, "prefill_ms": out.prefill_s * 1e3,
          "prefill_tokens_per_s": n_req * plen / out.prefill_s,
          "decode_ms": out.decode_s * 1e3,
          "decode_tokens_per_s": n_req * gen_tokens / out.decode_s,
          "flash_launches": fa.LAUNCHES, "swiglu_launches": sw.LAUNCHES,
          "swiglu_launches_by_variant": sw.LAUNCHES_BY_VARIANT,
          "first_request_tokens": toks[0].tolist()})
    del params
    torch.cuda.empty_cache()
    return flash_launches, sw_launches


# ---------------------------------------------------------------------------
# 13. granite-moe-1b-a400m fp32: kernel path on the card against the plain
# path, the routing compared exactly
# ---------------------------------------------------------------------------

def phase_granite_fp32_parity(torch, fa, sw):
    """Full width, depth 4, S = 640 > block_q so the flash kernel runs; one
    dispatch group of 640 tokens, capacity 200 per expert.  The plain path
    is the same weights on the CPU, where every wrapper runs its twin.
    Each layer's top-k mask is recorded on both paths and compared: a
    flipped expert choice would change a token's output by O(1)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import moe
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"],
                              attention_impl="pallas", dtype="float32",
                              n_layers=4)
    model = build_model(cfg)
    params = model.init(0)
    g = torch.Generator("cuda").manual_seed(31)
    tokens = torch.randint(0, cfg.vocab, (1, 640), generator=g,
                           device="cuda")
    masks = []
    top_k_mask = moe._top_k_mask

    def recorded(probs, k):
        mask, weights = top_k_mask(probs, k)
        masks.append(mask.cpu())
        return mask, weights

    moe._top_k_mask = recorded
    try:
        _zero(fa, sw)
        with torch.no_grad():
            got = model.forward(params, {"tokens": tokens}).cpu()
        launches = {"flash": fa.LAUNCHES, "swiglu": sw.LAUNCHES}
        fp32_only = _only(fa, "simt", cfg.n_layers) and \
            _only(sw, "simt", cfg.n_layers)
        params_cpu = copy.deepcopy(params).to("cpu")
        del params
        torch.cuda.empty_cache()
        card_masks, masks = masks, []
        t0 = time.perf_counter()
        with torch.no_grad():
            want = model.forward(params_cpu, {"tokens": tokens.cpu()})
        cpu_s = time.perf_counter() - t0
    finally:
        moe._top_k_mask = top_k_mask
    expected = {"flash": cfg.n_layers, "swiglu": cfg.n_layers}
    check(launches == expected and fp32_only, "granite_fp32_parity",
          f"kernel launches {launches}, expected {expected}, all fp32 "
          "(simt)")
    flipped = [int((a != b).any(-1).sum()) for a, b in zip(card_masks, masks)]
    rel = ((got - want).abs().max() / want.abs().max()).item()
    ok = (rel <= LOGITS_REL_TOL and bool(got.isfinite().all())
          and len(card_masks) == len(masks) == cfg.n_layers
          and not any(flipped))
    emit({"phase": "granite_fp32_parity", "ok": ok, "layers": cfg.n_layers,
          "batch": 1, "seq": 640, "kernel_launches": launches,
          "tokens_with_flipped_experts_per_layer": flipped,
          "max_rel_err": rel, "tol": LOGITS_REL_TOL,
          "plain_path_cpu_s": cpu_s})
    check(ok, "granite_fp32_parity",
          f"max_rel_err {rel}, flipped expert choices per layer {flipped}")


# ---------------------------------------------------------------------------
# 14. bf16: the card path (wgmma kernels) against the plain path
# ---------------------------------------------------------------------------

# depth of each model for the bf16 check: one group of zamba2-7b (6 mamba
# layers + the shared block, then a tail layer) and of xlstm-1.3b (7 mLSTM
# blocks + the sLSTM block)
BF16_PARITY = {"llama3.2-3b": 2, "zamba2-7b": 7, "granite-moe-1b-a400m": 4,
               "xlstm-1.3b": 8}
# xlstm-1.3b's gated bf16 comparison is per mLSTM block (these three): its
# logits at depth 8 move by ~0.1 normwise between two correct fp32 mLSTM
# implementations (its twin and the simt kernel, both on the card), so the
# model-level number is reported beside the same number for the twin
XLSTM_BF16_BLOCKS = (0, 3, 6)
# max|a-b| / max|b|: the CPU bf16 model tests' normwise bound (bf16 rounds
# after each op in another order on the card: the wgmma kernels keep P and
# h in bf16, cuBLAS and the CPU sum in other orders)
BF16_REL_TOL = 2e-2


def bf16_launches(cfg):
    """{kernel: launches} of one forward of ``cfg``: all wgmma in bf16."""
    from repro_torch.models.transformer import xlstm_layout
    from repro_torch.models.zamba import layout

    if cfg.family == "hybrid":
        groups = layout(cfg)[0]
        return {"ssd": cfg.n_layers, "flash": groups, "swiglu": groups}
    if cfg.family == "ssm":
        groups, per = xlstm_layout(cfg)
        return {"mlstm": groups * per}
    return {"flash": cfg.n_layers, "swiglu": cfg.n_layers}


def phase_bf16_parity(torch, fa, ssd, ml, sw):
    """Each model at full width and reduced depth (``BF16_PARITY``) in
    bf16, S = 640 > block_q so flash runs and the last SSD or mLSTM chunk
    is ragged: the logits of the card path, every kernel launch under its
    wgmma variant, against the plain path (the same weights on the CPU,
    where every wrapper runs its twin), normwise within ``BF16_REL_TOL``.
    granite-moe's routing: the CPU path replays the card's expert choices,
    so the logits compare the arithmetic, and the choices the CPU path
    would have made differently are counted.  xlstm-1.3b is gated per mLSTM
    block (``XLSTM_BF16_BLOCKS``, the block's output at full width and
    S = 640); its logits are reported beside those of the same card path
    with the mLSTM kernel's plain twin in its place."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
    from repro_torch.models import moe, xlstm
    from repro_torch.models.model import build_model

    mods = {"flash": fa, "ssd": ssd, "mlstm": ml, "swiglu": sw}
    results = []
    top_k_mask = moe._top_k_mask
    for arch, depth in BF16_PARITY.items():
        cfg = dataclasses.replace(ARCHS[arch], attention_impl="pallas",
                                  dtype="bfloat16", n_layers=depth)
        model = build_model(cfg)
        params = model.init(0)
        g = torch.Generator("cuda").manual_seed(37)
        tokens = torch.randint(0, cfg.vocab, (1, 640), generator=g,
                               device="cuda")
        card_masks, cpu_masks = [], []
        replay = []              # set once the card path has run

        def recorded(probs, k):
            mask, weights = top_k_mask(probs, k)
            if not replay:
                card_masks.append(mask.cpu())
                return mask, weights
            card = card_masks[len(cpu_masks)].to(mask.dtype)
            cpu_masks.append(mask)
            w = probs * card
            return card, w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)

        moe._top_k_mask = recorded
        try:
            _zero(*mods.values())
            with torch.no_grad():
                got = model.forward(params, {"tokens": tokens}).float().cpu()
            launches = {n: dict(m.LAUNCHES_BY_VARIANT)
                        for n, m in mods.items()}
            expected = bf16_launches(cfg)
            launches_ok = all(_only(m, "wgmma", expected.get(n, 0))
                              for n, m in mods.items())
            params_cpu = copy.deepcopy(params).to("cpu")
            if cfg.family == "ssm":
                twin_got = _with_mlstm_twin(
                    torch, mlstm_ops, ml,
                    lambda: model.forward(params, {"tokens": tokens}))
                layer_rels = _xlstm_layer_rels(torch, xlstm, cfg, params,
                                               params_cpu)
            del params
            torch.cuda.empty_cache()
            replay.append(True)
            t0 = time.perf_counter()
            with torch.no_grad():
                want = model.forward(params_cpu,
                                     {"tokens": tokens.cpu()}).float()
            cpu_s = time.perf_counter() - t0
        finally:
            moe._top_k_mask = top_k_mask
        rel = ((got - want).abs().max() / want.abs().max()).item()
        flipped = [int((a != b).any(-1).sum())
                   for a, b in zip(card_masks, cpu_masks)]
        row = {"arch": arch, "layers": depth, "seq": 640,
               "launches_by_variant": launches, "expected": expected,
               "max_rel_err": rel, "tol": BF16_REL_TOL,
               "plain_path_cpu_s": cpu_s}
        if cfg.family == "moe":
            row["tokens_with_flipped_experts_per_layer"] = flipped
        gated = rel
        if cfg.family == "ssm":
            row["logits_gated"] = False
            row["mlstm_twin_on_card_max_rel_err"] = (
                (twin_got - want).abs().max() / want.abs().max()).item()
            row["kernel_vs_twin_on_card_max_rel_err"] = (
                (got - twin_got).abs().max() / twin_got.abs().max()).item()
            row["mlstm_block_max_rel_err"] = dict(zip(
                map(str, XLSTM_BF16_BLOCKS), layer_rels))
            gated = max(layer_rels)
        results.append(row)
        del params_cpu, got, want
        check(launches_ok, "bf16_parity",
              f"{arch}: kernel launches {launches}, expected {expected} "
              "all wgmma")
        check(gated <= BF16_REL_TOL, "bf16_parity",
              f"{arch}: max_rel_err {gated} ({row})")
    emit({"phase": "bf16_parity", "ok": True, "results": results})


# ---------------------------------------------------------------------------
# 15-16. the paper's path: LayerGraph -> compile_plan -> replay -> grads
# ---------------------------------------------------------------------------

def _graph_batch(torch, g, batch, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    shape = (batch,) + tuple(g.input_shape)
    if any(l.kind == "embedding" for l in g.layers):
        x = torch.randint(0, 50, shape, generator=gen, device="cuda")
    else:
        x = torch.randn(shape, generator=gen, device="cuda")
    y = torch.randn((batch,) + tuple(g.label_shape), generator=gen,
                    device="cuda")
    if g.layers[-1].kind == "loss_ce":
        y = torch.nn.functional.one_hot(
            y.argmax(-1), y.shape[-1]).to(torch.float32)
    return x, y


def _grad_errs(torch, got, want):
    """(elementwise within GRAD_TOL, max abs err, max normwise err) over
    every gradient tensor."""
    ok = sorted(got) == sorted(want) and all(
        sorted(got[k]) == sorted(want[k]) for k in want)
    max_abs = max_rel = 0.0
    for k in want:
        for n, b in want[k].items():
            a = got[k][n]
            err = (a - b).abs()
            top = b.abs().max().item()
            ok &= bool((err <= GRAD_TOL["atol"] * max(1.0, top)
                        + GRAD_TOL["rtol"] * b.abs()).all())
            e = err.max().item()
            max_abs = max(max_abs, e)
            max_rel = max(max_rel, e / top if top else e)
    return ok, max_abs, max_rel


def _max_abs_err(got, want):
    return max((got[k][n].double() - b.double()).abs().max().item()
               for k in want for n, b in want[k].items())


def _fp64_grads(torch, reference_loss_and_grads, g, params, x, y):
    """The exact gradients' stand-in: autograd over the graph in fp64."""
    params = {k: {n: v.double() for n, v in p.items()}
              for k, p in params.items()}
    if x.is_floating_point():
        x = x.double()
    return reference_loss_and_grads(g, params, x, y.double())[1]


def _timed_step(torch, cp, params, x, y, executor):
    """One replay: (loss, grads, stats, wall s, allocator peak over what was
    allocated before it, parameters and inputs among that)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads, stats = cp.loss_and_grads(params, x, y, executor=executor)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return loss, grads, stats, wall, torch.cuda.max_memory_allocated() - base


def _paper_row(graph, backend, plan, cp, stats, wall, loss, **extra):
    """One row of the paper path's table (floats to 4 significant
    digits: the line must fit the end of the output)."""
    def r(v):
        return float(f"{v:.4g}") if isinstance(v, float) else v
    row = {"graph": graph, "backend": backend, "plan": plan,
           "step_s": wall, "loss": float(loss),
           "swap_outs": stats.swap_outs, "dma_bytes": stats.dma_bytes,
           "hbm_high_water": stats.hbm_high_water,
           "late_swap_ins": stats.late_swap_ins, "fences": stats.fences,
           "stalled_fences": stats.stalled_fences,
           "achieved_overlap": stats.achieved_overlap,
           "hidden_dma_s": stats.hidden_dma_s,
           "exposed_dma_s": stats.exposed_dma_s,
           "inflight_high_water": stats.inflight_high_water,
           "peak_inflight_prefetch": stats.peak_inflight_prefetch, **extra}
    return {k: r(v) for k, v in row.items()}


def phase_paper_zoo(torch, gpu):
    from repro_torch.core.exec.layers import reference_loss_and_grads
    from repro_torch.core.plan import MemoryPlanConfig, compile_plan
    from repro_torch.core.zoo import ZOO

    rows = []
    timed = None
    t_phase = time.perf_counter()
    for i, name in enumerate(sorted(ZOO)):
        g = ZOO[name]()
        cp = compile_plan(g, MemoryPlanConfig(**PAPER_EXEC),
                          batch=PAPER_ZOO_BATCH)
        params = cp.init_params(torch.Generator("cuda").manual_seed(i))
        x, y = _graph_batch(torch, g, PAPER_ZOO_BATCH, 100 + i)
        ref_loss, ref_grads = reference_loss_and_grads(g, params, x, y)
        exact = _fp64_grads(torch, reference_loss_and_grads, g, params, x, y)
        ref_err_fp64 = _max_abs_err(ref_grads, exact)
        got = {}
        for backend in ("sim", "async"):
            loss, grads, stats, wall, _ = _timed_step(
                torch, cp, params, x, y, backend)
            ok, max_abs, max_rel = _grad_errs(torch, grads, ref_grads)
            loss_err = abs(loss.item() - ref_loss.item())
            where = f"{name} on {backend}"
            check(stats.replayed_ops == cp.lowered.ops, "paper_zoo",
                  f"{where}: the replay left the compiled op list")
            check(stats.late_swap_ins == 0, "paper_zoo",
                  f"{where}: {stats.late_swap_ins} late swap-ins")
            check(stats.hbm_high_water <= cp.plan.activation_residency_peak(),
                  "paper_zoo", f"{where}: high water {stats.hbm_high_water} "
                  "over the planned residency peak")
            # the lowered transfers' bytes: cp.dma_bytes also counts the
            # swaps of S: scratch tensors, which stay plan-level (no op)
            lowered_dma = sum(op.nbytes for op in cp.lowered.transfers())
            check(stats.dma_bytes == lowered_dma, "paper_zoo",
                  f"{where}: {stats.dma_bytes} DMA bytes, lowered "
                  f"{lowered_dma}")
            check(ok and max_rel <= GRAD_NORM_TOL
                  and loss_err <= 1e-4 * abs(ref_loss.item()) + 1e-5,
                  "paper_zoo", f"{where}: grads max abs err {max_abs} "
                  f"(normwise {max_rel}), loss err {loss_err}")
            got[backend] = stats
            rows.append(_paper_row(name, backend, "swap", cp, stats, wall,
                                   loss, grad_err=max_abs,
                                   grad_norm_err=max_rel,
                                   grad_err_fp64=_max_abs_err(grads, exact),
                                   ref_grad_err_fp64=ref_err_fp64))
        for field in PAIRED_STATS:
            check(getattr(got["sim"], field) == getattr(got["async"], field),
                  "paper_zoo", f"{name}: {field} differs between sim "
                  f"({getattr(got['sim'], field)}) and async "
                  f"({getattr(got['async'], field)})")
        del grads
        backend = _zoo_jit(torch, name, cp, params, x, y, exact,
                           got["async"], rows)
        if name == "resnet18_transfer":
            timed = _zoo_in_turns(torch, cp, params, x, y, backend)
        del params, ref_grads, exact, backend
        torch.cuda.empty_cache()
    emit({"phase": "paper_zoo", "ok": True, "gpu": gpu,
          "graphs": len(ZOO), "batch": PAPER_ZOO_BATCH,
          "transfers": sum(2 * r["swap_outs"] for r in rows
                           if r["backend"] == "async"),
          "dispatch_calls": {r["graph"]: [r["dispatch_calls"],
                                          r["lowered_ops"]]
                             for r in rows if r["backend"] == "jit_blocks"},
          "resnet18_transfer_in_turns": timed,
          "wall_s": time.perf_counter() - t_phase})
    return rows


def _jit_checks(torch, phase, where, cp, stats):
    """What a jit_blocks replay answers for beside the replay's own gates:
    the op list's ops, in an order the dependence prover signed, exactly
    the fused stream of the fusion plan, in fewer dispatches than ops."""
    from collections import Counter

    from repro_torch.core.planner import SwapAwarePlan
    from repro_torch.core.verify import (plan_fusion, replay_stream,
                                         schedules_equivalent)
    plan = cp.plan if isinstance(cp.plan, SwapAwarePlan) else None
    fusion = plan_fusion(cp.lowered, cp.ordered, plan)
    check(Counter(stats.replayed_ops) == Counter(cp.lowered.ops), phase,
          f"{where}: the replayed ops are not the op list's")
    proof = schedules_equivalent(cp.lowered, stats.replayed_ops,
                                 ordered=cp.ordered, plan=plan)
    check(proof.ok, phase, f"{where}: the replay breaks a dependence edge")
    check(stats.replayed_ops == replay_stream(cp.lowered, fusion), phase,
          f"{where}: the replay is not the fusion plan's stream")
    check(stats.dispatch_calls == fusion.dispatch_calls()
          < len(cp.lowered.ops), phase,
          f"{where}: {stats.dispatch_calls} dispatches for "
          f"{len(cp.lowered.ops)} ops (fusion plan "
          f"{fusion.dispatch_calls()})")
    check(stats.late_swap_ins == 0, phase,
          f"{where}: {stats.late_swap_ins} late swap-ins")
    return fusion


def _clone_grads(grads):
    return {k: {n: t.clone() for n, t in e.items()} for k, e in grads.items()}


def _zoo_jit(torch, name, cp, params, x, y, exact, async_stats, rows):
    """Two jit_blocks steps from the same params, cuDNN deterministic:
    step 1 captures every block, step 2 captures none and gives step 1's
    loss and grads bit for bit.  Then SGD in place and a third step, which
    replays over the new values.  Each is held to autograd under the same
    cuDNN algorithms (the default backward-filter algorithms sum in
    another order, which moves resnet18's weight grads past the
    elementwise gate, though not the normwise one).  Returns the backend
    (its graphs kept)."""
    from repro_torch.core.exec.backends import JitBlocksBackend
    from repro_torch.core.exec.layers import (reference_loss_and_grads,
                                              sgd_update_)

    backend = JitBlocksBackend()
    where = f"{name} on jit_blocks"
    runs = []
    with _cudnn_deterministic(torch):
        ref_loss, ref_grads = reference_loss_and_grads(cp.graph, params, x,
                                                       y)
        for step in (1, 2):
            loss, grads, stats, wall, _ = _timed_step(
                torch, cp, params, x, y, backend)
            fusion = _jit_checks(torch, "paper_zoo", f"{where} step {step}",
                                 cp, stats)
            n_blocks = len(fusion.blocks)
            check(stats.graph_captures == (n_blocks if step == 1 else 0)
                  and stats.graph_replays == n_blocks, "paper_zoo",
                  f"{where} step {step}: {stats.graph_captures} captures, "
                  f"{stats.graph_replays} replays of {n_blocks} blocks")
            runs.append((loss.clone(), _clone_grads(grads), stats, wall))
    (loss, grads, stats, wall), (loss2, grads2, stats2, wall2) = runs
    ok, max_abs, max_rel = _grad_errs(torch, grads, ref_grads)
    loss_err = abs(loss.item() - ref_loss.item())
    check(ok and max_rel <= GRAD_NORM_TOL
          and loss_err <= 1e-4 * abs(ref_loss.item()) + 1e-5, "paper_zoo",
          f"{where}: grads max abs err {max_abs} (normwise {max_rel}), "
          f"loss err {loss_err}")
    check(stats.hbm_high_water <= cp.plan.activation_residency_peak(),
          "paper_zoo", f"{where}: high water {stats.hbm_high_water} over "
          "the planned residency peak")
    lowered_dma = sum(op.nbytes for op in cp.lowered.transfers())
    check(stats.dma_bytes == lowered_dma, "paper_zoo",
          f"{where}: {stats.dma_bytes} DMA bytes, lowered {lowered_dma}")
    check(torch.equal(loss, loss2) and all(
        torch.equal(grads[k][n], grads2[k][n]) for k in grads
        for n in grads[k]), "paper_zoo",
        f"{where}: the replayed step 2 differs from step 1")
    for field in PAIRED_STATS:
        check(getattr(stats, field) == getattr(async_stats, field),
              "paper_zoo", f"{where}: {field} {getattr(stats, field)}, "
              f"async {getattr(async_stats, field)}")
    sgd_update_(params, grads2, lr=1e-3)
    with _cudnn_deterministic(torch):
        loss3, grads3, stats3, _, _ = _timed_step(torch, cp, params, x, y,
                                                  backend)
        want_loss, want = reference_loss_and_grads(cp.graph, params, x, y)
    ok3, abs3, rel3 = _grad_errs(torch, grads3, want)
    check(stats3.graph_captures == 0 and ok3 and rel3 <= GRAD_NORM_TOL
          and abs(loss3.item() - want_loss.item())
          <= 1e-4 * abs(want_loss.item()) + 1e-5, "paper_zoo",
          f"{where} step 3 (params moved in place): "
          f"{stats3.graph_captures} captures, grads max abs err {abs3} "
          f"(normwise {rel3})")
    report = backend.report()
    rows.append(_paper_row(
        name, "jit_blocks", "swap", cp, stats, wall, loss, grad_err=max_abs,
        grad_norm_err=max_rel, grad_err_fp64=_max_abs_err(grads, exact),
        dispatch_calls=stats.dispatch_calls,
        lowered_ops=len(cp.lowered.ops),
        graph_captures=stats.graph_captures, replay_step_s=wall2,
        arena_bytes=report["arena_bytes"],
        graph_pool_bytes=backend.graph_pool_bytes(),
        arena_copy_bytes=stats.arena_copy_bytes, step3_grad_err=abs3,
        arena_write_wait_s=stats2.arena_write_wait_s))
    return backend


def _steps_in_turns(torch, runs, rounds):
    """``rounds`` rounds of one step of each entry of ``runs`` (name ->
    (compiled plan, params, x, y, executor)), in turns (ABBA); the step
    walls by name, each after the card's work."""
    names = list(runs)
    walls = {k: [] for k in names}
    for i in range(rounds):
        for k in names[::(-1) ** i]:
            cp, params, x, y, executor = runs[k]
            *_, wall, _ = _timed_step(torch, cp, params, x, y, executor)
            walls[k].append(wall)
    return walls


def _zoo_in_turns(torch, cp, params, x, y, jit):
    """resnet18_transfer's async and jit_blocks (graphs captured) steps in
    turns: the walls and their medians."""
    from repro_torch.core.exec.backends import AsyncDeviceBackend

    asy = AsyncDeviceBackend()
    _timed_step(torch, cp, params, x, y, asy)      # pins its host pool
    walls = _steps_in_turns(torch, {"async": (cp, params, x, y, asy),
                                    "jit_blocks": (cp, params, x, y, jit)},
                            JIT_TIMED_ROUNDS)
    med = {k: statistics.median(w) for k, w in walls.items()}
    return {"step_s": walls, "median_step_s": med,
            "jit_over_async": med["jit_blocks"] / med["async"]}


def _trunk_jit(torch, plan, cp, params, x, y, ref_loss, ref_grads, rows):
    """TRUNK_STEPS jit_blocks steps of the trunk under ``cp`` with in-place
    SGD from a copy of ``params`` (so steps 2+ replay): step 1's grads and
    loss against autograd, the jit gates at every step, no capture after
    step 1.  The device memory is counted from before the backend's first
    allocation, by ``memory_reserved``: the arena and the gradient buffers
    are allocated once and the graphs' private pool keeps its segments
    reserved, where ``memory_allocated`` loses the pool's transients once
    their capture ends.  ``steady_reserved_bytes`` is the peak over steps
    2+, after the cache emptied of step 1's warm-ups."""
    from repro_torch.core.exec.backends import JitBlocksBackend
    from repro_torch.core.exec.layers import sgd_update_

    where = f"jit_blocks, {plan} plan"
    p = {k: {n: w.clone() for n, w in e.items()} for k, e in params.items()}
    backend = JitBlocksBackend()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    base_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, out = [], [], {}
    for step in range(1, TRUNK_STEPS + 1):
        t0 = time.perf_counter()
        loss, grads, stats = cp.loss_and_grads(p, x, y, executor=backend)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        fusion = _jit_checks(torch, "paper_trunk", f"{where} step {step}",
                             cp, stats)
        n_blocks = len(fusion.blocks)
        check(stats.graph_captures == (n_blocks if step == 1 else 0)
              and stats.graph_replays == n_blocks, "paper_trunk",
              f"{where} step {step}: {stats.graph_captures} captures, "
              f"{stats.graph_replays} replays of {n_blocks} blocks")
        extra = {}
        if step == 1:
            ok, max_abs, max_rel = _grad_errs(torch, grads, ref_grads)
            check(ok and max_rel <= GRAD_NORM_TOL
                  and abs(loss.item() - ref_loss.item())
                  <= 1e-4 * abs(ref_loss.item()), "paper_trunk",
                  f"{where}: step-1 grads max abs err {max_abs}, normwise "
                  f"{max_rel}, loss {loss.item()} against "
                  f"{ref_loss.item()}")
            extra = dict(grad_err=max_abs, grad_norm_err=max_rel)
            out.update(
                step1_reserved_bytes=torch.cuda.max_memory_reserved() - base,
                step1_allocated_bytes=torch.cuda.max_memory_allocated()
                - base_alloc,
                graph_pool_bytes=backend.graph_pool_bytes(),
                blocks=n_blocks, dispatch_calls=stats.dispatch_calls,
                lowered_ops=len(cp.lowered.ops),
                arena_bytes=backend.report()["arena_bytes"],
                planned_peak_bytes=cp.peak_bytes,
                arena_copy_bytes=stats.arena_copy_bytes)
        losses.append(loss.item())
        rows.append(_paper_row("transformer_mlp_stack", "jit_blocks", plan,
                               cp, stats, walls[-1], loss, step=step,
                               dispatch_calls=stats.dispatch_calls,
                               graph_captures=stats.graph_captures,
                               arena_write_wait_s=stats.arena_write_wait_s,
                               **extra))
        out.setdefault("arena_write_wait_s", []).append(
            stats.arena_write_wait_s)
        sgd_update_(p, grads)
        del grads
        if step == 1:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    out.update(steady_reserved_bytes=torch.cuda.max_memory_reserved() - base,
               steady_allocated_bytes=torch.cuda.max_memory_allocated()
               - base_alloc,
               losses=losses, step_s=walls)
    check(all(math.isfinite(v) for v in losses), "paper_trunk",
          f"{where}: SGD losses {losses}")
    del backend, p
    torch.cuda.empty_cache()
    return out


def phase_paper_trunk(torch, gpu):
    from repro_torch.core.exec.backends import (AsyncDeviceBackend,
                                                JitBlocksBackend)
    from repro_torch.core.exec.layers import (reference_loss_and_grads,
                                              sgd_update)
    from repro_torch.core.plan import MemoryPlanConfig, compile_plan
    from repro_torch.core.zoo import transformer_mlp_stack

    g = transformer_mlp_stack()
    t0 = time.perf_counter()
    cp = compile_plan(g, MemoryPlanConfig(), batch=TRUNK_BATCH)
    cp_flat = compile_plan(g, MemoryPlanConfig(swap=False), batch=TRUNK_BATCH)
    compile_s = time.perf_counter() - t0
    params = cp.init_params(torch.Generator("cuda").manual_seed(5))
    x, y = _graph_batch(torch, g, TRUNK_BATCH, 6)
    # He init doubles the variance through each up/down pair (the down
    # projection has no activation), 2^28 over the trunk: inputs at std
    # 2^-14 reach the MSE head at unit scale, so SGD steps stay finite
    n_pairs = sum(l.kind == "linear" for l in g.layers) // 2
    x = x * 2.0 ** (-n_pairs / 2)
    ref_loss, ref_grads = reference_loss_and_grads(g, params, x, y)
    torch.cuda.empty_cache()
    rows = []

    def held(where, plan, stats, grads, loss):
        ok, max_abs, max_rel = _grad_errs(torch, grads, ref_grads)
        check(stats.replayed_ops == plan.lowered.ops, "paper_trunk",
              f"{where}: the replay left the compiled op list")
        check(stats.late_swap_ins == 0, "paper_trunk",
              f"{where}: {stats.late_swap_ins} late swap-ins")
        check(ok and max_rel <= GRAD_NORM_TOL, "paper_trunk",
              f"{where}: step-1 grads max abs err {max_abs}, normwise "
              f"{max_rel}")
        check(abs(loss.item() - ref_loss.item())
              <= 1e-4 * abs(ref_loss.item()), "paper_trunk",
              f"{where}: loss {loss.item()} against {ref_loss.item()}")
        return dict(grad_err=max_abs, grad_norm_err=max_rel)

    # the no-swap plan (after one untimed warm-up step), then sim, then
    # async: step 1 from the same params
    cp_flat.loss_and_grads(params, x, y, executor="async")
    loss, grads, stats, wall, flat_peak = _timed_step(
        torch, cp_flat, params, x, y, "async")
    errs = held("no-swap plan", cp_flat, stats, grads, loss)
    rows.append(_paper_row("transformer_mlp_stack", "async", "no_swap",
                           cp_flat, stats, wall, loss, step=1,
                           measured_peak_bytes=flat_peak, **errs))
    del grads
    loss, grads, stats, wall, sim_peak = _timed_step(
        torch, cp, params, x, y, "sim")
    errs = held("sim", cp, stats, grads, loss)
    rows.append(_paper_row("transformer_mlp_stack", "sim", "swap", cp, stats,
                           wall, loss, step=1, measured_peak_bytes=sim_peak,
                           **errs))
    del grads
    torch.cuda.empty_cache()
    # jit_blocks from the same params: the no-swap plan, then the swapped
    jit = {plan: _trunk_jit(torch, plan, plan_cp, params, x, y, ref_loss,
                            ref_grads, rows)
           for plan, plan_cp in (("no_swap", cp_flat), ("swap", cp))}
    jit_saved = jit["no_swap"]["steady_reserved_bytes"] \
        - jit["swap"]["steady_reserved_bytes"]

    backend = AsyncDeviceBackend()     # keeps its pinned pool across steps
    t0 = time.perf_counter()
    backend.make_engine(x.device).reserve(cp.host_pool_bytes)
    pin_s = time.perf_counter() - t0
    losses = []
    swap_peak = None
    for step in range(1, TRUNK_STEPS + 1):
        loss, grads, stats, wall, peak = _timed_step(
            torch, cp, params, x, y, backend)
        extra = {}
        if step == 1:
            swap_peak = peak
            extra = held("async", cp, stats, grads, loss)
            del ref_grads
        check(stats.replayed_ops == cp.lowered.ops
              and stats.late_swap_ins == 0, "paper_trunk",
              f"async step {step}: replay {stats.late_swap_ins} late")
        losses.append(loss.item())
        rows.append(_paper_row("transformer_mlp_stack", "async", "swap", cp,
                               stats, wall, loss, step=step,
                               measured_peak_bytes=peak, **extra))
        params = sgd_update(params, grads)
        del grads
    # one step's wall time spreads by tens of percent between steps, so
    # the swapped and the no-swap plan are compared by the medians of
    # steps taken in turns from the same params (ABBA order)
    walls = {"swap": [], "no_swap": []}
    last = {}
    for i in range(TRUNK_TIMED_ROUNDS):
        order = (("swap", cp, backend), ("no_swap", cp_flat, "async"))
        for plan, plan_cp, executor in order[::(-1) ** i]:
            loss, grads, stats, wall, _ = _timed_step(
                torch, plan_cp, params, x, y, executor)
            check(stats.replayed_ops == plan_cp.lowered.ops
                  and stats.late_swap_ins == 0, "paper_trunk",
                  f"timed {plan} step: {stats.late_swap_ins} late")
            walls[plan].append(wall)
            last[plan] = (plan_cp, stats, loss)
            del grads
    medians = {plan: statistics.median(w) for plan, w in walls.items()}
    for plan, (plan_cp, stats, loss) in last.items():
        rows.append(_paper_row("transformer_mlp_stack", "async", plan,
                               plan_cp, stats, medians[plan], loss,
                               step=f"median of {TRUNK_TIMED_ROUNDS}"))
    # the swapped plan on async and on jit_blocks (its graphs captured by
    # one untimed step at these params), in turns
    jit_backend = JitBlocksBackend()
    _timed_step(torch, cp, params, x, y, jit_backend)
    jit_walls = _steps_in_turns(
        torch, {"async": (cp, params, x, y, backend),
                "jit_blocks": (cp, params, x, y, jit_backend)},
        TRUNK_TIMED_ROUNDS)
    jit_medians = {k: statistics.median(w) for k, w in jit_walls.items()}
    del jit_backend
    # the replays recompute: jit_blocks' in-place SGD losses follow async's
    for plan in jit:
        check(all(abs(a - b) <= 1e-4 * abs(b) for a, b in
                  zip(jit[plan]["losses"], losses, strict=True)),
              "paper_trunk", f"jit_blocks {plan} plan SGD losses "
              f"{jit[plan]['losses']}, async {losses}")
    saved = flat_peak - swap_peak
    ok = saved >= cp.hbm_bytes_saved / 2 \
        and jit_saved >= cp.hbm_bytes_saved / 2 \
        and all(math.isfinite(v) for v in losses)
    emit({"phase": "paper_trunk", "ok": ok, "gpu": gpu,
          "batch": TRUNK_BATCH,
          "layers": sum(l.kind == "linear" for l in g.layers) // 2,
          "dtype": "float32",
          "tf32": False, "compile_s": compile_s,
          "planned_peak_bytes": cp.peak_bytes,
          "planned_no_swap_peak_bytes": cp_flat.peak_bytes,
          "planned_hbm_bytes_saved": cp.hbm_bytes_saved,
          "host_pool_bytes": cp.host_pool_bytes, "dma_bytes": cp.dma_bytes,
          "measured_peak_bytes": swap_peak,
          "measured_no_swap_peak_bytes": flat_peak,
          "measured_sim_peak_bytes": sim_peak,
          "measured_bytes_saved": saved, "pool_pin_s": pin_s,
          "losses": losses, "timed_step_s": walls,
          "median_step_s": medians,
          "swap_over_no_swap": medians["swap"] / medians["no_swap"],
          "jit_blocks": jit, "jit_measured_bytes_saved": jit_saved,
          "jit_timed_step_s": jit_walls, "jit_median_step_s": jit_medians,
          "jit_over_async": jit_medians["jit_blocks"]
          / jit_medians["async"]})
    check(all(math.isfinite(v) for v in losses), "paper_trunk",
          f"SGD losses {losses}")
    check(ok, "paper_trunk",
          f"measured peak fell by {saved} bytes on async, {jit_saved} on "
          f"jit_blocks, under half the planned {cp.hbm_bytes_saved}")
    del params, x, y
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the paper's personalization service: offloaded AdamW, multi-tenant serving
# ---------------------------------------------------------------------------

def _host_rss_bytes() -> int:
    """Resident host memory of this process (``/proc/self/status``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _param_diff(a, b):
    return max((a[k][n] - b[k][n]).abs().max().item()
               for k in b for n in b[k])


def _param_max(a):
    return max(v.abs().max().item() for e in a.values() for v in e.values())


def _optim_step(torch, cp, params, x, y, backend, step):
    """One replay that also runs ``step`` (an ``OffloadedStep``) at the
    plan's optimizer ops: (loss, grads, stats, wall s, allocator peak over
    what was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads, stats = cp.loss_and_grads(params, x, y, executor=backend,
                                           optim=step)
    torch.cuda.synchronize()
    return (loss, grads, stats, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def _resident_step(torch, cp, params, x, y, backend, opt, state):
    """A replay with no optimizer ops, then the resident AdamW update under
    the same allocator window: (loss, grads, new params, new state, replay
    s, update s, peak over what was allocated before it, the resident
    moments counted although they were allocated before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() - _tensor_bytes(torch, state)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads, _ = cp.loss_and_grads(params, x, y, executor=backend)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if state is None:
        state = opt.init(params)
    new, state = opt.update(grads, state, params)
    torch.cuda.synchronize()
    return (loss, grads, new, state, t1 - t0, time.perf_counter() - t1,
            torch.cuda.max_memory_allocated() - base)


def _tensor_bytes(torch, tree):
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(torch, v) for v in tree.values())
    return 0


def phase_paper_optim(torch, gpu):
    """The trunk fine-tuned with AdamW three ways from the same params and
    grads: resident moments on the card, and offloaded with int8 or fp32
    host copies, updated inside the replay at the plan's optimizer ops (the
    replay moves the runtime's own host copies).  At the reference's lr
    the trunk diverges, so a second lr, at which the resident loss falls,
    gives the drift in fine-tuning.  At that lr the fp32 offload also runs
    on jit_blocks, held to the same gates."""
    from repro_torch.core.exec.backends import (AsyncDeviceBackend,
                                                JitBlocksBackend)
    from repro_torch.core.exec.layers import reference_loss_and_grads
    from repro_torch.core.plan import MemoryPlanConfig, compile_plan
    from repro_torch.core.zoo import transformer_mlp_stack

    g = transformer_mlp_stack()
    t0 = time.perf_counter()
    plans = {"compressed": compile_plan(
        g, MemoryPlanConfig(optim_offload=True), batch=TRUNK_BATCH),
        "uncompressed": compile_plan(
            g, MemoryPlanConfig(optim_offload=True, optim_compress=False),
            batch=TRUNK_BATCH)}
    cp_res = compile_plan(g, MemoryPlanConfig(), batch=TRUNK_BATCH)
    compile_s = time.perf_counter() - t0
    params = cp_res.init_params(torch.Generator("cuda").manual_seed(5),
                                device="cuda")
    x, y = _graph_batch(torch, g, TRUNK_BATCH, 6)
    x = x * 2.0 ** (-(sum(l.kind == "linear" for l in g.layers) // 2) / 2)
    ref = reference_loss_and_grads(g, params, x, y)
    backend = AsyncDeviceBackend()
    rows, summary = [], {}
    for lr in TRUNK_LRS:
        # the last lr runs the fp32 offload on jit_blocks too
        jit = JitBlocksBackend() if lr == TRUNK_LRS[-1] else None
        summary[lr] = _optim_lr(torch, g, plans, cp_res, params, x, y, lr,
                                backend, ref, rows, jit=jit)
        ref = None
        del jit
    cp = plans["compressed"]
    emit({"phase": "paper_optim", "ok": True, "gpu": gpu,
          "batch": TRUNK_BATCH, "slots": len(cp.optim_plan.slots),
          "compile_s": compile_s, "optim": cp.optim_plan.summary(),
          "by_lr": {str(lr): v for lr, v in summary.items()}})
    del params, x, y, backend
    torch.cuda.empty_cache()
    return rows


def _optim_lr(torch, g, plans, cp_res, params, x, y, lr, backend, ref,
              rows, jit=None):
    """TRUNK_STEPS steps at ``lr``, the three optimizers side by side, with
    their gates; returns the summary.  ``ref`` (autograd's loss and grads
    at ``params``) gates the first replay's grads when given.  ``jit`` (a
    jit_blocks backend) adds a fourth: the fp32 offload replayed there."""
    from repro_torch.core.optim_offload import OffloadedStep, OptimRuntime
    from repro_torch.optim.optimizers import adamw

    where = f"paper_optim lr {lr}"
    opt_plan = plans["compressed"].optim_plan
    n_slots = len(opt_plan.slots)
    t0 = time.perf_counter()
    plan_of = dict(plans)
    backend_of = dict.fromkeys(plans, backend)
    if jit is not None:
        plan_of["jit_uncompressed"] = plans["uncompressed"]
        backend_of["jit_uncompressed"] = jit
    runtimes = {kind: OptimRuntime(cp.optim_plan, g, lr=lr, device="cuda")
                for kind, cp in plan_of.items()}
    runtime_init_s = time.perf_counter() - t0
    opt = adamw(lr=lr)
    res_p, state = params, None
    off_p = dict.fromkeys(runtimes, params)
    updates = []
    for step in range(1, TRUNK_STEPS + 1):
        update = {"phase": "paper_optim", "lr": lr, "step": step}
        for kind, rt in runtimes.items():
            cp = plan_of[kind]
            before = dict(rt.timings)
            ostep = OffloadedStep(rt, off_p[kind])
            loss, grads, stats, wall, peak = _optim_step(
                torch, cp, res_p, x, y, backend_of[kind], ostep)
            off_p[kind] = ostep.new_params
            if backend_of[kind] is jit:
                _jit_checks(torch, where, f"{kind} step {step}", cp, stats)
            else:
                check(stats.replayed_ops == cp.lowered.ops
                      and stats.late_swap_ins == 0, where,
                      f"{kind} step {step}: the replay left the compiled "
                      "op list")
            check(stats.opt_prefetches == stats.opt_swap_outs == n_slots
                  and stats.opt_fences == n_slots
                  and stats.opt_dma_bytes
                  == cp.optim_plan.dma_bytes_per_step, where,
                  f"{kind} step {step}: {stats.opt_prefetches} opt "
                  f"prefetches, {stats.opt_swap_outs} swap-outs, "
                  f"{stats.opt_fences} fences, {stats.opt_dma_bytes} opt "
                  f"DMA bytes (planned {n_slots} slots, "
                  f"{cp.optim_plan.dma_bytes_per_step} B)")
            extra = {}
            if ref is not None and kind == "compressed" and step == 1:
                ok, max_abs, max_rel = _grad_errs(torch, grads, ref[1])
                check(ok and max_rel <= GRAD_NORM_TOL
                      and abs(loss.item() - ref[0].item())
                      <= 1e-4 * abs(ref[0].item()), where,
                      f"step-1 grads max abs err {max_abs}, normwise "
                      f"{max_rel}")
                extra = dict(grad_err=max_abs, grad_norm_err=max_rel)
            row = _paper_row(
                "transformer_mlp_stack", backend_of[kind].name,
                f"optim_offload_{kind}",
                cp, stats, wall, loss, lr=lr, step=step,
                measured_peak_bytes=peak, opt_fences=stats.opt_fences,
                opt_stalled_fences=stats.opt_stalled_fences,
                opt_hidden_dma_s=stats.opt_hidden_dma_s,
                opt_exposed_dma_s=stats.opt_exposed_dma_s, **extra)
            if kind in ("compressed", "jit_uncompressed"):
                rows.append(row)
            update[kind] = {"replay": row, "step_s": wall,
                            "step_peak_bytes": peak,
                            **{k: rt.timings[k] - before[k]
                               for k in rt.timings}}
            del grads, ostep
        loss, grads, new_res, state, replay_s, res_s, res_peak = \
            _resident_step(torch, cp_res, res_p, x, y, backend, opt, state)
        del grads
        update["resident"] = {"loss": loss.item(), "replay_s": replay_s,
                              "update_s": res_s,
                              "step_peak_bytes": res_peak}
        for kind in runtimes:
            update[kind]["err"] = _param_diff(off_p[kind], new_res)
        update["host_rss_bytes"] = _host_rss_bytes()
        # the resident step's own size, to weigh the drift against
        update["resident_step_max_abs"] = _param_diff(new_res, res_p)
        res_p = new_res
        del new_res
        if step == 1:
            check(update["compressed"]["err"] <= 1e-6, where,
                  f"step 1 compressed update {update['compressed']['err']} "
                  "from the resident AdamW (exact zero state: 1e-6)")
        updates.append(update)
        emit(update)
    errs = {k: _param_diff(off_p[k], res_p) for k in runtimes}
    # the step's allocator peak, activations, grads and the new params in
    # both: the resident one holds its moments throughout
    peaks = {"resident": max(u["resident"]["step_peak_bytes"]
                             for u in updates),
             "offloaded": max(u["compressed"]["step_peak_bytes"]
                              for u in updates)}
    saved = peaks["resident"] - peaks["offloaded"]
    want_saved = (opt_plan.resident_bytes - opt_plan.device_peak_bytes) / 2
    for kind in runtimes:
        rows.append({"graph": "transformer_mlp_stack",
                     "backend": backend_of[kind].name,
                     "plan": f"adamw_{kind}", "lr": lr,
                     "steps": TRUNK_STEPS,
                     "err_vs_resident": float(f"{errs[kind]:.4g}"),
                     "err_by_step": [float(f"{u[kind]['err']:.4g}")
                                     for u in updates],
                     "step_s": [float(f"{u[kind]['step_s']:.4g}")
                                for u in updates],
                     "resident_loss": [float(f"{u['resident']['loss']:.4g}")
                                       for u in updates]})
    out = {"runtime_init_s": runtime_init_s,
           "host_bytes": {k: rt.host_bytes for k, rt in runtimes.items()},
           "step_peak_bytes": peaks, "measured_saving_bytes": saved,
           "gate_saving_bytes": want_saved, "errs_vs_resident": errs,
           "drift_by_step": [u["compressed"]["err"] for u in updates],
           "resident_loss": [u["resident"]["loss"] for u in updates],
           "drift": {"max_abs": errs["compressed"],
                     "normwise_params": errs["compressed"]
                     / _param_max(res_p),
                     "in_resident_steps": errs["compressed"]
                     / updates[-1]["resident_step_max_abs"]}}
    for kind in ("uncompressed", "jit_uncompressed"):
        if kind in errs:
            check(errs[kind] <= 1e-5, where,
                  f"{kind} offload {errs[kind]} from the resident AdamW "
                  f"after {TRUNK_STEPS} steps (gate 1e-5)")
    check(errs["compressed"] <= 2e-2, where,
          f"compressed offload {errs['compressed']} from the resident "
          f"AdamW after {TRUNK_STEPS} steps (gate 2e-2)")
    check(saved >= want_saved, where,
          f"the step's allocator peak fell by {saved} bytes, under half "
          f"the planned {2 * want_saved}")
    del res_p, off_p, state, runtimes
    torch.cuda.empty_cache()
    return out


def _drive_service(torch, svc, g, traffic, kill=None):
    """Enqueue each wave of ``traffic`` ((user, n) pairs), drain it, and
    record per request: the grads applied, the trainable params they
    were taken at, the padded batch and the latency (enqueue to the
    update, on the host clock after the card's work); per wave its wall
    time and the scheduler's report."""
    from repro_torch.serve.buckets import dummy_batch, pad_to_bucket

    records = {}
    apply = svc.servable.apply_update

    def recording(sess, grads):
        rec = records[(sess.user, sess.step)]
        rec["done"] = time.perf_counter()
        rec["grads"] = {k: {n: v.clone() for n, v in e.items()}
                        for k, e in grads.items()}
        rec["params"] = {**svc.servable.base_params,
                         **{o: {n: v.clone() for n, v in e.items()}
                            for o, e in sess.params.items()}}
        apply(sess, grads)
    svc.servable.apply_update = recording
    results, walls, waves = [], [], []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for wave, users in enumerate(traffic):
        if kill is not None and wave == len(traffic) - 1:
            svc.injector.arm_kill(f"session:{kill}", after=1)
        reqs = []
        t0 = time.perf_counter()
        for i, (user, n) in enumerate(users):
            x, y = dummy_batch(g, n, seed=100 * wave + i, device="cuda")
            sess = svc.servable.sessions.get(user)
            step = sess.step if sess is not None else 0
            req = svc.enqueue(user, x, y)
            bucket = next(b for b in svc.buckets if n <= b)
            records[(user, step)] = {"req": req, "batch": pad_to_bucket(
                x, y, bucket)}
            reqs.append(req)
        svc.drain()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        results += [r.result for r in reqs]
        waves.append(svc.report().get("scheduler"))
    peak = torch.cuda.max_memory_allocated() - base
    svc.servable.apply_update = apply
    return records, results, walls, waves, peak


@contextlib.contextmanager
def _cudnn_deterministic(torch):
    """cuDNN's deterministic algorithms, as the service's drains use them:
    the default backward-filter algorithms may sum with atomics, so two
    runs of one step differ by ~sqrt(N) ulps (N = 65536 terms a resnet18
    weight at 64 rows of 32 x 32: ~1.5e-5 of the largest entry), where the
    elementwise gate sits."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def _timed_waves(torch, svcs, g, users, where):
    """SERVE_TIMED_ROUNDS waves of ``users`` ((user, n) pairs) drained by
    each service in ``svcs`` (mode -> service), in turns; the median wave
    wall per mode, on the host clock after the card's work."""
    from repro_torch.serve.buckets import dummy_batch
    walls = {mode: [] for mode in svcs}
    for r in range(SERVE_TIMED_ROUNDS):
        for mode, svc in svcs.items():
            for i, (user, n) in enumerate(users):
                svc.enqueue(user, *dummy_batch(g, n, seed=1000 + i,
                                               device="cuda"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = svc.drain()
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            check(all(res.ok for res in results), where,
                  f"timed round {r}, interleave={mode}: "
                  f"{[(res.user, res.status) for res in results]}")
    return {mode: statistics.median(w) for mode, w in walls.items()}


def _service_grads_gate(torch, phase, g, records):
    """Every applied step's grads against autograd over that session's
    merged params on its padded batch."""
    from repro_torch.core.exec.layers import reference_loss_and_grads
    worst = (0.0, 0.0)
    for (user, step), rec in records.items():
        if "grads" not in rec:
            continue
        xp, yp, mask = rec["batch"]
        with _cudnn_deterministic(torch):
            _, want = reference_loss_and_grads(g, rec["params"], xp, yp,
                                               mask=mask)
        ok, max_abs, max_rel = _grad_errs(torch, rec["grads"], want)
        check(ok and max_rel <= GRAD_NORM_TOL, phase,
              f"{user} step {step}: grads max abs err {max_abs}, "
              f"normwise {max_rel}")
        worst = (max(worst[0], max_abs), max(worst[1], max_rel))
    return worst


def _service_case(torch, gpu, name, g, *, buckets, users, config, steps,
                  sizes, kill=None, lr=0.05):
    """One service cell: an interleaved run (with a kill in an extra last
    wave), its gates, then the same traffic drained FIFO, compared."""
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.serve import PersonalizationService

    traffic = [[(f"u{u}", sizes[u % 2]) for u in range(users)]
               for _ in range(steps)]
    runs = {}
    for interleave in (True, False):
        svc = PersonalizationService(
            g, buckets=buckets, max_live_sessions=users, config=config,
            interleave=interleave, injector=FaultInjector(), lr=lr,
            device="cuda")
        t0 = time.perf_counter()
        svc.warmup()
        warm_s = time.perf_counter() - t0
        # the interleaved run takes one more wave, in which ``kill`` dies
        extra = [traffic[0]] if interleave and kill is not None else []
        runs[interleave] = (svc, warm_s) + _drive_service(
            torch, svc, g, traffic + extra,
            kill=kill if interleave else None)
    svc, warm_s, records, results, walls, waves, peak = runs[True]
    where = f"personalize {name}"
    served = results[:users * steps]
    for r in served:
        check(r.ok and math.isfinite(r.loss), where,
              f"{r.user}: {r.status} {r.reason} loss {r.loss}")
        check(r.peak_bytes <= r.arena_share_bytes, where,
              f"{r.user}: peak {r.peak_bytes} over its share "
              f"{r.arena_share_bytes}")
    rep = svc.report()
    for sched in waves:
        check(sched["verify_errors"] == 0 and sched["cross_hidden_clock"]
              == "device", where, f"scheduler {sched}")
    # the served waves' DMA split (the kill wave's is apart)
    dma = {k: sum(w[k] for w in waves[:steps])
           for k in ("cross_hidden_dma_s", "hidden_dma_s", "exposed_dma_s",
                     "opt_hidden_dma_s", "opt_exposed_dma_s")}
    # the reference's cache: one miss per bucket at warm-up, a hit for
    # every admitted request after it
    admitted = sum(r.status != "rejected" for r in results)
    want_cache = {"entries": len(buckets), "hits": admitted,
                  "misses": len(buckets),
                  "hit_rate": round(admitted / (admitted + len(buckets)), 4)}
    check(rep["plan_cache"] == want_cache, where,
          f"plan cache {rep['plan_cache']}, expected {want_cache}")
    killed = [r for r in results[users * steps:] if r.status == "killed"]
    if kill is not None:
        check(len(killed) == 1 and killed[0].user == kill
              and "released" in killed[0].reason
              and kill not in svc.admission.live
              and svc.admission.reserved_bytes
              == (users - 1) * svc.admission.arena_share_bytes
              and all(r.ok for r in results[users * steps:]
                      if r.user != kill), where,
              f"kill of {kill}: {[(r.user, r.status) for r in results]}")
    worst = _service_grads_gate(torch, where, g, records)
    lat = sorted(rec["done"] - rec["req"].enqueued_at
                 for rec in records.values() if "done" in rec)
    fifo_records, fifo_results, fifo_walls = runs[False][2:5]
    fifo_peak = runs[False][-1]
    check(all(r.ok for r in fifo_results), where, "FIFO run failed")
    _service_grads_gate(torch, where + " FIFO", g, fifo_records)
    # the same traffic drained both ways: every step's params and grads
    fifo_err = fifo_param_err = 0.0
    for (user, step), rec in fifo_records.items():
        mine = records.get((user, step), {})
        check("grads" in rec and "grads" in mine, where,
              f"{user} step {step}: applied in one drain only")
        ok, max_abs, max_rel = _grad_errs(torch, mine["grads"],
                                          rec["grads"])
        check(ok and max_rel <= GRAD_NORM_TOL, where,
              f"{user} step {step}: interleaved grads {max_abs} from "
              f"FIFO's (normwise {max_rel})")
        fifo_err = max(fifo_err, max_abs)
        fifo_param_err = max(fifo_param_err,
                             _param_diff(mine["params"], rec["params"]))
    check(len(fifo_records) == users * steps, where,
          f"FIFO applied {len(fifo_records)} steps of {users * steps}")
    done = users * steps
    wall = sum(walls[:steps])
    median = _timed_waves(torch, {m: run[0] for m, run in runs.items()}, g,
                          traffic[0], where)
    row = {"graph": name, "backend": "interleaved", "plan": "serve",
           "users": users, "buckets": list(buckets), "steps": done,
           "steps_per_s": users / median[True],
           "fifo_steps_per_s": users / median[False],
           "wave_s_median": median[True], "fifo_wave_s_median":
           median[False], "wall_s": wall, "fifo_wall_s": sum(fifo_walls),
           "p50_s": lat[len(lat) // 2],
           "p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
           **dma, "measured_peak_bytes": peak, "fifo_measured_peak_bytes":
           fifo_peak, "logical_peak_bytes": max(r.peak_bytes
                                                for r in served),
           "share_bytes": svc.admission.arena_share_bytes,
           "grad_err": worst[0], "grad_norm_err": worst[1],
           "fifo_grad_err": fifo_err, "fifo_param_err": fifo_param_err}
    emit({"phase": "personalize", "case": name, "ok": True, "gpu": gpu,
          "warmup_s": warm_s, "plan_cache": rep["plan_cache"],
          "waves": waves, "optim_offload": rep.get("optim_offload"),
          "killed": [(r.user, r.reason) for r in killed], **row})
    return svc, {k: float(f"{v:.4g}") if isinstance(v, float) else v
                 for k, v in row.items()}


def phase_personalize(torch, gpu):
    """The multi-tenant service on the card: (a) the reference's
    acceptance shape on resnet18_transfer, (b) resnet18 fully trainable
    with offloaded optimizer state.  The service runs its steps under
    cuDNN's deterministic algorithms, and autograd's grads that gate them
    are computed so too."""
    from repro_torch.core.plan import MemoryPlanConfig
    from repro_torch.core.zoo import ZOO

    _, row_a = _service_case(
        torch, gpu, "resnet18_transfer", ZOO["resnet18_transfer"](),
        buckets=(8, 16), users=8, steps=2, sizes=(14, 6), kill="u3",
        config=MemoryPlanConfig(executor="async", **PAPER_EXEC))
    svc, row_b = _service_case(
        torch, gpu, "resnet18", ZOO["resnet18"](), buckets=(64, 128),
        users=4, steps=2, sizes=(128, 40), lr=1e-3,
        config=MemoryPlanConfig(optim_offload=True, executor="async"))
    acct = svc.report()["optim_offload"]
    check(acct is not None and acct["share_bytes"]
          < acct["share_resident_bytes"]
          and acct["sessions_per_arena_x"] >= 1.0, "personalize",
          f"resnet18 optimizer-offload accounting {acct}")
    row_b["sessions_per_arena_x"] = acct["sessions_per_arena_x"]
    del svc
    torch.cuda.empty_cache()
    return [row_a, row_b]


def _with_mlstm_twin(torch, mlstm_ops, ml, forward):
    """``forward()`` with the mLSTM kernel's plain twin in its place, on the
    card (logits, on the CPU)."""
    kernel = mlstm_ops.mlstm_chunk
    mlstm_ops.mlstm_chunk = ml.mlstm_chunk_plain
    try:
        with torch.no_grad():
            return forward().float().cpu()
    finally:
        mlstm_ops.mlstm_chunk = kernel


def _xlstm_layer_rels(torch, xlstm, cfg, params, params_cpu):
    """max|a-b| / max|b| of each ``XLSTM_BF16_BLOCKS`` mLSTM block's output,
    the card (wgmma kernel) against the CPU (plain twin), on one seeded
    input of 640 rows at full width."""
    g = torch.Generator("cuda").manual_seed(41)
    x = torch.randn(1, 640, cfg.d_model, generator=g, device="cuda") \
        .to(torch.bfloat16)
    rels = []
    for blk in XLSTM_BF16_BLOCKS:
        with torch.no_grad():
            got = xlstm.mlstm_forward(cfg, params.mblocks[blk].mlstm, x)
            want = xlstm.mlstm_forward(cfg, params_cpu.mblocks[blk].mlstm,
                                       x.cpu()).float()
        rels.append(((got.float().cpu() - want).abs().max()
                     / want.abs().max()).item())
    return rels


# ---------------------------------------------------------------------------
# 19. train: llama3.2-3b trained at full width and depth
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "llama3.2-3b", "--shape", "train_4k", "--steps", "3",
              "--batch", "2", "--microbatches", "2"]
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4096, 2, 2, 3
# (b): the per-layer budget (bytes) and DMA price under which the plan
# offloads mlp_hidden at 4096 tokens and keeps the other three tags (the
# default prices, 32 GB/s against 200 TFLOP/s, recompute every eviction)
OFFLOAD_BUDGET, OFFLOAD_DMA_GBPS = 100_000_000, 1e4
TRAIN_FP32_DEPTH, TRAIN_FP32_SEQ = 4, 1024
TRAIN_FLASH_SHAPE = (1, 24, 8, 4096, 4096, 128, True, 512, 1024)
TRAIN_SWIGLU_SHAPE = (1, 4096, 3072, 8192)
GRAD_REL_TOL = 1e-4            # the paper's commit gate, normwise
RESUME_DEPTH, RESUME_VOCAB, RESUME_SEQ = 2, 4096, 1024


class _Counted:
    """A twin that counts its calls (the chip gates that no forward takes
    it; the SwiGLU backward recomputes through it)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


def _tagged_bytes(cfg, tokens, itemsize):
    """Bytes of each tensor the port tags in one dense block at ``tokens``
    tokens: q (the reference tags q alone as qkv), the attention output,
    the SwiGLU hidden h (one d_ff; the plan prices gate + up)."""
    return {"qkv": tokens * cfg.n_heads * cfg.head_dim * itemsize,
            "attn_out": tokens * cfg.n_heads * cfg.head_dim * itemsize,
            "mlp_hidden": tokens * cfg.d_ff * itemsize}


def _expected_launches(plan, layers, runs):
    """Per kernel: a forward launch in each block of each micro-batch run,
    and one more in the replay when the plan recomputes its output."""
    d = plan.remat_plan.decisions() if plan.remat_plan else {}
    again = {"flash": d.get("attn_out") == "recompute",
             "swiglu": d.get("mlp_hidden") == "recompute"}
    if plan.remat_plan is None:
        again = {"flash": False, "swiglu": False}
    return {k: layers * runs * (1 + int(v)) for k, v in again.items()}


def _region_gate(stats, kept, offloaded, input_bytes):
    """Every block saved exactly these tagged bytes and this input."""
    return all(s.kept == kept and s.offloaded == offloaded
               and s.input_bytes == input_bytes and s.replays == 1
               for s in stats)


def phase_train(torch, fa, sw, gpu):
    """(a)-(d) of the train phase; returns the (flash, SwiGLU) launches of
    (a), the main path."""
    import gc

    from repro_torch.core import remat
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import train as launch_train

    torch.cuda.empty_cache()
    twins = {"flash": _Counted(fa.flash_attention_fwd_plain),
             "swiglu": _Counted(sw.fused_swiglu_plain)}
    saved = fa.flash_attention_fwd_plain, sw.fused_swiglu_plain
    fa.flash_attention_fwd_plain = twins["flash"]
    sw.fused_swiglu_plain = twins["swiglu"]
    try:
        launches = _train_full(torch, fa, sw, gpu, launch_train, remat, twins)
    finally:
        fa.flash_attention_fwd_plain, sw.fused_swiglu_plain = saved
    gc.collect()
    torch.cuda.empty_cache()
    _train_fp32_parity(torch, fa, sw, flash_ops)
    gc.collect()
    torch.cuda.empty_cache()
    _train_resume(torch)
    return launches


def _train_full(torch, fa, sw, gpu, launch_train, remat, twins):
    """(a) ``launch.train`` at full width and depth, keep-all plan; (b) the
    same with mlp_hidden offloaded."""
    import gc

    from repro_torch.configs import ARCHS
    from repro_torch.core.plan import compile_plan
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.configs.base import SHAPES

    cfg = dataclasses.replace(ARCHS["llama3.2-3b"], attention_impl="pallas")
    micro_tokens = TRAIN_SEQ * TRAIN_BATCH // TRAIN_MICRO
    runs = TRAIN_STEPS * TRAIN_MICRO
    plan = compile_plan(cfg, batch_tokens=micro_tokens)
    tagged = _tagged_bytes(cfg, micro_tokens, 2)
    x_bytes = micro_tokens * cfg.d_model * 2

    # ---- (a) -----------------------------------------------------------
    _zero(fa, sw)
    twins["flash"].calls = twins["swiglu"].calls = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with remat.observe_regions() as stats:
        out = launch_train.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {"flash": fa.LAUNCHES, "swiglu": sw.LAUNCHES}
    twin_calls = {k: t.calls for k, t in twins.items()}
    variants = _only(fa, "wgmma", fa.LAUNCHES) and \
        _only(sw, "wgmma", sw.LAUNCHES)
    n_params = sum(p.numel() for p in out["params"].parameters())
    losses = [h["loss"] for h in out["history"]]
    times = [h["time_s"] for h in out["history"]]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    expected = _expected_launches(plan, cfg.n_layers, runs)
    step_s = statistics.median(times[1:])
    STEP_S["llama3.2-3b train"] = step_s
    tokens = TRAIN_SEQ * TRAIN_BATCH
    vocab_bytes = micro_tokens * cfg.vocab * (2 + 4)
    reckoned = {"params": 4 * n_params, "grads": 4 * n_params,
                "adamw_moments": 8 * n_params,
                "plan_saved_bytes_x_layers":
                    plan.remat_plan.saved_bytes_per_layer * cfg.n_layers,
                "measured_saved_bytes_x_layers":
                    (sum(tagged.values()) + x_bytes) * cfg.n_layers,
                "loss_logits_bf16_and_fp32": vocab_bytes}
    kept_ok = _region_gate(stats, tagged, {}, x_bytes) and \
        len(stats) == cfg.n_layers * runs
    ok = (all(math.isfinite(v) for v in losses)
          and abs(losses[0] - math.log(cfg.vocab)) <= 0.5
          and launches == expected and variants
          and twin_calls == {"flash": 0, "swiglu": cfg.n_layers * runs}
          and peak <= 80e9 and kept_ok)
    emit({"phase": "train", "part": "a", "ok": ok, "gpu": gpu,
          "command": "python -m repro_torch.launch.train "
                     + " ".join(TRAIN_ARGS),
          "layers": cfg.n_layers, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
          "microbatches": TRAIN_MICRO, "steps": TRAIN_STEPS,
          "params": n_params, "losses": losses, "ln_vocab": math.log(cfg.vocab),
          "step_s": times, "step_s_median_2_3": step_s,
          "tokens_per_s": tokens / step_s,
          "mfu_6nt": 6 * n_params * tokens / step_s
          / _peak_flops("bfloat16"),
          "peak_source": "NVIDIA H100 SXM data sheet, dense bf16, 989 "
                         "TFLOP/s at 700 W",
          "wall_s": wall, "peak_bytes": peak, "reckoned_bytes": reckoned,
          "plan_decisions": plan.remat_plan.decisions(),
          "plan_bytes_per_layer": {
              i.name: i.bytes_per_layer for i in _intermediates(cfg,
                                                                micro_tokens)},
          "measured_kept_bytes_per_layer": stats[0].kept if stats else None,
          "measured_input_bytes_per_layer":
              stats[0].input_bytes if stats else None,
          "kernel_launches": launches, "expected_launches": expected,
          "all_wgmma": variants, "twin_calls": twin_calls})
    check(ok, "train", f"(a) losses {losses}, launches {launches} vs "
          f"{expected}, twins {twin_calls}, peak {peak}, kept ok {kept_ok}")

    # ---- (b) -----------------------------------------------------------
    cfg_b = dataclasses.replace(cfg, offload=True,
                                remat_budget_bytes=OFFLOAD_BUDGET,
                                dma_gbps=OFFLOAD_DMA_GBPS)
    plan_b = compile_plan(cfg_b, batch_tokens=micro_tokens)
    decisions = plan_b.remat_plan.decisions()
    off_names = [n for n, d in decisions.items() if d == "offload"]
    check(bool(off_names), "train", f"(b) the plan offloads nothing: "
          f"{decisions}")
    grad_rel, worst = _offload_grads_gate(torch, cfg, cfg_b, micro_tokens,
                                          remat)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_BATCH)
    _zero(fa, sw)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with remat.observe_regions() as stats_b:
        out = Trainer(build_model(cfg_b), make_optimizer("adamw"), shape,
                      TrainerConfig(steps=TRAIN_STEPS, log_every=1),
                      microbatches=TRAIN_MICRO).run()
    torch.cuda.synchronize()
    peak_b = torch.cuda.max_memory_allocated() - base
    losses_b = [h["loss"] for h in out["history"]]
    times_b = [h["time_s"] for h in out["history"]]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    per_step = cfg.n_layers * TRAIN_MICRO
    fence_ms = [remat.fence_wait_ms(stats_b[i:i + per_step])
                for i in range(0, len(stats_b), per_step)]
    kept_b = {n: b for n, b in tagged.items() if decisions[n] == "keep"}
    off_b = {n: b for n, b in tagged.items() if decisions[n] == "offload"}
    off_layer = sum(off_b.values())
    moved_ok = _region_gate(stats_b, kept_b, off_b, x_bytes) and \
        len(stats_b) == cfg.n_layers * runs and \
        all(len(s.fences) == len(off_b) for s in stats_b)
    rels = [abs(b_ - a_) / abs(a_) for a_, b_ in zip(losses, losses_b)]
    expected_b = _expected_launches(plan_b, cfg.n_layers, runs)
    launches_b = {"flash": fa.LAUNCHES, "swiglu": sw.LAUNCHES}
    step_s_b = statistics.median(times_b[1:])
    ok = (moved_ok and len(rels) == TRAIN_STEPS and max(rels) <= 1e-6
          and grad_rel <= GRAD_REL_TOL and launches_b == expected_b
          and peak - peak_b >= 0.5 * off_layer * cfg.n_layers)
    emit({"phase": "train", "part": "b", "ok": ok, "gpu": gpu,
          "remat_budget_bytes": OFFLOAD_BUDGET, "dma_gbps": OFFLOAD_DMA_GBPS,
          "plan_decisions": decisions, "offload_lowering":
              plan_b.report().get("offload_lowering"),
          "measured_offloaded_bytes_per_layer":
              stats_b[0].offloaded if stats_b else None,
          "measured_kept_bytes_per_layer":
              stats_b[0].kept if stats_b else None,
          "plan_offload_dma_bytes_per_layer":
              plan_b.remat_plan.offload_dma_bytes_per_layer,
          "peak_bytes": peak_b, "peak_bytes_a": peak,
          "peak_drop_bytes": peak - peak_b,
          "offloaded_bytes_x_layers": off_layer * cfg.n_layers,
          "losses": losses_b, "losses_a": losses, "loss_rels": rels,
          "max_grad_rel_vs_keep_all": grad_rel, "worst_grad": worst,
          "grad_tol": GRAD_REL_TOL,
          "step_s": times_b, "step_s_median_2_3": step_s_b,
          "step_s_median_2_3_a": step_s, "step_ratio_b_over_a":
              step_s_b / step_s,
          "fence_wait_ms_per_step": fence_ms,
          "kernel_launches": launches_b, "expected_launches": expected_b})
    check(ok, "train", f"(b) moved ok {moved_ok}, loss rels {rels}, grad "
          f"{worst} {grad_rel}, peak {peak_b} vs {peak}, launches "
          f"{launches_b} vs {expected_b}")
    return launches


def _offload_grads_gate(torch, cfg, cfg_b, tokens, remat):
    """(b)'s gradient check: one micro-batch of ``tokens`` tokens through
    ``loss_fn`` under the keep-all plan and under the offloading plan, from
    the same parameters; between the forward and the backward of the
    offloading run, the memory the offloaded copies left is filled with
    NaN, so a fetch that read it, or a copy that raced it, shows.  Returns
    the largest normwise difference over the grads and the loss, and the
    name where it was."""
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    params = model.init(0, trainable=True)
    g = torch.Generator("cuda").manual_seed(43)
    toks = torch.randint(0, cfg.vocab, (1, tokens + 1), generator=g,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def grads_under(c, scribble):
        with remat.observe_regions() as stats:
            loss = build_model(c).loss_fn(params, batch)
        if scribble:      # blocks of the released copies' sizes
            junk = [torch.full((n // 4,), float("nan"), device="cuda")
                    for s in stats for n in s.offloaded.values()]
            del junk
        loss.backward()
        grads = {n: p.grad for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return loss.detach(), grads

    want_loss, want = grads_under(cfg, False)
    loss, got = grads_under(cfg_b, True)
    rels = {n: ((got[n] - w).abs().max() / w.abs().max()).item()
            for n, w in want.items()}
    rels["loss"] = abs((loss - want_loss) / want_loss).item()
    worst = max(rels, key=rels.get)
    del params, got, want
    torch.cuda.empty_cache()
    return rels[worst], worst


def _intermediates(cfg, tokens):
    from repro_torch.core.remat_policy import transformer_intermediates
    return transformer_intermediates(
        batch_tokens=tokens, d_model=cfg.d_model, d_ff=cfg.d_ff,
        n_q_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim)


def _loss_and_grads(torch, model, params, batch):
    for p in params.parameters():
        p.grad = None
    loss = model.loss_fn(params, batch)
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in params.named_parameters()}


def _train_fp32_parity(torch, fa, sw, flash_ops):
    """(c) fp32, full width, depth 4, every tag recomputed (so each kernel
    also launches in the replays): the kernel path (flash and SwiGLU simt)
    against the plain path (the twins in the wrappers' place) on the card,
    loss and every grad normwise; then granite-moe the same way with every
    expert choice compared."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.plan import compile_plan
    from repro_torch.models import moe
    from repro_torch.models.model import build_model

    for arch in ("llama3.2-3b", "granite-moe-1b-a400m"):
        cfg = dataclasses.replace(
            ARCHS[arch], attention_impl="pallas", dtype="float32",
            n_layers=TRAIN_FP32_DEPTH, remat_budget_bytes=0)
        model = build_model(cfg)
        params = model.init(0, trainable=True)
        g = torch.Generator("cuda").manual_seed(41)
        toks = torch.randint(0, cfg.vocab, (1, TRAIN_FP32_SEQ + 1),
                             generator=g, device="cuda")
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        masks = []
        top_k_mask = moe._top_k_mask

        def recorded(probs, k):
            mask, weights = top_k_mask(probs, k)
            masks.append(mask.cpu())
            return mask, weights

        moe._top_k_mask = recorded
        flash_fwd, swiglu_fwd = flash_ops.flash_attention_fwd, sw._forward
        try:
            _zero(fa, sw)
            loss, grads = _loss_and_grads(torch, model, params, batch)
            launches = {"flash": fa.LAUNCHES, "swiglu": sw.LAUNCHES}
            simt = _only(fa, "simt", fa.LAUNCHES) and \
                _only(sw, "simt", sw.LAUNCHES)
            card_masks, masks[:] = list(masks), []
            flash_ops.flash_attention_fwd = fa.flash_attention_fwd_plain
            sw._forward = sw.fused_swiglu_plain
            _zero(fa, sw)
            want_loss, want = _loss_and_grads(torch, model, params, batch)
            plain_launches = fa.LAUNCHES + sw.LAUNCHES
        finally:
            moe._top_k_mask = top_k_mask
            flash_ops.flash_attention_fwd, sw._forward = flash_fwd, \
                swiglu_fwd
        plan = compile_plan(cfg, batch_tokens=TRAIN_FP32_SEQ)
        expected = _expected_launches(plan, cfg.n_layers, 1)
        errs = {n: ((grads[n] - w).abs().max() / w.abs().max()).item()
                for n, w in want.items()}
        loss_rel = abs((loss - want_loss) / want_loss).item()
        flipped = [int((a != b).any(-1).sum())
                   for a, b in zip(card_masks, masks)]
        ok = (loss_rel <= GRAD_REL_TOL and max(errs.values()) <= GRAD_REL_TOL
              and launches == expected and simt and plain_launches == 0
              and len(card_masks) == len(masks) and not any(flipped))
        worst = max(errs, key=errs.get)
        emit({"phase": "train", "part": "c", "arch": arch, "ok": ok,
              "layers": cfg.n_layers, "seq": TRAIN_FP32_SEQ,
              "plan_decisions": plan.remat_plan.decisions(),
              "loss": loss.item(), "loss_rel": loss_rel,
              "max_grad_rel": errs[worst], "worst_grad": worst,
              "tol": GRAD_REL_TOL, "kernel_launches": launches,
              "expected_launches": expected, "all_simt": simt,
              "expert_choices_compared": len(card_masks),
              "tokens_with_flipped_experts": flipped})
        check(ok, "train", f"(c) {arch}: loss rel {loss_rel}, grad "
              f"{worst} {errs[worst]}, launches {launches} vs {expected}, "
              f"flipped {flipped}")
        del params, grads, want
        torch.cuda.empty_cache()


def _train_resume(torch):
    """(d) reduced depth (and vocabulary, to keep the checkpoints small):
    4 steps straight, then 2 steps with a checkpoint and a restart from it
    for steps 3-4, under deterministic algorithms; losses bit for bit and
    the data state restored as saved."""
    import shutil

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import SHAPES
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(ARCHS["llama3.2-3b"], attention_impl="pallas",
                              n_layers=RESUME_DEPTH, vocab=RESUME_VOCAB)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=RESUME_SEQ,
                                global_batch=2)
    ckpt_dir = ROOT / "build" / "chip_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def run(steps, ckpt):
        trainer = Trainer(build_model(cfg), make_optimizer("adamw"), shape,
                          TrainerConfig(steps=steps, log_every=1,
                                        ckpt_every=2, ckpt_dir=ckpt))
        out = trainer.run()
        return [h["loss"] for h in out["history"]], trainer

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            straight, _ = run(4, None)
            first, _ = run(2, str(ckpt_dir))
            saved = json.loads(
                (ckpt_dir / "step_2" / "data_state.json").read_text())
            resumed, trainer = run(4, str(ckpt_dir))
    finally:
        torch.use_deterministic_algorithms(False)
    restored = trainer.restored_data_state.as_dict()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    nondeterministic = sorted({str(w.message)[:120] for w in caught
                               if "deterministic" in str(w.message)})
    ok = (first == straight[:2] and resumed == straight[2:]
          and restored == saved)
    emit({"phase": "train", "part": "d", "ok": ok, "layers": cfg.n_layers,
          "vocab": cfg.vocab, "seq": RESUME_SEQ, "straight": straight,
          "first_two": first, "resumed": resumed, "saved_data_state": saved,
          "restored_data_state": restored,
          "nondeterministic_warnings": nondeterministic})
    check(ok, "train", f"(d) straight {straight}, resumed {resumed}, data "
          f"state {restored} vs {saved}")


# ---------------------------------------------------------------------------
# 20. train_recurrent: zamba2-7b and xlstm-1.3b trained at full width
# ---------------------------------------------------------------------------

# (e) zamba2-7b: depth 81 -> 39 (6 groups of 6 and a tail of 3: the fp32
# parameters, grads and AdamW moments of 81 layers, 108 GB, do not fit the
# card), global batch 256 -> 2 (2 micro-batches of 1), train_4k's 4096
# tokens; (f) xlstm-1.3b at full width, batch 2 likewise, sequence 4096 ->
# 1024 (the sLSTM loop, replayed and backpropagated step by step on the
# host, would add minutes at 4096)
REC_ZAMBA_DEPTH, REC_ZAMBA_SEQ, REC_ZAMBA_STEPS = 39, 4096, 3
REC_XLSTM_SEQ, REC_XLSTM_STEPS = 1024, 2
# (f)'s depth: 1 group of 7 mLSTM blocks and the sLSTM block (cut from
# all 48 to keep the whole run well inside its limit)
REC_XLSTM_DEPTH = 8
REC_BATCH, REC_MICRO = 2, 2
# (g) fp32 parity: full width, S = 1024, zamba one group and a tail of 1,
# xlstm one group of 7 mLSTM blocks and 1 sLSTM block
REC_FP32_SEQ = 1024
REC_FP32_DEPTH = {"zamba2-7b": 7, "xlstm-1.3b": 8}
# (g) holds each grad leaf of the kernel path to the twin path within the
# larger of GRAD_REL_TOL and SPREAD_FACTOR x a plain fp32 path's distance
# on the leaf (the scans' forwards by ssd_chunked / mlstm_chunked, and for
# xlstm-1.3b also NOISE_DRAWS draws of the kernel's own forward error
# added to the twins'): zamba2-7b's SSD decay leaves (A_log, dt_bias) sum
# cancelling terms, and their fp32 grads move by ~1e-4 with the order of
# the sums; xlstm-1.3b's whole-model grads run through the mLSTM
# normaliser's kink (``_xlstm_witness``)
SPREAD_FACTOR = 2.0
NOISE_DRAWS = 2
# the kernels at the train steps' shapes (one sequence)
SSD_TRAIN = (1, 4096, 112, 64, 64, 256)        # x (1, 16, 256, 112, 64)
MLSTM_TRAIN = (1, 1024, 4, 1024, 256)          # q (1, 4, 256, 4, 1024)
ZAMBA_TRAIN_FLASH = (1, 32, 32, 4096, 4096, 112, True, 512, 1024)
ZAMBA_TRAIN_SWIGLU = (1, 4096, 3584, 14336)


class _TimedRecompute:
    """Wraps a scan Function's backward recompute (``kernels.recompute.
    vjp``): CUDA events around each call on the current stream, read after
    the run (``ms``)."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.events = torch, fn, []

    def __call__(self, *args):
        t = self.torch
        start = t.cuda.Event(enable_timing=True)
        end = t.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self):
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


@contextlib.contextmanager
def _recurrent_twins(torch, fa, ssd, ml, sw):
    """Every kernel's twin counted (``_Counted``), and both scans' backward
    recomputes timed; yields (twins, timers)."""
    from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
    from repro_torch.kernels.ssm_scan import ops as ssd_ops

    twins = {"flash": _Counted(fa.flash_attention_fwd_plain),
             "swiglu": _Counted(sw.fused_swiglu_plain),
             "ssd": _Counted(ssd.ssd_chunk_plain),
             "mlstm": _Counted(ml.mlstm_chunk_plain)}
    timers = {"ssd": _TimedRecompute(torch, ssd_ops.vjp),
              "mlstm": _TimedRecompute(torch, mlstm_ops.vjp)}
    saved = (fa.flash_attention_fwd_plain, sw.fused_swiglu_plain,
             ssd.ssd_chunk_plain, ml.mlstm_chunk_plain, ssd_ops.vjp,
             mlstm_ops.vjp)
    fa.flash_attention_fwd_plain = twins["flash"]
    sw.fused_swiglu_plain = twins["swiglu"]
    ssd.ssd_chunk_plain, ml.mlstm_chunk_plain = twins["ssd"], twins["mlstm"]
    ssd_ops.vjp, mlstm_ops.vjp = timers["ssd"], timers["mlstm"]
    try:
        yield twins, timers
    finally:
        (fa.flash_attention_fwd_plain, sw.fused_swiglu_plain,
         ssd.ssd_chunk_plain, ml.mlstm_chunk_plain, ssd_ops.vjp,
         mlstm_ops.vjp) = saved


def _train_recurrent_rows(torch, fa, ssd, ml, sw, gpu):
    """The train_recurrent phase, then its four kernel rows, each kernel
    timed at its train step's shape with the launches of (e) or (f)."""
    rows = {"ssd": _scan_row(torch, ssd, "ssd_chunk", SSD_TRAIN,
                             _ssd_inputs, ssd_bound, SSD_TOL, gpu,
                             "zamba2-7b"),
            "mlstm": _scan_row(torch, ml, "mlstm_chunk", MLSTM_TRAIN,
                               _mlstm_inputs, mlstm_bound, MLSTM_TOL, gpu,
                               "xlstm-1.3b"),
            "flash": _flash_times(torch, fa, gpu, ZAMBA_TRAIN_FLASH,
                                  "zamba2-7b"),
            "swiglu": _swiglu_times(torch, sw, gpu, ZAMBA_TRAIN_SWIGLU,
                                    "zamba2-7b MLP")}
    _recompute_times(torch, gpu)
    launches = phase_train_recurrent(torch, fa, ssd, ml, sw, gpu)
    paths = {"ssd": "zamba2-7b train step (forward and replays)",
             "mlstm": "xlstm-1.3b train step (forward and replays)",
             "flash": "zamba2-7b shared block, train step (forward and "
                      "replays)",
             "swiglu": "zamba2-7b shared MLP, train step (forward and "
                       "replays)"}
    for k, row in rows.items():
        row.update(path=paths[k], launches=launches[k])
    return list(rows.values())


def _scan_row(torch, m, kernel, case, make_inputs, bound, tol, gpu, arch):
    """An SSD or mLSTM kernel-table row at ``case``: the kernel against its
    twin, its time beside the earlier simt design's and the twin's."""
    ins = make_inputs(torch, case, seed=654)
    variant = m.variant_for(*ins[:5])
    err = max(_compare(g, w, **tol)[1] for g, w in
              zip(getattr(m, kernel)(*ins), getattr(m, f"{kernel}_plain")(
                  *ins)))
    ms, prev_ms, plain_ms = _scan_times(torch, m, kernel, ins, 10)
    bound_ms, bound_by, flops, nbytes = bound(case)
    emit({"phase": "kernel_times", "ok": True, "gpu": gpu,
          "kernel": kernel, "arch": arch, "path": "train step",
          "shape": list(case), "variant": variant, "kernel_ms": ms,
          "prev_ms": prev_ms, "plain_ms": plain_ms, "library_ms": None,
          "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
          "bytes": nbytes, "roofline_share": bound_ms / ms,
          "max_abs_err": err})
    del ins
    torch.cuda.empty_cache()
    src = {"ssd_chunk": ("ssm_scan", "src/repro/kernels/ssm_scan/"
                                     "kernel.py:61"),
           "mlstm_chunk": ("mlstm_scan", "src/repro/kernels/mlstm_scan/"
                                         "kernel.py:65")}[kernel]
    return {"name": kernel, "route": "cuda", "variant": variant,
            "source": f"src/repro_torch/kernels/{src[0]}/csrc/"
                      + m.SOURCES[variant].name,
            "replaces": src[1], "shape": list(case), "launches": 0,
            "max_abs_err": err, "ms": ms, "prev_ms": prev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def _recompute_times(torch, gpu):
    """The backward of one mamba layer's scan and of one mLSTM block's at
    the train steps' shapes: the vjp of ``ssd_chunked`` and of
    ``mlstm_chunked`` recomputed from the inputs, as the Functions run it
    (the time a CUDA backward kernel would be held against)."""
    from repro_torch.kernels.recompute import vjp
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.xlstm import mlstm_chunked

    g = torch.Generator("cuda").manual_seed(77)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    b, s, h, p, n, _ = SSD_TRAIN
    ssd_in = (rnd(b, s, h, p), torch.nn.functional.softplus(rnd(b, s, h)),
              torch.log(torch.linspace(1.0, 16.0, h, device="cuda")),
              rnd(b, s, n), rnd(b, s, n))
    ssd_dy = rnd(b, s, h, p)
    b, s, h, p, _ = MLSTM_TRAIN
    ml_in = (rnd(b, s, h, p), rnd(b, s, h, p), rnd(b, s, h, p), rnd(b, s, h),
             rnd(b, s, h) + 3.0)
    ml_dy = rnd(b, s, h, p)
    needs = [True] * 5
    ssd_ms = _median_ms(torch, lambda: vjp(ssd_chunked, ssd_in, needs,
                                           ssd_dy), reps=5, inner=1)
    ml_ms = _median_ms(torch, lambda: vjp(mlstm_chunked, ml_in, needs,
                                          ml_dy), reps=5, inner=1)
    emit({"phase": "backward_recompute", "ok": True, "gpu": gpu,
          "ssd_chunked_vjp_ms": ssd_ms, "ssd_shape": list(SSD_TRAIN),
          "mlstm_chunked_vjp_ms": ml_ms, "mlstm_shape": list(MLSTM_TRAIN),
          "note": "one layer's backward recompute, all five inputs' grads, "
                  "fp32; median of 5 calls"})
    del ssd_in, ml_in
    torch.cuda.empty_cache()


def phase_train_recurrent(torch, fa, ssd, ml, sw, gpu):
    """(e) zamba2-7b and (f) xlstm-1.3b trained through ``Trainer``; (g)
    the kernel path against the plain path in fp32.  Returns the launches
    of (e) (SSD, flash, SwiGLU) and (f) (mLSTM)."""
    import gc

    torch.cuda.empty_cache()
    launches = _train_recurrent_full(torch, fa, ssd, ml, sw, gpu,
                                     "zamba2-7b")
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(_train_recurrent_full(torch, fa, ssd, ml, sw, gpu,
                                          "xlstm-1.3b"))
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ("zamba2-7b", "xlstm-1.3b"):
        _train_recurrent_fp32(torch, fa, ssd, ml, sw, arch)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def _recurrent_expected(cfg, tokens, runs):
    """Launches of one run of ``runs`` micro-batches: each mamba layer's
    SSD and each mLSTM block's kernel in the forward and again in its
    block's replay (remat rebuilds the block from its input); flash and
    SwiGLU once per shared-block application and again where the plan
    recomputes their outputs (``_expected_launches``)."""
    from repro_torch.core.plan import compile_plan
    from repro_torch.models.transformer import xlstm_counts
    from repro_torch.models.zamba import layout

    again = 2 if cfg.remat else 1
    if cfg.family == "ssm":
        return {"mlstm": xlstm_counts(cfg)[0] * runs * again}
    plan = compile_plan(cfg, batch_tokens=tokens)
    out = _expected_launches(plan, layout(cfg)[0], runs)
    out["ssd"] = cfg.n_layers * runs * again
    return out


def _mixer_params(params, cfg):
    """Parameters by part: each mamba layer, mLSTM or sLSTM block, the
    shared block, embedding and unembedding."""
    count = lambda mods: sum(p.numel() for m in mods for p in m.parameters())
    parts = {"embed_unembed": params.embed.numel() + params.unembed.numel()}
    if cfg.family == "hybrid":
        parts["mamba_layer"] = count(params.mblocks[:1])
        parts["shared_block"] = count([params.shared])
    else:
        parts["mlstm_block"] = count(params.mblocks[:1])
        parts["slstm_block"] = count(params.sblocks[:1])
    return parts


def _train_recurrent_full(torch, fa, ssd, ml, sw, gpu, arch):
    """(e) or (f): ``Trainer`` at full width, the cuts above, the default
    plan; finite losses near ln(vocab) at step 1, launches exactly as the
    checkpoint structure implies, no forward through a twin (SwiGLU's
    backward recomputes through its twin once per application), the peak
    within 80 GB beside the reckoned parts."""
    import gc

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import SHAPES
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig

    part = "e" if arch == "zamba2-7b" else "f"
    cfg = dataclasses.replace(ARCHS[arch], attention_impl="pallas")
    seq, steps = REC_ZAMBA_SEQ, REC_ZAMBA_STEPS
    cuts = {"global_batch": [256, REC_BATCH, "the fp32 state and one "
                             "sequence's activations fill the card"]}
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, n_layers=REC_ZAMBA_DEPTH)
        cuts["n_layers"] = [81, REC_ZAMBA_DEPTH, "81 layers' fp32 params, "
                            "grads and AdamW moments are 108 GB"]
    else:
        seq, steps = REC_XLSTM_SEQ, REC_XLSTM_STEPS
        cuts["seq_len"] = [4096, seq, "the sLSTM loop is replayed and "
                           "backpropagated step by step on the host"]
        cfg = dataclasses.replace(cfg, n_layers=REC_XLSTM_DEPTH)
        cuts["n_layers"] = [48, REC_XLSTM_DEPTH, "the whole chip check's "
                            "time limit: each sLSTM block is ~8 s a step"]
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                global_batch=REC_BATCH)
    tokens = seq * REC_BATCH // REC_MICRO
    runs = steps * REC_MICRO
    expected = _recurrent_expected(cfg, tokens, runs)
    mods = {"ssd": ssd, "mlstm": ml, "flash": fa, "swiglu": sw}
    with _recurrent_twins(torch, fa, ssd, ml, sw) as (twins, timers):
        _zero(fa, ssd, ml, sw)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = Trainer(build_model(cfg), make_optimizer("adamw"), shape,
                      TrainerConfig(steps=steps, log_every=1),
                      microbatches=REC_MICRO).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        recompute_ms = {k: t.ms() for k, t in timers.items()}
        twin_calls = {k: t.calls for k, t in twins.items()}
    launches = {k: mods[k].LAUNCHES for k in expected}
    by_variant = {k: dict(mods[k].LAUNCHES_BY_VARIANT) for k in expected}
    all_wgmma = all(_only(mods[k], "wgmma", n) for k, n in launches.items())
    parts = _mixer_params(out["params"], cfg)
    n_params = sum(p.numel() for p in out["params"].parameters())
    losses = [h["loss"] for h in out["history"]]
    times = [h["time_s"] for h in out["history"]]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    step_s = statistics.median(times[1:])
    want_twins = _expected_twins(cfg, runs)
    # the untied unembedding (std 1/sqrt(d)) makes the first logits ~N(0,
    # 1): the first loss is ln(vocab) + ~0.5
    ok = (all(math.isfinite(v) for v in losses)
          and abs(losses[0] - math.log(cfg.vocab)) <= 1.0
          and launches == expected and all_wgmma
          and twin_calls == want_twins and peak <= 80e9)
    emit({"phase": "train_recurrent", "part": part, "arch": arch, "ok": ok,
          "gpu": gpu, "entry": "Trainer(build_model(cfg), adamw, shape, "
                               "TrainerConfig(steps), microbatches=2).run()",
          "layers": cfg.n_layers, "seq": seq, "batch": REC_BATCH,
          "microbatches": REC_MICRO, "steps": steps, "cuts": cuts,
          "params": n_params, "params_by_part": parts,
          "losses": losses, "ln_vocab": math.log(cfg.vocab),
          "step_s": times, "step_s_median_after_1": step_s,
          "tokens_per_s": seq * REC_BATCH / step_s,
          "mfu_6nt": 6 * n_params * seq * REC_BATCH / step_s
          / _peak_flops("bfloat16"),
          "wall_s": wall, "peak_bytes": peak,
          "reckoned_bytes": {"params": 4 * n_params, "grads": 4 * n_params,
                             "adamw_moments": 8 * n_params,
                             "state_total": 16 * n_params},
          "backward_recompute_ms_total": recompute_ms,
          "backward_recompute_share_of_wall": {
              k: v / 1e3 / sum(times) for k, v in recompute_ms.items()},
          "kernel_launches": launches, "expected_launches": expected,
          "launches_by_variant": by_variant, "all_wgmma": all_wgmma,
          "twin_calls": twin_calls, "expected_twin_calls": want_twins})
    check(ok, "train_recurrent", f"({part}) {arch}: losses {losses}, "
          f"launches {launches} vs {expected}, twins {twin_calls} vs "
          f"{want_twins}, peak {peak}")
    return launches


def _expected_twins(cfg, runs):
    """Twin calls of a kernel-path run: none in any forward or replay; the
    SwiGLU backward recomputes through its twin once per application of
    zamba's shared block."""
    from repro_torch.models.zamba import layout
    apps = layout(cfg)[0] if cfg.family == "hybrid" else 0
    return {"flash": 0, "swiglu": apps * runs, "ssd": 0, "mlstm": 0}


def _mlstm_block_errs(torch, fa, ssd, ml, sw, cfg, params, inputs, dys,
                      rel):
    """Each mLSTM block's grads (its parameters' and its input's) by the
    kernel path against the twin path, from the block's input and upstream
    gradient in the model's own kernel-path run: normwise, by leaf name."""
    from repro_torch.models import transformer

    errs = {}
    for i, p in enumerate(params.mblocks):
        names = ["input"] + [n for n, _ in p.named_parameters()]

        def grads():
            leaf = inputs[i].requires_grad_()
            out = transformer._mlstm_block(cfg, p, leaf)
            return torch.autograd.grad(out, [leaf, *p.parameters()], dys[i])

        got = grads()
        with _plain_path(torch, fa, ssd, ml, sw, "twin"):
            want = grads()
        for n, a, b in zip(names, got, want):
            errs[f"mblocks.{i}.{n}"] = rel(a, b)
    return errs


@contextlib.contextmanager
def _block_grads(torch):
    """Each mLSTM block's input and the loss's gradient at its output in a
    run: yields (inputs, upstream gradients), both by block."""
    from repro_torch.models import transformer

    real = transformer._Checkpointed.__call__
    inputs, dys = [], {}

    def call(self, policy, fn, *args):
        out = real(self, policy, fn, *args)
        if getattr(fn, "func", None) is transformer._mlstm_block:
            i = len(inputs)
            inputs.append(args[0].detach())
            out.register_hook(lambda g: dys.__setitem__(i, g.detach()))
        return out

    transformer._Checkpointed.__call__ = call
    try:
        yield inputs, dys
    finally:
        transformer._Checkpointed.__call__ = real


@contextlib.contextmanager
def _normaliser_branches(torch, pin=None):
    """The branch of the mLSTM normaliser max(|n|, exp(-m)) (``xlstm.
    _normaliser``) each backward recompute takes, |n| > exp(-m) by
    position, in call order: yields the list.  With ``pin``, an earlier
    run's list, each recompute takes the pinned branch instead.  A scan's
    forward (run with autograd off) is left alone."""
    from repro_torch.models import xlstm

    real = xlstm._normaliser
    seen = []

    def spy(n, m):
        if not torch.is_grad_enabled():
            return real(n, m)
        a, b = torch.abs(n), torch.exp(-m)
        take = pin[len(seen)] if pin is not None else None
        seen.append((a > b).detach())
        return real(n, m) if take is None else torch.where(take, a, b)

    xlstm._normaliser = spy
    try:
        yield seen
    finally:
        xlstm._normaliser = real


@contextlib.contextmanager
def _scan_outputs(torch, add=None):
    """Each mLSTM scan's forward by block (a block is known by its inputs,
    so a remat replay maps to its block): yields the list of each block's
    (inputs, output) from its first call; ``add(block, y)``, if given,
    returns the output the scan gives instead of ``y``."""
    from repro_torch.kernels.mlstm_scan import ops

    real = ops._forward
    blocks, first = {}, []

    def forward(*args):
        y = real(*args)
        key = tuple(float(t.sum()) for t in args[:5])
        if key not in blocks:
            blocks[key] = len(first)
            first.append((args, y))
        return y if add is None else add(blocks[key], y)

    ops._forward = forward
    try:
        yield first
    finally:
        ops._forward = real


def _flips(masks, ref):
    """Positions whose normaliser branch differs from ``ref``'s, by
    backward recompute."""
    return [int((a != b).sum()) for a, b in zip(masks, ref)]


@contextlib.contextmanager
def _plain_path(torch, fa, ssd, ml, sw, scans):
    """Every kernel out of the path: flash and SwiGLU by their twins, the
    SSD and mLSTM scans' forwards by the twins (``scans="twin"``) or by
    ``ssd_chunked`` / ``mlstm_chunked`` (``scans="chunked"``)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
    from repro_torch.kernels.ssm_scan import ops as ssd_ops
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.xlstm import mlstm_chunked

    saved = (flash_ops.flash_attention_fwd, sw._forward, ssd_ops.ssd_chunk,
             mlstm_ops.mlstm_chunk, ssd_ops._forward, mlstm_ops._forward)
    flash_ops.flash_attention_fwd = fa.flash_attention_fwd_plain
    sw._forward = sw.fused_swiglu_plain
    if scans == "twin":
        ssd_ops.ssd_chunk = ssd.ssd_chunk_plain
        mlstm_ops.mlstm_chunk = ml.mlstm_chunk_plain
    else:
        ssd_ops._forward = lambda *a: ssd_chunked(*a[:5], chunk=a[5])
        mlstm_ops._forward = lambda *a: mlstm_chunked(*a[:5], chunk=a[5])
    try:
        yield
    finally:
        (flash_ops.flash_attention_fwd, sw._forward, ssd_ops.ssd_chunk,
         mlstm_ops.mlstm_chunk, ssd_ops._forward, mlstm_ops._forward) = saved


def _train_recurrent_fp32(torch, fa, ssd, ml, sw, arch):
    """(g) fp32, full width, S = 1024, every tag recomputed: the kernel path
    (SSD and mLSTM wgmma, flash and SwiGLU simt) against the plain path
    (each kernel's twin in its wrapper's place) on the card, the loss and
    every grad of the whole model normwise, within the larger of
    GRAD_REL_TOL and SPREAD_FACTOR x a plain path's distance on the leaf;
    no forward through a twin in the kernel run, no kernel in the plain
    runs.  xlstm-1.3b's runs take their mLSTM backwards' normaliser
    branches from the twin run (``_xlstm_witness``), and each mLSTM
    block is held at GRAD_REL_TOL from its input and upstream gradient in
    the kernel run."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(
        ARCHS[arch], attention_impl="pallas", dtype="float32",
        n_layers=REC_FP32_DEPTH[arch], remat_budget_bytes=0)
    xl = arch == "xlstm-1.3b"
    model = build_model(cfg)
    params = model.init(0, trainable=True)
    g = torch.Generator("cuda").manual_seed(47)
    toks = torch.randint(0, cfg.vocab, (1, REC_FP32_SEQ + 1), generator=g,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    expected = _recurrent_expected(cfg, REC_FP32_SEQ, 1)
    mods = {"ssd": ssd, "mlstm": ml, "flash": fa, "swiglu": sw}
    variants = {"ssd": "wgmma", "mlstm": "wgmma", "flash": "simt",
                "swiglu": "simt"}
    run = functools.partial(_loss_and_grads, torch, model, params, batch)
    with contextlib.ExitStack() as stack:
        twins, _ = stack.enter_context(
            _recurrent_twins(torch, fa, ssd, ml, sw))
        if xl:
            block_io = stack.enter_context(_block_grads(torch))
            scans = stack.enter_context(_scan_outputs(torch))
            kernel_branches = stack.enter_context(
                _normaliser_branches(torch))
        _zero(fa, ssd, ml, sw)
        loss, grads = run()
        launches = {k: mods[k].LAUNCHES for k in expected}
        routed = all(_only(mods[k], variants[k], n)
                     for k, n in launches.items())
        twin_calls = {k: t.calls for k, t in twins.items()}
    _zero(fa, ssd, ml, sw)
    with _plain_path(torch, fa, ssd, ml, sw, "twin"), \
            _normaliser_branches(torch) as branches:
        want_loss, want = run()

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def errs_of(got):
        return {n: rel(got[n], w) for n, w in want.items()}

    errs = errs_of(grads)
    del grads
    with _plain_path(torch, fa, ssd, ml, sw, "chunked"):
        chunked_loss, chunked = run()
    spread = errs_of(chunked)
    del chunked
    loss_rel = abs((loss - want_loss) / want_loss).item()
    finite = all(bool(v.isfinite().all()) for v in want.values())
    out = {"loss": loss.item(), "loss_rel": loss_rel,
           "loss_rel_plain_paths": abs((chunked_loss - want_loss)
                                       / want_loss).item(),
           "max_grad_rel": max(errs.values()),
           "worst_grad": max(errs, key=errs.get),
           "max_spread_plain_paths": max(spread.values())}
    gated, witness, bad = errs, spread, {}
    if xl:
        gated, witness, plain_launches, seen = _xlstm_witness(
            torch, fa, ssd, ml, sw, run, errs_of, scans, branches,
            kernel_branches)
        out.update(seen)
        block_errs = _mlstm_block_errs(torch, fa, ssd, ml, sw, cfg, params,
                                       *block_io, rel)
        bad = {n: [e, GRAD_REL_TOL] for n, e in block_errs.items()
               if not e <= GRAD_REL_TOL}
        out.update(max_block_grad_rel=max(block_errs.values()),
                   worst_block_grad=max(block_errs, key=block_errs.get))
    else:
        plain_launches = (fa.LAUNCHES + ssd.LAUNCHES + ml.LAUNCHES
                          + sw.LAUNCHES)
    tols = {n: max(GRAD_REL_TOL, SPREAD_FACTOR * witness[n]) for n in gated}
    bad.update({n: [e, tols[n]] for n, e in gated.items()
                if not e <= tols[n]})
    ok = (loss_rel <= GRAD_REL_TOL and finite and not bad
          and launches == expected and routed and plain_launches == 0
          and twin_calls == _expected_twins(cfg, 1))
    strict = [n for n in gated if tols[n] == GRAD_REL_TOL]
    widened = sorted((n for n in gated if tols[n] > GRAD_REL_TOL),
                     key=tols.get)
    emit({"phase": "train_recurrent", "part": "g", "arch": arch, "ok": ok,
          "layers": cfg.n_layers, "seq": REC_FP32_SEQ, "dtype": "float32",
          **out, "grads_finite": finite,
          "gated": "the whole model's grads, normaliser branches pinned to "
                   "the twin run's, and each mLSTM block's" if xl else
                   "the whole model's grads",
          "max_gated_grad_rel": max(gated.values()),
          "worst_gated_grad": max(gated, key=gated.get),
          "max_grad_rel_at_1e-4": max((gated[n] for n in strict), default=0),
          "leaves": len(gated), "leaves_at_1e-4": len(strict),
          "widened": {n: [gated[n], witness[n]] for n in widened[-8:]},
          "max_err_over_witness": max(
              (gated[n] / witness[n] for n in gated if witness[n] > 0),
              default=None),
          "tol": GRAD_REL_TOL, "spread_factor": SPREAD_FACTOR,
          "failing": dict(list(bad.items())[:12]),
          "kernel_launches": launches, "expected_launches": expected,
          "variants": variants, "routed": routed,
          "twin_calls_kernel_run": twin_calls,
          "plain_run_kernel_launches": plain_launches})
    check(ok, "train_recurrent", f"(g) {arch}: loss rel {loss_rel}, "
          f"{len(bad)} leaves over their tolerance, launches {launches} "
          f"vs {expected}, twins {twin_calls}")
    del params, want
    torch.cuda.empty_cache()


def _xlstm_witness(torch, fa, ssd, ml, sw, run, errs_of, scans, branches,
                   kernel_branches):
    """xlstm-1.3b's whole-model comparison.  The mLSTM normaliser
    max(|n|, exp(-m)) has a kink; where its two sides nearly tie, a
    forward difference of float32 size sends the backward's recompute to
    the other side, and the block's gradient jumps there.  So: (1) the
    kernel's own forward error on each block (kernel minus twin on the
    kernel run's scan inputs), permuted at random, is added to the twin
    run's scan outputs (``NOISE_DRAWS`` draws): how far that moves the
    grads, and how many branches it flips, beside the kernel's and the
    chunked path's; (2) the kernel, chunked and noise runs again with
    every backward's branches pinned to the twin run's.  Returns the
    pinned kernel run's errors, the witness (per leaf, the largest pinned
    error of the chunked and noise runs), the plain runs' kernel
    launches and the readings."""
    from repro_torch.kernels.mlstm_scan import ops as mlstm_ops

    with _plain_path(torch, fa, ssd, ml, sw, "twin"):
        errors = [y - mlstm_ops._forward(*args) for args, y in scans]
    rms = max((e.square().mean() / y.square().mean()).sqrt().item()
              for e, (_, y) in zip(errors, scans))
    gen = torch.Generator("cuda").manual_seed(61)
    draws = [[e.flatten()[torch.randperm(e.numel(), generator=gen,
                                         device="cuda")].view_as(e)
              for e in errors] for _ in range(NOISE_DRAWS)]
    del scans[:]

    def noisy(k):
        return lambda block, y: y + draws[k][block]

    free, flips = {}, {"kernel": _flips(kernel_branches, branches)}
    with _plain_path(torch, fa, ssd, ml, sw, "chunked"), \
            _normaliser_branches(torch) as seen:
        run()
    flips["chunked"] = _flips(seen, branches)
    for k in range(NOISE_DRAWS):
        with _plain_path(torch, fa, ssd, ml, sw, "twin"), \
                _scan_outputs(torch, noisy(k)), \
                _normaliser_branches(torch) as seen:
            free[k] = max(errs_of(run()[1]).values())
        flips[f"noise_{k}"] = _flips(seen, branches)
    plain_launches = fa.LAUNCHES + ssd.LAUNCHES + ml.LAUNCHES + sw.LAUNCHES

    def pinned_errs(path=None, k=None):
        with contextlib.ExitStack() as stack:
            if path:
                stack.enter_context(_plain_path(torch, fa, ssd, ml, sw, path))
            if k is not None:
                stack.enter_context(_scan_outputs(torch, noisy(k)))
            stack.enter_context(_normaliser_branches(torch, pin=branches))
            return errs_of(run()[1])

    pinned = pinned_errs()
    witness = pinned_errs("chunked")
    for k in range(NOISE_DRAWS):
        noise = pinned_errs("twin", k)
        witness = {n: max(v, noise[n]) for n, v in witness.items()}
    seen = {"kernel_forward_err": {
                "max_abs": max(e.abs().max().item() for e in errors),
                "rms_rel": rms},
            "normaliser_flips": flips,
            "noise_max_grad_rel_unpinned": list(free.values()),
            "pinned_max_grad_rel": max(pinned.values()),
            "pinned_max_witness": max(witness.values())}
    return pinned, witness, plain_launches, seen


# ---------------------------------------------------------------------------
# 21. multimodal: llama-3.2-vision-11b and whisper-tiny served
# ---------------------------------------------------------------------------

VLM_ARCH, WHISPER_ARCH = "llama-3.2-vision-11b", "whisper-tiny"
# parameters of the reference's full trees (its abstract_params)
VLM_PARAMS, WHISPER_PARAMS = 10_110_734_344, 61_153_540
VLM_BATCH, VLM_SEQ = 2, 4096
WHISPER_BATCH, WHISPER_SEQ = 8, 448
# every cross block's gate: at the reference's init (0) tanh(xgate) = 0
# and the cross path would add nothing, so a wrong one would pass
XGATE = 0.5
VLM_FP32_DEPTH = 10          # two super-blocks of 4 self + 1 cross block
MM_GENERATE = (4, 128, 16)   # requests, prompt tokens, new tokens
# the flash calls of the two prefill steps (b, hq, hkv, sq, skv, d,
# causal, block_q, block_kv), and their SwiGLU calls (e, m, k, f)
VLM_SELF_SHAPE = (2, 32, 8, 4096, 4096, 128, True, 512, 1024)
VLM_CROSS_SHAPE = (2, 32, 8, 4096, 1600, 128, False, 512, 1024)
WHISPER_ENC_SHAPE = (8, 6, 6, 1500, 1500, 64, False, 512, 1024)
MM_FLASH = {"llama-3.2-vision-11b self-attention": VLM_SELF_SHAPE,
            "llama-3.2-vision-11b cross-attention": VLM_CROSS_SHAPE,
            "whisper-tiny encoder": WHISPER_ENC_SHAPE}
MM_SWIGLU = {"llama-3.2-vision-11b MLP": (1, 8192, 4096, 14336),
             "whisper-tiny encoder MLP": (1, 12000, 384, 1536),
             "whisper-tiny decoder MLP": (1, 3584, 384, 1536)}


@contextlib.contextmanager
def _launch_calls(m, key):
    """Record ``key(*args)`` of every launch of kernel module ``m`` in the
    body (its wrapper calls the module's ``_launch``), the variant last."""
    calls = []
    launch = m._launch

    def recorded(*args):
        calls.append(key(*args))
        return launch(*args)

    m._launch = recorded
    try:
        yield calls
    finally:
        m._launch = launch


def _flash_key(q, k, v, causal, variant):
    """(b, hq, hkv, sq, skv, d, causal, variant) of a (B, H, S, D) call."""
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3], bool(causal), variant)


def _swiglu_key(x, wg, wu, variant):
    """(e, m, k, f, variant) of a dense call."""
    return (1, x.numel() // x.shape[-1], x.shape[-1], wg.shape[-1], variant)


def _mm_model(arch, **over):
    """(cfg, model, params): ``arch`` on the card, weights from seed 0,
    every cross block's xgate set to ``XGATE``."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(ARCHS[arch], attention_impl="pallas", **over)
    model = _gated(build_model(cfg))
    return cfg, model, model.init(0)


def _gated(model):
    """``model`` whose ``init`` sets every cross block's xgate to
    ``XGATE``: at the reference's 0 no gradient reaches a cross-attention,
    nor whisper's encoder."""
    init = model.init

    def gated_init(*args, **kw):
        params = init(*args, **kw)
        cross = params.cross_blocks if model.cfg.family == "vlm" \
            else params.dec_blocks
        for p in cross:
            p.xgate.data.fill_(XGATE)
        return params

    return dataclasses.replace(model, init=gated_init)


def _mm_extra(torch, cfg, b, g, dtype):
    """The stubbed frontend's embeddings: ``(key, (B, T, d) tensor)``."""
    if cfg.family == "vlm":
        key, t = "image_embeds", cfg.image_tokens
    else:
        key, t = "enc_frames", cfg.encoder_seq
    return key, torch.randn((b, t, cfg.d_model), generator=g,
                            device="cuda").to(dtype)


def phase_multimodal(torch, fa, sw, gpu):
    """21. (d) the kernels against their twins at the multimodal shapes and
    their times; (a) llama-3.2-vision-11b's prefill step at full width and
    depth; (e) its generate; (b) its fp32 parity at depth 10; (c)
    whisper-tiny's prefill and fp32 parity at full depth, (e) its generate.
    Returns the six kernel-table rows, launches from (a) and (c)."""
    t_start = time.perf_counter()
    flash_results = _flash_twin_checks(torch, fa, list(MM_FLASH.values()),
                                       phase="multimodal_kernels")
    sw_results = _swiglu_twin_checks(torch, sw, list(MM_SWIGLU.values()),
                                     phase="multimodal_kernels")
    emit({"phase": "multimodal_kernels", "ok": True,
          "checked": len(flash_results) + len(sw_results),
          "results": flash_results + sw_results})
    rows = {}
    for path, shape in MM_FLASH.items():
        rows[path] = _flash_times(torch, fa, gpu, shape,
                                  path.split(" ")[0])
        rows[path]["path"] = f"{path}, prefill step"
    for path, case in MM_SWIGLU.items():
        rows[path] = _swiglu_times(torch, sw, gpu, case, path)
    torch.cuda.empty_cache()

    flash_calls, sw_calls = _vlm_prefill(torch, fa, sw, gpu)
    calls = _whisper_prefill(torch, fa, sw, gpu)
    flash_calls += calls[0]
    sw_calls += calls[1]
    for path, shape in MM_FLASH.items():
        rows[path]["launches"] = sum(
            1 for c in flash_calls if c[:7] == tuple(shape[:7]))
    for path, case in MM_SWIGLU.items():
        rows[path]["launches"] = sum(
            1 for c in sw_calls if c[:4] == tuple(case))
    wall = time.perf_counter() - t_start
    emit({"phase": "multimodal", "ok": True, "wall_s": wall,
          "launches": {p: r["launches"] for p, r in rows.items()}})
    return list(rows.values())


def _counted_prefill(torch, fa, sw, phase, step, params, batch):
    """One prefill step with the counts at 0 just before and read just
    after; returns (logits, seconds, flash calls, SwiGLU calls)."""
    _zero(fa, sw)
    with _launch_calls(fa, _flash_key) as flash_calls, \
            _launch_calls(sw, _swiglu_key) as sw_calls:
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    check(fa.LAUNCHES == len(flash_calls) and sw.LAUNCHES == len(sw_calls),
          phase, "a launch escaped the recorder")
    return logits, seconds, flash_calls, sw_calls


def _counts(calls):
    got = {}
    for c in calls:
        got[c] = got.get(c, 0) + 1
    return got


def _expect_calls(phase, calls, expected):
    """``calls`` (keys ending in the variant) equal ``expected``, a
    {key: count} with every key's variant wgmma."""
    got = _counts(calls)
    check(got == expected, phase, f"launches {got}, expected {expected}")


def _timed_steps(torch, step, params, batch, first_s, n=2):
    times = [first_s]
    for _ in range(n):
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _moved(torch, step, params, batch, key, other, logits):
    """max|logits' - logits| / max|logits| when ``batch[key]`` is
    replaced by ``other``."""
    moved = step(params, {**batch, key: other})
    rel = ((moved - logits).abs().max() / logits.abs().max()).item()
    del moved
    return rel


def _vlm_prefill(torch, fa, sw, gpu):
    """(a), (e) and (b) for llama-3.2-vision-11b; returns the prefill's
    flash and SwiGLU calls."""
    from repro_torch.models.model import build_model
    from repro_torch.models.multimodal import vlm_layout
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.train.step import make_prefill_step

    cfg, model, params = _mm_model(VLM_ARCH)
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == VLM_PARAMS, "vlm_prefill",
          f"{n_params} parameters, the reference's tree has {VLM_PARAMS}")
    n_super, per = vlm_layout(cfg)
    b, s = VLM_BATCH, VLM_SEQ
    g = torch.Generator("cuda").manual_seed(19)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g, device="cuda")
    key, img = _mm_extra(torch, cfg, b, g, torch.bfloat16)
    batch = {"tokens": tokens, key: img}
    step = make_prefill_step(model)
    step(params, batch)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, first_s, flash_calls, sw_calls = _counted_prefill(
        torch, fa, sw, "vlm_prefill", step, params, batch)
    _expect_calls("vlm_prefill", flash_calls, {
        VLM_SELF_SHAPE[:7] + ("wgmma",): n_super * (per + 1),
        VLM_CROSS_SHAPE[:7] + ("wgmma",): n_super})
    _expect_calls("vlm_prefill", sw_calls, {
        MM_SWIGLU["llama-3.2-vision-11b MLP"] + ("wgmma",): cfg.n_layers})
    check(logits.shape == (b, s, padded_vocab(cfg))
          and bool(logits.isfinite().all()),
          "vlm_prefill", f"logits {tuple(logits.shape)} not finite")
    times = _timed_steps(torch, step, params, batch, first_s)
    step_s = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = _moved(torch, step, params, batch, key,
                   _mm_extra(torch, cfg, b, g, torch.bfloat16)[1], logits)
    check(moved > 1e-3, "vlm_prefill",
          f"a second image moved the logits by {moved} only")
    arg_kernel = logits[..., :cfg.vocab].argmax(-1)
    del logits
    naive = build_model(dataclasses.replace(cfg, attention_impl="naive"))
    with torch.no_grad():
        logits_plain = naive.forward(params, batch)
    agree = (logits_plain[..., :cfg.vocab].argmax(-1) == arg_kernel) \
        .float().mean().item()
    del logits_plain, arg_kernel
    torch.cuda.empty_cache()
    emit({"phase": "vlm_prefill", "ok": True, "gpu": gpu, "arch": cfg.name,
          "params": n_params, "batch": b, "seq": s,
          "image_tokens": cfg.image_tokens, "dtype": cfg.dtype,
          "xgate": XGATE, "flash_launches": len(flash_calls),
          "swiglu_launches": len(sw_calls),
          "cross_launches": sum(1 for c in flash_calls if c[3] != c[4]),
          "step_s": step_s, "step_times_s": times,
          "tokens_per_s": b * s / step_s, "peak_gb": peak_gb,
          "image_moves_logits_rel": moved,
          "bf16_argmax_agreement_vs_plain": agree})
    _mm_generate(torch, fa, sw, gpu, cfg, model, params, "vlm_generate")
    del params
    torch.cuda.empty_cache()

    # (b) fp32 at full width and depth 10: kernel path against naive
    cfg32, model32, params32 = _mm_model(VLM_ARCH, dtype="float32",
                                         n_layers=VLM_FP32_DEPTH)
    n_super32 = vlm_layout(cfg32)[0]
    batch32 = {"tokens": tokens,
               key: _mm_extra(torch, cfg32, b, g, torch.float32)[1]}
    pos = [0, 511, s - 1]
    _zero(fa, sw)
    with torch.no_grad():
        a = model32.forward(params32, batch32)[:, pos].float()
    check(_only(fa, "simt", cfg32.n_layers + n_super32)
          and _only(sw, "simt", cfg32.n_layers), "vlm_fp32_parity",
          f"launches {fa.LAUNCHES_BY_VARIANT} {sw.LAUNCHES_BY_VARIANT}, "
          "expected all simt")
    with torch.no_grad():
        ref = build_model(dataclasses.replace(cfg32, attention_impl="naive")) \
            .forward(params32, batch32)[:, pos].float()
    rel = ((a - ref).abs().max() / ref.abs().max()).item()
    del params32, a, ref
    torch.cuda.empty_cache()
    ok = rel <= LOGITS_REL_TOL
    emit({"phase": "vlm_fp32_parity", "ok": ok, "layers": cfg32.n_layers,
          "batch": b, "seq": s, "positions": pos,
          "flash_launches": dict(fa.LAUNCHES_BY_VARIANT),
          "max_rel_err": rel, "tol": LOGITS_REL_TOL})
    check(ok, "vlm_fp32_parity", f"max_rel_err {rel}")
    return flash_calls, sw_calls


def _whisper_prefill(torch, fa, sw, gpu):
    """(c) and (e) for whisper-tiny; returns the prefill's flash and
    SwiGLU calls."""
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.train.step import make_prefill_step

    cfg, model, params = _mm_model(WHISPER_ARCH)
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == WHISPER_PARAMS, "whisper_prefill",
          f"{n_params} parameters, the reference's tree has "
          f"{WHISPER_PARAMS}")
    b, s = WHISPER_BATCH, WHISPER_SEQ
    g = torch.Generator("cuda").manual_seed(29)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g, device="cuda")
    key, frames = _mm_extra(torch, cfg, b, g, torch.bfloat16)
    batch = {"tokens": tokens, key: frames}
    step = make_prefill_step(model)
    step(params, batch)                          # warm-up
    torch.cuda.synchronize()
    logits, first_s, flash_calls, sw_calls = _counted_prefill(
        torch, fa, sw, "whisper_prefill", step, params, batch)
    _expect_calls("whisper_prefill", flash_calls, {
        WHISPER_ENC_SHAPE[:7] + ("wgmma",): cfg.encoder_layers})
    _expect_calls("whisper_prefill", sw_calls, {
        MM_SWIGLU["whisper-tiny encoder MLP"] + ("wgmma",):
            cfg.encoder_layers,
        MM_SWIGLU["whisper-tiny decoder MLP"] + ("wgmma",): cfg.n_layers})
    pv = padded_vocab(cfg)
    check(logits.shape == (b, s, pv) and bool(logits.isfinite().all()),
          "whisper_prefill", f"logits {tuple(logits.shape)} not finite")
    times = _timed_steps(torch, step, params, batch, first_s)
    moved = _moved(torch, step, params, batch, key,
                   _mm_extra(torch, cfg, b, g, torch.bfloat16)[1], logits)
    check(moved > 1e-3, "whisper_prefill",
          f"other frames moved the logits by {moved} only")
    del logits
    step_s = statistics.median(times)
    emit({"phase": "whisper_prefill", "ok": True, "gpu": gpu,
          "arch": cfg.name, "params": n_params, "batch": b, "seq": s,
          "frames": cfg.encoder_seq, "dtype": cfg.dtype, "xgate": XGATE,
          "flash_launches": len(flash_calls),
          "swiglu_launches": len(sw_calls), "step_s": step_s,
          "step_times_s": times, "tokens_per_s": b * s / step_s,
          "frames_move_logits_rel": moved})
    _mm_generate(torch, fa, sw, gpu, cfg, model, params, "whisper_generate")

    # fp32 at full width and depth: kernel path against naive
    cfg32, model32, params32 = _mm_model(WHISPER_ARCH, dtype="float32")
    batch32 = {"tokens": tokens,
               key: _mm_extra(torch, cfg32, b, g, torch.float32)[1]}
    _zero(fa, sw)
    with torch.no_grad():
        a = model32.forward(params32, batch32)
    check(_only(fa, "simt", cfg32.encoder_layers)
          and _only(sw, "simt", cfg32.encoder_layers + cfg32.n_layers),
          "whisper_fp32_parity",
          f"launches {fa.LAUNCHES_BY_VARIANT} {sw.LAUNCHES_BY_VARIANT}, "
          "expected all simt")
    with torch.no_grad():
        ref = build_model(dataclasses.replace(cfg32, attention_impl="naive")) \
            .forward(params32, batch32)
    rel = ((a - ref).abs().max() / ref.abs().max()).item()
    ok = rel <= LOGITS_REL_TOL and bool(a.isfinite().all())
    emit({"phase": "whisper_fp32_parity", "ok": ok,
          "layers": [cfg32.encoder_layers, cfg32.n_layers], "batch": b,
          "seq": s, "max_rel_err": rel, "tol": LOGITS_REL_TOL})
    check(ok, "whisper_fp32_parity", f"max_rel_err {rel}")
    del params, params32, a, ref
    torch.cuda.empty_cache()
    return flash_calls, sw_calls


def _mm_generate(torch, fa, sw, gpu, cfg, model, params, phase):
    """(e) ``MM_GENERATE`` through the server's ``generate``: the state
    filled token by token, then greedy decode; one SwiGLU launch per
    decoder layer per decode step, no flash launch."""
    from repro_torch.launch.serve import generate

    n_req, plen, gen_tokens = MM_GENERATE
    g = torch.Generator("cuda").manual_seed(31)
    prompts = torch.randint(0, cfg.vocab, (n_req, plen), generator=g,
                            device="cuda")
    generate(model, params, prompts[:, :4], 2)            # warm-up
    _zero(fa, sw)
    out = generate(model, params, prompts, gen_tokens)
    toks = out.tokens
    steps = plen + gen_tokens
    check(out.mode == "sequential", phase, f"mode {out.mode}")
    check(fa.LAUNCHES == 0 and _only(sw, "wgmma", cfg.n_layers * steps),
          phase, f"flash {fa.LAUNCHES}, SwiGLU {sw.LAUNCHES_BY_VARIANT}: "
          f"expected 0 and {cfg.n_layers} x {steps} wgmma")
    check(toks.shape == (n_req, gen_tokens)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          phase, f"tokens {tuple(toks.shape)} out of range")
    emit({"phase": phase, "ok": True, "gpu": gpu, "requests": n_req,
          "prompt": plen, "gen_tokens": gen_tokens, "mode": out.mode,
          "prefill_ms": out.prefill_s * 1e3,
          "prefill_tokens_per_s": n_req * plen / out.prefill_s,
          "decode_ms": out.decode_s * 1e3,
          "decode_tokens_per_s": n_req * gen_tokens / out.decode_s,
          "swiglu_launches": sw.LAUNCHES,
          "first_request_tokens": toks[0].tolist()})


# ---------------------------------------------------------------------------
# 22. train_multimodal: llama-3.2-vision-11b and whisper-tiny trained
# ---------------------------------------------------------------------------

# (h) llama-3.2-vision-11b at full width, depth 40 -> 5 (one super-block
# of 4 self + 1 cross block; all 40 layers' fp32 params, grads and AdamW
# moments need 162 GB),
# cut to keep the whole run near its time target, train_4k's 4096
# tokens against 1600 image embeddings, global batch 256 -> 2 in 2
# micro-batches; (i) whisper-tiny at full width and depth, 4096 decoder
# tokens against 1500 frames, batch 256 -> 8 in 2 micro-batches of 4
MM_TRAIN_SEQ, MM_TRAIN_STEPS, MM_TRAIN_MICRO = 4096, 3, 2
VLM_TRAIN_DEPTH, VLM_TRAIN_BATCH, WHISPER_TRAIN_BATCH = 5, 2, 8
# (j) fp32, every tag recomputed: the vlm at depth 5 (one super-block)
# against 1600 image tokens, whisper at full depth against 1500 frames
MM_FP32_SEQ, VLM_FP32_TRAIN_DEPTH = 1024, 5
# the kernels' calls in one micro-batch of (h) and (i): flash (b, hq, hkv,
# sq, skv, d, causal, block_q, block_kv), SwiGLU (e, m, k, f)
MM_TRAIN_FLASH = {
    "llama-3.2-vision-11b self-attention":
        (1, 32, 8, 4096, 4096, 128, True, 512, 1024),
    "llama-3.2-vision-11b cross-attention":
        (1, 32, 8, 4096, 1600, 128, False, 512, 1024),
    "whisper-tiny encoder": (4, 6, 6, 1500, 1500, 64, False, 512, 1024),
    "whisper-tiny decoder self-attention":
        (4, 6, 6, 4096, 4096, 64, True, 512, 1024),
    "whisper-tiny cross-attention":
        (4, 6, 6, 4096, 1500, 64, False, 512, 1024)}
MM_TRAIN_SWIGLU = {"llama-3.2-vision-11b MLP": (1, 4096, 4096, 14336),
                   "whisper-tiny encoder MLP": (1, 6000, 384, 1536),
                   "whisper-tiny decoder MLP": (1, 16384, 384, 1536)}


def _train_multimodal_rows(torch, fa, sw, gpu):
    """The train_multimodal phase, then its eight kernel rows: each kernel
    timed at its train step's shape, with the launches of (h) and (i)."""
    t_start = time.perf_counter()
    rows = {}
    for path, shape in MM_TRAIN_FLASH.items():
        rows[path] = _flash_times(torch, fa, gpu, shape, path.split(" ")[0])
        rows[path]["path"] = f"{path}, train step (forward and replays)"
    for path, case in MM_TRAIN_SWIGLU.items():
        rows[path] = _swiglu_times(torch, sw, gpu, case, path)
        rows[path]["path"] = f"{path}, train step (forward and replays)"
    torch.cuda.empty_cache()
    _cross_backward_times(torch, gpu)
    flash_calls, sw_calls = phase_train_multimodal(torch, fa, sw, gpu)
    for path, shape in MM_TRAIN_FLASH.items():
        rows[path]["launches"] = sum(
            1 for c in flash_calls if c[:7] == tuple(shape[:7]))
    for path, case in MM_TRAIN_SWIGLU.items():
        rows[path]["launches"] = sum(
            1 for c in sw_calls if c[:4] == tuple(case))
    emit({"phase": "train_multimodal", "ok": True,
          "wall_s": time.perf_counter() - t_start,
          "launches": {p: r["launches"] for p, r in rows.items()}})
    return list(rows.values())


def _cross_backward_times(torch, gpu):
    """One cross-attention call's backward alone at each family's train
    shape, bf16: ``flash_attention_bwd`` (the blockwise recompute, issued
    op by op), its host time to issue and its time on the card's clock."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    out = {}
    for path in ("llama-3.2-vision-11b cross-attention",
                 "whisper-tiny cross-attention"):
        b, hq, hkv, sq, skv, d, causal, bq, bkv = MM_TRAIN_FLASH[path]
        g = torch.Generator("cuda").manual_seed(88)

        def rnd(*shape):
            return torch.randn(shape, generator=g,
                               device="cuda").to(torch.bfloat16)

        q, k, v, do = rnd(b, sq, hq, d), rnd(b, skv, hkv, d), \
            rnd(b, skv, hkv, d), rnd(b, sq, hq, d)

        def bwd():
            return flash_ops.flash_attention_bwd(q, k, v, do, causal, bq,
                                                 bkv)

        bwd()
        torch.cuda.synchronize()
        host, card = [], []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            bwd()
            e1.record()
            host.append((time.perf_counter() - t0) * 1e3)
            e1.synchronize()
            card.append(e0.elapsed_time(e1))
        out[path] = {"shape": [b, hq, hkv, sq, skv, d], "host_ms":
                     statistics.median(host), "card_ms":
                     statistics.median(card)}
        del q, k, v, do
    torch.cuda.empty_cache()
    emit({"phase": "cross_backward", "ok": True, "gpu": gpu,
          "calls": out, "note": "flash_attention_bwd alone, bf16, median of "
                                "3; host_ms is the time to issue it"})


def _mm_producer(cfg, seq_len):
    """``synthetic_lm_producer``'s tokens plus the stubbed frontend's
    embeddings: (T, d) standard normals from the example's own seed."""
    import numpy as np

    from repro_torch.data.pipeline import synthetic_lm_producer

    tokens = synthetic_lm_producer(cfg.vocab, seq_len)
    key, t = (("image_embeds", cfg.image_tokens) if cfg.family == "vlm"
              else ("enc_frames", cfg.encoder_seq))

    def produce(epoch, index, rng):
        ex = tokens(epoch, index, rng)
        g = np.random.default_rng((epoch * 7919 + index) & 0x7FFFFFFF)
        ex[key] = g.standard_normal((t, cfg.d_model), dtype=np.float32)
        return ex

    return produce


def _mm_region_tags(cfg, b, s):
    """Per checkpoint region of one micro-batch of ``b`` sequences of
    ``s`` tokens, bf16: (the bytes of each tag it keeps, its input bytes).
    A vlm super-block keeps q and the attention output of each of its
    ``per`` self blocks' attentions and of the cross block's two, and each
    SwiGLU hidden; its input is x and the image.  whisper: the encoder's
    blocks, then the decoder's (two attentions each; input x and the
    encoder's output)."""
    from repro_torch.models.multimodal import vlm_layout

    def times(tags, attn, mlp):
        return {"qkv": attn * tags["qkv"], "attn_out": attn * tags["attn_out"],
                "mlp_hidden": mlp * tags["mlp_hidden"]}

    row = cfg.d_model * 2
    if cfg.family == "vlm":
        n_super, per = vlm_layout(cfg)
        kept = times(_tagged_bytes(cfg, b * s, 2), per + 2, per + 1)
        return [(kept, (b * s + b * cfg.image_tokens) * row)] * n_super
    ne, nd = b * cfg.encoder_seq, b * s
    enc = (_tagged_bytes(cfg, ne, 2), ne * row)
    dec = (times(_tagged_bytes(cfg, nd, 2), 2, 1), (nd + ne) * row)
    return [enc] * cfg.encoder_layers + [dec] * cfg.n_layers


def _mm_expected_calls(cfg, b, s, runs, again=False):
    """{(flash or SwiGLU call key, variant): launches} of ``runs``
    micro-batches of ``b`` x ``s``: each attention and MLP once in the
    forward, and once more in its region's replay when ``again`` (every
    tag recomputed)."""
    from repro_torch.models.multimodal import vlm_layout

    variant = "wgmma" if cfg.dtype == "bfloat16" else "simt"
    hq, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = runs * (2 if again else 1)

    def fkey(bb, sq, skv, causal):
        return (bb, hq, kv, sq, skv, hd, causal, variant)

    def skey(m):
        return (1, m, cfg.d_model, cfg.d_ff, variant)

    if cfg.family == "vlm":
        n_super, per = vlm_layout(cfg)
        layers = n_super * (per + 1)
        flash = {fkey(b, s, s, True): layers * n,
                 fkey(b, s, cfg.image_tokens, False): n_super * n}
        return flash, {skey(b * s): layers * n}
    t = cfg.encoder_seq
    flash = {fkey(b, t, t, False): cfg.encoder_layers * n,
             fkey(b, s, s, True): cfg.n_layers * n,
             fkey(b, s, t, False): cfg.n_layers * n}
    swiglu = {skey(b * t): cfg.encoder_layers * n,
              skey(b * s): cfg.n_layers * n}
    return flash, swiglu


def _device_idle_share(torch, fn):
    """(wall s, device busy s, idle share) of ``fn()`` under
    ``torch.profiler``: busy is the kernels' device time (copies apart)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("Memcpy") \
                or e.key == "Command Buffer Full":
            continue
        busy_us += float(getattr(e, "self_device_time_total", 0.0)
                         or getattr(e, "self_cuda_time_total", 0.0))
    return wall, busy_us / 1e6, 1 - busy_us / 1e6 / wall


class _HostTimed:
    """Wraps ``flash_attention_bwd``: the host's time in each call, apart
    for cross-attention's calls (Sq != Skv) and self-attention's."""

    def __init__(self, fn):
        self.fn, self.ms = fn, {"self": [], "cross": []}

    def __call__(self, q, k, v, *rest):
        t0 = time.perf_counter()
        out = self.fn(q, k, v, *rest)
        kind = "cross" if q.shape[1] != k.shape[1] else "self"
        self.ms[kind].append((time.perf_counter() - t0) * 1e3)
        return out


def phase_train_multimodal(torch, fa, sw, gpu):
    """(h) llama-3.2-vision-11b and (i) whisper-tiny trained through
    ``Trainer``; (j) the kernel path against the plain path in fp32.
    Returns the flash and SwiGLU call keys of (h) and (i)."""
    import gc

    torch.cuda.empty_cache()
    flash_calls, sw_calls = _train_mm_full(torch, fa, sw, gpu,
                                           "llama-3.2-vision-11b")
    gc.collect()
    torch.cuda.empty_cache()
    calls = _train_mm_full(torch, fa, sw, gpu, "whisper-tiny")
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ("llama-3.2-vision-11b", "whisper-tiny"):
        _train_mm_fp32(torch, fa, sw, arch)
        gc.collect()
        torch.cuda.empty_cache()
    return flash_calls + calls[0], sw_calls + calls[1]


def _train_mm_full(torch, fa, sw, gpu, arch):
    """(h) or (i): ``Trainer`` with a multimodal producer at full width,
    the cuts above, the default keep-all plan, every xgate at ``XGATE``;
    then one more step profiled for the device's idle share."""
    import gc

    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import SHAPES
    from repro_torch.core import remat
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig

    vlm = arch == "llama-3.2-vision-11b"
    part = "h" if vlm else "i"
    cfg = dataclasses.replace(ARCHS[arch], attention_impl="pallas")
    batch = VLM_TRAIN_BATCH if vlm else WHISPER_TRAIN_BATCH
    cuts = {"global_batch": [256, batch, "the fp32 state and one "
                             "micro-batch's activations fill the card"
                             if vlm else "two micro-batches of 4 keep the "
                             "logits (4 x 4096 x 51968) near 5 GB"]}
    if vlm:
        cfg = dataclasses.replace(cfg, n_layers=VLM_TRAIN_DEPTH)
        cuts["n_layers"] = [40, VLM_TRAIN_DEPTH, "40 layers' fp32 params, "
                            "grads and AdamW moments are 162 GB"]
    b = batch // MM_TRAIN_MICRO
    s = MM_TRAIN_SEQ
    runs = MM_TRAIN_STEPS * MM_TRAIN_MICRO
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=s,
                                global_batch=batch)
    want_flash, want_sw = _mm_expected_calls(cfg, b, s, runs)
    tags = _mm_region_tags(cfg, b, s)
    n_mlp = sum(want_sw.values())
    twins = {"flash": _Counted(fa.flash_attention_fwd_plain),
             "swiglu": _Counted(sw.fused_swiglu_plain)}
    timer = _HostTimed(flash_ops.flash_attention_bwd)
    saved = (fa.flash_attention_fwd_plain, sw.fused_swiglu_plain,
             flash_ops.flash_attention_bwd)
    fa.flash_attention_fwd_plain = twins["flash"]
    sw.fused_swiglu_plain = twins["swiglu"]
    flash_ops.flash_attention_bwd = timer
    try:
        trainer = Trainer(_gated(build_model(cfg)), make_optimizer("adamw"),
                          shape, TrainerConfig(steps=MM_TRAIN_STEPS,
                                               log_every=1),
                          producer=_mm_producer(cfg, s),
                          microbatches=MM_TRAIN_MICRO)
        _zero(fa, sw)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with remat.observe_regions() as stats, \
                _launch_calls(fa, _flash_key) as flash_calls, \
                _launch_calls(sw, _swiglu_key) as sw_calls:
            out = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        twin_calls = {k: t.calls for k, t in twins.items()}
        bwd_ms = {k: list(v) for k, v in timer.ms.items()}
    finally:
        (fa.flash_attention_fwd_plain, sw.fused_swiglu_plain,
         flash_ops.flash_attention_bwd) = saved
    check(fa.LAUNCHES == len(flash_calls) and sw.LAUNCHES == len(sw_calls),
          "train_multimodal", "a launch escaped the recorder")
    params, opt_state = out["params"], out["opt_state"]
    named = dict(params.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    reached = {n: float(p.grad.abs().max()) for n, p in named.items()
               if ".xattn." in n or n.startswith("enc_")}
    losses = [h["loss"] for h in out["history"]]
    times = [h["time_s"] for h in out["history"]]
    step_s = statistics.median(times[1:])
    tokens = s * batch

    # one more step, profiled: the device's idle share
    examples = [_mm_producer(cfg, s)(0, 1000 + i, None)
                for i in range(batch)]
    dev_batch = {k: torch.from_numpy(np.stack([ex[k] for ex in examples]))
                 .cuda() for k in examples[0]}
    prof_wall, busy_s, idle = _device_idle_share(
        torch, lambda: trainer.step_fn(params, opt_state, dev_batch))
    del out, params, opt_state, named, trainer, dev_batch
    gc.collect()
    torch.cuda.empty_cache()

    per_micro = len(tags)
    regions_ok = len(stats) == per_micro * runs and all(
        st.replays == 1 and st.offloaded == {}
        and st.kept == tags[i % per_micro][0]
        and st.input_bytes == tags[i % per_micro][1]
        for i, st in enumerate(stats))
    kept_bytes = sum(sum(k.values()) + x for k, x in tags)
    reckoned = {"params": 4 * n_params, "grads": 4 * n_params,
                "adamw_moments": 8 * n_params,
                "kept_tags_and_region_inputs": kept_bytes,
                "loss_logits_bf16_and_fp32":
                    b * s * padded_vocab(cfg) * (2 + 4)}
    ok = (all(math.isfinite(v) for v in losses)
          and abs(losses[0] - math.log(cfg.vocab)) <= 1.0
          and _counts(flash_calls) == want_flash
          and _counts(sw_calls) == want_sw
          and twin_calls == {"flash": 0, "swiglu": n_mlp}
          and regions_ok and peak <= 80e9
          and bool(reached) and min(reached.values()) > 0)
    cross_ms = bwd_ms["cross"]
    emit({"phase": "train_multimodal", "part": part, "arch": arch, "ok": ok,
          "gpu": gpu, "entry": "Trainer(build_model(cfg), adamw, shape, "
                               "TrainerConfig(steps), producer=..., "
                               "microbatches=2).run()",
          "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
          "seq": s, "batch": batch, "microbatches": MM_TRAIN_MICRO,
          "steps": MM_TRAIN_STEPS, "xgate": XGATE, "cuts": cuts,
          "params": n_params, "losses": losses,
          "ln_vocab": math.log(cfg.vocab), "step_s": times,
          "step_s_median_after_1": step_s, "tokens_per_s": tokens / step_s,
          "mfu_6nt": 6 * n_params * tokens / step_s
          / _peak_flops("bfloat16"),
          "wall_s": wall, "peak_bytes": peak, "reckoned_bytes": reckoned,
          "regions": len(stats), "regions_per_microbatch": per_micro,
          "region_kept_bytes": [t[0] for t in tags[:2]] + (
              [tags[-1][0]] if not vlm else []),
          "measured_kept_bytes": [st.kept for st in stats[:2]]
          + ([stats[per_micro - 1].kept] if stats and not vlm else []),
          "regions_ok": regions_ok,
          "flash_bwd_host_ms_per_step": {
              k: sum(v) / MM_TRAIN_STEPS for k, v in bwd_ms.items()},
          "flash_bwd_cross_host_ms_per_call":
              statistics.median(cross_ms) if cross_ms else None,
          "flash_bwd_host_share_of_wall":
              sum(map(sum, bwd_ms.values())) / 1e3 / sum(times),
          "profiled_step_s": prof_wall, "profiled_device_busy_s": busy_s,
          "device_idle_share": idle,
          "kernel_launches": {"flash": len(flash_calls),
                              "swiglu": len(sw_calls)},
          "launches_by_call": {str(k): v for k, v in
                               _counts(flash_calls + sw_calls).items()},
          "expected_by_call": {str(k): v for k, v in
                               {**want_flash, **want_sw}.items()},
          "twin_calls": twin_calls,
          "min_cross_or_encoder_grad_max": min(reached.values())
          if reached else None})
    check(ok, "train_multimodal", f"({part}) {arch}: losses {losses}, "
          f"flash {_counts(flash_calls)} vs {want_flash}, SwiGLU "
          f"{_counts(sw_calls)} vs {want_sw}, twins {twin_calls}, regions "
          f"{regions_ok} ({len(stats)}), peak {peak}")
    return flash_calls, sw_calls


def _train_mm_fp32(torch, fa, sw, arch):
    """(j) fp32 at full width, every tag recomputed (each kernel launched
    again in its region's replay), every xgate at ``XGATE``: the kernel
    path (flash and SwiGLU simt) against the plain path (the twins in the
    wrappers' place) on the card, the loss within 1e-4 and every grad of
    the whole model normwise within 1e-4."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.model import build_model

    vlm = arch == "llama-3.2-vision-11b"
    over = dict(n_layers=VLM_FP32_TRAIN_DEPTH) if vlm else {}
    cfg = dataclasses.replace(ARCHS[arch], attention_impl="pallas",
                              dtype="float32", remat_budget_bytes=0, **over)
    model = _gated(build_model(cfg))
    params = model.init(0, trainable=True)
    b = 1 if vlm else 2
    g = torch.Generator("cuda").manual_seed(47)
    toks = torch.randint(0, cfg.vocab, (b, MM_FP32_SEQ + 1), generator=g,
                         device="cuda")
    key, extra = _mm_extra(torch, cfg, b, g, torch.float32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], key: extra}
    want_flash, want_sw = _mm_expected_calls(cfg, b, MM_FP32_SEQ, 1,
                                             again=True)
    flash_fwd, swiglu_fwd = flash_ops.flash_attention_fwd, sw._forward
    try:
        _zero(fa, sw)
        with _launch_calls(fa, _flash_key) as flash_calls, \
                _launch_calls(sw, _swiglu_key) as sw_calls:
            loss, grads = _loss_and_grads(torch, model, params, batch)
        flash_ops.flash_attention_fwd = fa.flash_attention_fwd_plain
        sw._forward = sw.fused_swiglu_plain
        _zero(fa, sw)
        want_loss, want = _loss_and_grads(torch, model, params, batch)
        plain_launches = fa.LAUNCHES + sw.LAUNCHES
    finally:
        flash_ops.flash_attention_fwd, sw._forward = flash_fwd, swiglu_fwd
    errs = {n: ((grads[n] - w).abs().max() / w.abs().max()).item()
            for n, w in want.items() if bool(w.any())}
    zero = [n for n, w in want.items() if not bool(w.any())]
    loss_rel = abs((loss - want_loss) / want_loss).item()
    worst = max(errs, key=errs.get)
    ok = (loss_rel <= GRAD_REL_TOL and errs[worst] <= GRAD_REL_TOL
          and not zero and _counts(flash_calls) == want_flash
          and _counts(sw_calls) == want_sw and plain_launches == 0)
    emit({"phase": "train_multimodal", "part": "j", "arch": arch, "ok": ok,
          "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
          "batch": b, "seq": MM_FP32_SEQ,
          "kv_tokens": cfg.image_tokens if vlm else cfg.encoder_seq,
          "xgate": XGATE, "loss": loss.item(), "loss_rel": loss_rel,
          "max_grad_rel": errs[worst], "worst_grad": worst,
          "zero_grads": zero, "tol": GRAD_REL_TOL,
          "kernel_launches": {"flash": len(flash_calls),
                              "swiglu": len(sw_calls)},
          "launches_by_call": {str(k): v for k, v in
                               _counts(flash_calls + sw_calls).items()},
          "plain_path_launches": plain_launches})
    check(ok, "train_multimodal", f"(j) {arch}: loss rel {loss_rel}, grad "
          f"{worst} {errs[worst]}, zero grads {zero}, launches "
          f"{_counts(flash_calls)} vs {want_flash}")
    del params, grads, want
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 23. the paper's examples on the card
# ---------------------------------------------------------------------------

EXAMPLES = ("torch_quickstart", "torch_personalize_transfer",
            "torch_tts_unroll", "torch_distributed_pretrain")


def _example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quickstart_swiglu_launches(quickstart):
    """The SwiGLU launches the quickstart's reduced LM (2 layers) makes:
    one a layer in each train step's forward, ``resume_steps`` steps in
    all (``train_steps``, then the rest after the restart from the last
    checkpoint; the keep-all plan replays nothing, the backward is the
    twin's).  Its S = 64 takes the naive attention path: no flash."""
    import inspect

    steps = inspect.signature(quickstart.main).parameters["resume_steps"]
    return 2 * steps.default


def _pretrain_swiglu_launches(pretrain):
    """The SwiGLU launches the pretrain example makes at its defaults: one
    a layer in each train step's forward (remat off: no replay; the
    backward is the twin's)."""
    steps = pretrain.parser().get_default("steps")
    return pretrain.make_100m_config().n_layers * steps


def _swiglu_fp32_row(torch, sw, gpu, case, path):
    """The SwiGLU kernel at ``case`` in fp32 (the variant its wrapper
    chooses) against its plain twin, and the times of both and of one
    cuBLAS product with [Wg | Wu], in turns, in this call."""
    x, wg, wu = _swiglu_inputs(torch, case, torch.float32, seed=321)
    variant = sw.variant_for(x, wg, wu)
    out = sw.fused_swiglu(x, wg, wu)
    ok, err = _compare(out, sw.fused_swiglu_plain(x, wg, wu),
                       **TOL["float32"])
    check(ok and bool(out.isfinite().all()), "examples",
          f"fused_swiglu {case} float32 {variant}: max_abs_err {err}")
    w_cat = torch.cat([wg, wu], dim=-1)
    ms, plain_ms, library_ms = _in_turns(torch, [
        (lambda: sw.fused_swiglu(x, wg, wu), 20),
        (lambda: sw.fused_swiglu_plain(x, wg, wu), 20),
        (lambda: torch.matmul(x, w_cat), 20)])
    bound_ms, bound_by, flops, nbytes = swiglu_bound(case, "float32")
    emit({"phase": "kernel_times", "ok": True, "gpu": gpu,
          "kernel": "fused_swiglu", "path": path,
          "shape": dict(zip("e m k f".split(), case)), "dtype": "float32",
          "variant": variant, "kernel_ms": ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "roofline_share": bound_ms / ms})
    del x, wg, wu, out, w_cat
    return {"name": "fused_swiglu", "route": "cuda", "variant": variant,
            "source": "src/repro_torch/kernels/fused_swiglu/csrc/"
                      + sw.SOURCES[variant].name,
            "replaces": "src/repro/kernels/fused_swiglu/kernel.py:56",
            "path": path, "shape": list(case), "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_examples(torch, kernels, gpu):
    """The four examples' ``main`` on the card at their default sizes,
    each with its own assertions (a falling loss among them); their
    output is kept in build/example_logs/ and their wall times printed.  The
    paper's graph path launches no kernel of the transformer path; the
    quickstart's reduced LM and the pretrain example's LM launch only the
    SwiGLU kernel, as many times as their train steps' forwards.  Returns
    the pretrain example's SwiGLU row."""
    import shutil

    out_dir = ROOT / "build" / "example_logs"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = out_dir / "torch_distributed_pretrain_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    walls, summary, launches = {}, {}, {}
    for name in EXAMPLES:
        log = out_dir / f"{name}.log"
        _zero(*kernels)
        t0 = time.perf_counter()
        example = _example(name)
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            if name == "torch_distributed_pretrain":
                out = example.main(["--ckpt-dir", str(ckpt_dir)])
            else:
                out = example.main()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = {m.__name__.split(".")[-2]: m.LAUNCHES
                          for m in kernels}
        want = dict.fromkeys(launches[name], 0)
        if name == "torch_quickstart":
            want["fused_swiglu"] = _quickstart_swiglu_launches(example)
        if name == "torch_distributed_pretrain":
            want["fused_swiglu"] = _pretrain_swiglu_launches(example)
        check(launches[name] == want, "examples",
              f"{name} launched {launches[name]}, expected {want}")
        if name == "torch_quickstart":
            summary[name] = {"loss_first": out["train"]["first"],
                             "loss_final": out["train"]["final"],
                             "async_overlap": out["async"]
                             ["achieved_overlap"],
                             "served": out["serve"]["serve"]["completed"]}
        elif name == "torch_distributed_pretrain":
            check(out["final_loss"] < out["first"], "examples",
                  f"{name}: loss {out['first']} -> {out['final_loss']}")
            times = sorted(h["time_s"] for h in out["history"][1:])
            summary[name] = {"loss_first": out["first"],
                             "loss_final": out["final_loss"],
                             "params": out["n_params"],
                             "logged_step_s_median": times[len(times) // 2],
                             "checkpoints": sorted(
                                 p.name for p in ckpt_dir.glob("step_*"))}
        else:
            summary[name] = {"loss_first": out["losses"][0],
                             "loss_last": out["losses"][-1],
                             "steps": len(out["losses"])}
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    _zero(*kernels)
    emit({"phase": "examples", "ok": True, "gpu": gpu, "wall_s": walls,
          "launches": launches, "results": summary})
    sw = next(m for m in kernels if m.__name__.endswith("fused_swiglu.kernel"))
    row = _swiglu_fp32_row(
        torch, sw, gpu, PRETRAIN_SWIGLU,
        "examples/torch_distributed_pretrain.py MLP, train step (fp32)")
    row["launches"] = launches["torch_distributed_pretrain"]["fused_swiglu"]
    _zero(*kernels)
    return row


# ---------------------------------------------------------------------------
# 24. the roofline of the timed cells
# ---------------------------------------------------------------------------

# (arch, kind, sequence, batch, micro-batches): the cells whose steps the
# earlier phases timed (train (a); the prefill phases at B 2, S 4096)
ROOFLINE_CELLS = [("llama3.2-3b", "train", 4096, 2, 2),
                  ("llama3.2-3b", "prefill", 4096, 2, 1),
                  ("granite-moe-1b-a400m", "prefill", 4096, 2, 1),
                  ("zamba2-7b", "prefill", 4096, 2, 1),
                  ("xlstm-1.3b", "prefill", 4096, 2, 1)]
LINEARITY_TOL = 1e-6
MATMUL_TOL = 0.01


def phase_roofline(torch, kernels, gpu):
    """``hw.measure()`` beside the data sheet, then each timed cell's cost
    probe (``launch/probe.py``, in probe mode: no kernel may launch) and
    roofline row, its ``mfu`` from the step time its phase measured.
    Gates: a third probe at 3 periods within ``LINEARITY_TOL`` of the
    extrapolation (llama3.2-3b's train step, AdamW and replays included),
    one llama3.2-3b forward period's matmul FLOPs within ``MATMUL_TOL`` of
    the count reckoned from the config's shapes, every ``mfu`` and
    ``roofline_fraction`` at most 1."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import hw, probe, roofline

    t_phase = time.perf_counter()
    rates = hw.measure()
    emit({"phase": "roofline", "part": "rates", "ok": True, "gpu": gpu,
          **rates})
    check(rates["gemm_bf16"]["of_peak"] <= 1 and rates["copy"]["of_peak"]
          <= 1, "roofline", f"a measured rate above the data sheet {rates}")
    rows = []
    for arch, kind, seq, batch, micro in ROOFLINE_CELLS:
        cfg = ARCHS[arch]
        shape = ShapeConfig(f"{kind}_{seq // 1024}k", seq, batch, kind)
        _zero(*kernels)
        t0 = time.perf_counter()
        p = probe.run_probe(cfg, shape, microbatches=micro)
        probe_s = time.perf_counter() - t0
        launched = {m.__name__.split(".")[-2]: m.LAUNCHES for m in kernels}
        check(not any(launched.values()), "roofline",
              f"{arch} {kind}: probe mode launched kernels {launched}")
        step_s = STEP_S[f"{arch} {kind}"]
        row = roofline.analyze(arch, shape, p["flops"], p["bytes"],
                               step_s=step_s, card=hw.peaks())
        row.update(gpu=gpu, microbatches=micro, probe_s=probe_s,
                   counted_flops=p["counted_flops"],
                   counted_bytes=p["counted_bytes"],
                   kernel_true=p["kernel_true"]["parts"],
                   update=p.get("update"),
                   flops_per_period=p["flops_per_period"],
                   bytes_per_period=p["bytes_per_period"],
                   peak_bytes=p["peak_bytes"],
                   param_bytes=p["param_bytes"])
        if (arch, kind) == ("llama3.2-3b", "train"):
            miss = probe.check_linearity(cfg, shape, p)
            row["linearity_miss"] = miss
            check(max(miss.values()) <= LINEARITY_TOL, "roofline",
                  f"3-period probe off the extrapolation by {miss}")
        if (arch, kind) == ("llama3.2-3b", "prefill"):
            want = probe.forward_period_matmul_flops(cfg, batch * seq)
            rel = abs(p["flops_per_period"] - want) / want
            row["period_matmul_flops_reckoned"] = want
            row["period_matmul_rel_err"] = rel
            check(rel <= MATMUL_TOL, "roofline",
                  f"one forward period's matmul FLOPs "
                  f"{p['flops_per_period']} vs reckoned {want}")
        check(row["mfu"] <= 1 and row["roofline_fraction"] <= 1, "roofline",
              f"{arch} {kind}: mfu {row['mfu']} roofline "
              f"{row['roofline_fraction']}")
        emit({"phase": "roofline", "part": "cell", "ok": True, **row})
        rows.append(row)
        torch.cuda.empty_cache()
    emit({"phase": "roofline", "ok": True, "gpu": gpu,
          "wall_s": time.perf_counter() - t_phase,
          "table": roofline.format_table(rows)})


# ---------------------------------------------------------------------------
# 25. dist: the train step on a (data, model) mesh
# ---------------------------------------------------------------------------

DIST_SEQ, DIST_BATCH = 4096, 2
DIST_K_DEPTH = {"float32": 2, "bfloat16": 4}
# (l): each model's depth: llama's 1 layer (cut from 2), the vlm's one
# self and one
# cross block, zamba2-7b's one group cut to three mamba layers, then the
# shared block (cut from six to keep the whole run near 900 s),
# granite-moe's 2 layers, whisper-tiny whole (4 + 4 blocks), xlstm-1.3b's
# one group (7 mLSTM blocks, then the sLSTM block)
DIST_DEPTH = {"llama3.2-3b": 1, "llama-3.2-vision-11b": 2, "zamba2-7b": 3,
              "granite-moe-1b-a400m": 2, "whisper-tiny": 4, "xlstm-1.3b": 8}
# (l)'s train shapes other than (DIST_SEQ, DIST_BATCH, 1 micro-batch):
# xlstm-1.3b's one group (7 mLSTM blocks, then the sLSTM block) at train
# (f)'s sequence, 2 micro-batches of 2 sequences (one a data rank)
DIST_SHAPES = {"xlstm-1.3b": (1024, 4, 2)}
# the models whose fp32 runs take every rank's mLSTM normaliser branches
# from the one-rank run (its rows and heads of them): at full width the
# kink max(|n|, exp(-m)) flips under a rounding of the projections, and
# xlstm-1.3b's kernel and twin paths, one rank each, part by 0.115 per
# leaf unpinned, 1.3e-3 pinned (C.3, (g)).  Not in bf16: there two
# correct runs' inputs to the kink part by enough that one run's branch
# divides the other's by a near-zero |n| (the twin path pinned to the
# kernel path's branches: 134 normwise, 0.52 unpinned; PERF.md section 6)
DIST_PINNED_RUNS = ("xlstm-1.3b",)
DIST_MESH = (2, 2)
# (l)'s multi-pod step: the reference's (pod, data, model) mesh at four
# ranks, llama3.2-3b at one layer in fp32 (the extras' model)
DIST_POD_MESH = (2, 1, 2)
DIST_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DIST_FLASH = {   # each rank's shapes on the (2, 2) mesh, one sequence
    "llama3.2-3b": (1, 12, 4, 4096, 4096, 128, True, 512, 1024),
    "llama-3.2-vision-11b self-attention":
        (1, 16, 4, 4096, 4096, 128, True, 512, 1024),
    "llama-3.2-vision-11b cross-attention":
        (1, 16, 4, 4096, 1600, 128, False, 512, 1024),
    "zamba2-7b shared block": (1, 16, 16, 4096, 4096, 112, True, 512, 1024),
    "granite-moe-1b-a400m": (1, 8, 4, 4096, 4096, 64, True, 512, 1024),
    "whisper-tiny encoder": (1, 3, 3, 1500, 1500, 64, False, 512, 1024),
    "whisper-tiny decoder self-attention":
        (1, 3, 3, 4096, 4096, 64, True, 512, 1024),
    "whisper-tiny cross-attention":
        (1, 3, 3, 4096, 1500, 64, False, 512, 1024)}
DIST_SWIGLU = {"llama3.2-3b MLP": (1, 4096, 3072, 4096),
               "llama-3.2-vision-11b MLP": (1, 4096, 4096, 7168),
               "zamba2-7b shared MLP": (1, 4096, 3584, 7168),
               # 16 of 32 experts, one group of 4096 tokens: capacity
               # ceil(4096 * 8 / 32 * 1.25) = 1280
               "granite-moe-1b-a400m experts": (16, 1280, 1024, 512),
               "whisper-tiny encoder MLP": (1, 1500, 384, 768),
               "whisper-tiny decoder MLP": (1, 4096, 384, 768)}
DIST_SSD = {"zamba2-7b mamba layer": (1, 4096, 56, 64, 64, 256)}
# each rank's mLSTM chunk call: one sequence of a micro-batch, 2 of the 4
# heads (b, s, h, p, chunk)
DIST_MLSTM = {"xlstm-1.3b mLSTM block": (1, 1024, 2, 1024, 256)}
# (l)'s decode: each family at DIST_DEPTH, 4 sequences whose lengths start
# 0-3 apart, a cache of 64, 4 steps from a zero state (the cross caches
# written from a seed), the step on (2, 2) against the one-rank step, in
# fp32 (logits and each state leaf normwise within 1e-4) and in bf16
# (within twice the one-rank bf16 run's own distance from the one-rank
# fp32 run, by logits and by leaf, at least 2e-2: the mesh's bf16 run is
# a second rounding of the same function)
DIST_DECODE_BATCH, DIST_DECODE_LEN, DIST_DECODE_STEPS = 4, 64, 4
DIST_DECODE_DTYPES = ("float32", "bfloat16")
DIST_DECODE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# each rank's SwiGLU calls at decode (2 sequences a data rank, one token):
# its mlp columns, or its 16 experts with one slot each (a group is one
# token: capacity ceil(1 * 8 / 32 * 1.25) = 1)
DIST_DECODE_SWIGLU = {
    "llama3.2-3b decode MLP": (1, 2, 3072, 4096),
    "llama-3.2-vision-11b decode MLP": (1, 2, 4096, 7168),
    "zamba2-7b decode shared MLP": (1, 2, 3584, 7168),
    "granite-moe-1b-a400m decode experts": (16, 2, 1024, 512),
    "whisper-tiny decode MLP": (1, 2, 384, 768),
    # batch 1 (it does not split: every rank holds the one sequence), the
    # rank's columns of the shared MLP: x (1, 3584), W (3584, 7168)
    "zamba2-7b batch-1 decode shared MLP": (1, 1, 3584, 7168)}
# (l)'s batch-1 decodes: each family at DIST_DEPTH, one sequence (the
# reference's rules then put the state's sequence over data: the caches'
# positions, the mLSTM state's key dim), DIST_DECODE_STEPS steps from a
# zero state at lengths from DIST_DECODE1_START, across the boundary of
# the data ranks' blocks of positions, in both dtypes, gated as the
# batch-4 decodes; every SwiGLU call one row
DIST_DECODE1_START = DIST_DECODE_LEN // 2 - 2
# zamba2-7b's long_500k decode on (2, 2): one shared-block group (6 mamba
# layers, then the shared block), its cache at all 524,288 positions
# filled with seeded normals (drawn in chunks of DIST_LONG_CHUNK positions
# from their own seeds, so that a rank draws only its blocks), 7.5 GB in
# bf16, 1.9 GB a rank; DIST_DECODE_STEPS tokens from DIST_LONG_START.  The
# mesh's bf16 run against the one-rank bf16 run, within twice the
# one-rank bf16 run's distance from the one-rank fp32 run
DIST_LONG_ARCH, DIST_LONG_DEPTH, DIST_LONG_LEN = "zamba2-7b", 6, 524288
DIST_LONG_START, DIST_LONG_CHUNK = DIST_LONG_LEN - 8, 4096
# llama3.2-3b at 1 layer, fp32: the train step and the prefill at a batch
# of 1 (it does not split over data: every rank takes the sequence) of
# DIST_SEQ, each gradient leaf within 1e-4 of one rank's; then
# DIST_INT8_STEPS steps of int8 AdamW at DIST_BATCH sequences: the
# moments within one quantisation step of one rank's own int8 steps (the
# q entries that differ counted), and rank 0 replays one rank's int8
# update on the mesh's own gradients: parameters within 1e-5
DIST_B1_ARCH, DIST_INT8_STEPS, DIST_INT8_LR = "llama3.2-3b", 2, 3e-4
# SwiGLU launches a rank makes in one decode step
DIST_DECODE_SWIGLU_CALLS = {"llama3.2-3b": 1, "llama-3.2-vision-11b": 2,
                            "zamba2-7b": 1, "granite-moe-1b-a400m": 2,
                            "whisper-tiny": 4, "xlstm-1.3b": 0}
# SwiGLU launches a rank makes in one step: one per MLP (each plan keeps
# the hidden, so no replay launches the kernel again)
DIST_SWIGLU_CALLS = {"llama3.2-3b": 1, "llama-3.2-vision-11b": 2,
                     "zamba2-7b": 1, "granite-moe-1b-a400m": 2,
                     "whisper-tiny": 8}
# (l)'s runs: fp32 on the vision LM and zamba2-7b (their blocks cover the
# other families' sharded ops but the experts; the CPU tests hold every
# family in fp32), bf16 on all five for the kernels' per-rank shapes
DIST_RUNS = {"llama3.2-3b": ("bfloat16",),
             "llama-3.2-vision-11b": ("float32", "bfloat16"),
             "zamba2-7b": ("float32", "bfloat16"),
             "granite-moe-1b-a400m": ("bfloat16",),
             "whisper-tiny": ("bfloat16",),
             "xlstm-1.3b": ("float32", "bfloat16")}
# the models whose fp32 leaves widen to SPREAD_FACTOR x the spread of two
# other correct one-rank runs where that exceeds 1e-4, as (g)'s SSD decay
# leaves (cancelling sums) and xlstm-1.3b's grads behind the normaliser
# (for a DIST_PINNED_RUNS model one such run: the twin path pinned to the
# kernel path's branches); the others keep the gate
DIST_SPREAD_RUNS = ("zamba2-7b", "xlstm-1.3b")
# the bf16 gradient gates of the models whose correct bf16 runs part by
# more than 2e-2 (whisper's scalar xgate, zamba's SSD decay leaves: sums
# of cancelling terms): fixed, twice the largest normwise distance between
# two correct one-rank bf16 runs on the card (the plain path and the
# 2-micro-batch step: zamba2-7b 0.0134, whisper-tiny 0.0187; PERF.md
# section 6).  Each of these runs is also measured against the
# one-rank fp32 gradient, beside the one-rank bf16 step's own distance
# from it
DIST_BF16_TOL = {"zamba2-7b": 0.027, "whisper-tiny": 0.038,
                 # xlstm-1.3b at depth 8: its one-rank kernel and twin
                 # paths part by 0.522 normwise in bf16 (the normaliser's
                 # kink, 1976 of 114,688 branches flipped; measured on
                 # one H100): the bf16 gradient is a weak check here, the
                 # pinned fp32 one carries the sharding's correctness
                 "xlstm-1.3b": 1.05}
# the most of a granite rank's token choices that may differ from the
# one-rank run's it replays (a one-ulp difference in the residual stream
# flips a near-tie; 2.7-2.9% measured on the card): a router that
# mis-ranked experts would flip most of them
DIST_FLIP_FRACTION = 0.05


def _capture(into, base=None):
    """An optimizer that keeps a copy of the grads it is handed (after the
    step's reductions) and then runs ``base``'s update; without ``base``
    it updates nothing and holds no state (fp32 AdamW's layout)."""
    import dataclasses

    from repro_torch.optim.optimizers import make_optimizer

    def update_(grads, state, params, *rest):
        into.update({n: g.detach().clone() for n, g in grads.items()})
        if base is not None:
            base.update_(grads, state, params, *rest)

    if base is None:
        return dataclasses.replace(make_optimizer("adamw"), init=dict,
                                   update_=update_)
    return dataclasses.replace(base, update_=update_)


def _dist_shape(arch):
    """(sequence, batch, micro-batches) of ``arch``'s (l) train run."""
    return DIST_SHAPES.get(arch, (DIST_SEQ, DIST_BATCH, 1))


def _dist_batch(torch, cfg, b, seed=17, seq=DIST_SEQ):
    g = torch.Generator("cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (b, seq + 1), generator=g,
                           device="cuda")
    batch = {"tokens": tokens[:, :-1].contiguous(),
             "targets": tokens[:, 1:].contiguous()}
    if cfg.family in ("vlm", "audio"):
        key, t = (("image_embeds", cfg.image_tokens) if cfg.family == "vlm"
                  else ("enc_frames", cfg.encoder_seq))
        batch[key] = torch.randn(b, t, cfg.d_model, generator=g,
                                 device="cuda")
    return batch


def _ssd_key(x, dt, A_log, B, C, variant):
    """(b, s, h, p, n, chunk, variant) of a chunked SSD call."""
    b, nc, q, h, p = x.shape
    return (b, nc * q, h, p, B.shape[-1], q, variant)


def _mlstm_key(q, k, v, li, lf, sm_scale, variant):
    """(b, s, h, p, chunk, variant) of a chunked mLSTM call."""
    b, nc, nq, h, p = q.shape
    return (b, nc * nq, h, p, nq, variant)


def _expert_swiglu_key(x, wg, wu, variant):
    """(e, m, k, f, variant) of a dense or an expert-form call."""
    e = wg.shape[0] if wg.dim() == 3 else 1
    return (e, x.numel() // (e * x.shape[-1]), x.shape[-1], wg.shape[-1],
            variant)


@contextlib.contextmanager
def _moe_routing(torch, pin=None, rows=slice(None)):
    """Each MoE router call's top-k experts (G, S, k), in call order
    (forward, then each replay): yields the list.  With ``pin``, an
    earlier run's list over the whole batch, each call takes its ``rows``
    of the pinned choices instead, and the list holds how many tokens'
    own choices differ (flips)."""
    from repro_torch.models import moe

    real, seen = moe._top_k_mask, []

    def route(probs, k):
        own = torch.topk(probs, k, dim=-1)[1]
        if pin is None:
            seen.append(own.detach().cpu())
            return real(probs, k)
        topi = pin[len(seen)][rows].to(probs.device)
        seen.append(int((own.sort(-1)[0] != topi.sort(-1)[0])
                        .any(-1).sum()))
        mask = torch.zeros_like(probs).scatter_(-1, topi, 1.0)
        weights = probs * mask
        return mask, weights / torch.clamp_min(
            weights.sum(-1, keepdim=True), 1e-9)

    moe._top_k_mask = route
    try:
        yield seen
    finally:
        moe._top_k_mask = real


def _dist_cfg(arch, **over):
    from repro_torch.configs import ARCHS
    extra = {"llama-3.2-vision-11b": {"cross_attn_every": DIST_DEPTH[arch]},
             "zamba2-7b": {"shared_attn_every": DIST_DEPTH[arch]}
             }.get(arch, {})
    return dataclasses.replace(ARCHS[arch], attention_impl="pallas",
                               **extra, **over)


def _normwise(torch, got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def phase_dist(torch, fa, ssd, ml, sw, gpu):
    """(k) one rank on the card; (l) four ranks sharing it.  Returns the
    kernel rows of (l)'s per-rank shapes."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k = _dist_one_rank(torch, fa, sw)
    emit({"phase": "dist_k", "ok": True, "wall_s": time.perf_counter() - t0,
          **k})
    torch.cuda.empty_cache()
    t_l = time.perf_counter()
    l_out = _dist_shared_card(torch)
    torch.cuda.empty_cache()
    l_out["wall_s"] = time.perf_counter() - t_l
    rows = {}
    twins = {"flash": _flash_twin_checks(torch, fa, list(DIST_FLASH.values()),
                                         phase="dist"),
             "swiglu": _swiglu_twin_checks(
                 torch, sw, list({**DIST_SWIGLU,
                                  **DIST_DECODE_SWIGLU}.values()),
                 phase="dist"),
             "ssd": _twin_checks(torch, ssd, "ssd_chunk",
                                 list(DIST_SSD.values()), _ssd_inputs,
                                 SSD_OUTPUTS, SSD_TOL, ssd_variant),
             "mlstm": _twin_checks(torch, ml, "mlstm_chunk",
                                   list(DIST_MLSTM.values()), _mlstm_inputs,
                                   MLSTM_OUTPUTS, MLSTM_TOL, mlstm_variant)}
    for path, case in DIST_SSD.items():
        rows[path] = _scan_row(torch, ssd, "ssd_chunk", case, _ssd_inputs,
                               ssd_bound, SSD_TOL, gpu, "zamba2-7b")
        rows[path]["path"] = (f"{path}, train step on the (2, 2) mesh "
                              "(one rank's heads, launches of all 4)")
        rows[path]["launches"] = l_out["scan_launches"][path]
    for path, case in DIST_MLSTM.items():
        rows[path] = _scan_row(torch, ml, "mlstm_chunk", case,
                               _mlstm_inputs, mlstm_bound, MLSTM_TOL, gpu,
                               "xlstm-1.3b")
        rows[path]["path"] = (f"{path}, train step on the (2, 2) mesh "
                              "(one rank's heads and sequence, launches of "
                              "all 4)")
        rows[path]["launches"] = l_out["scan_launches"][path]
    for path, shape in DIST_FLASH.items():
        rows[path] = _flash_times(torch, fa, gpu, shape, path.split(" ")[0])
        rows[path]["path"] = (f"{path}, train step on the (2, 2) mesh "
                              "(one rank's shape, launches of all 4)")
        rows[path]["launches"] = l_out["flash_launches"][path]
    for path, case in {**DIST_SWIGLU, **DIST_DECODE_SWIGLU}.items():
        rows[path] = _swiglu_times(torch, sw, gpu, case, path)
        step = "decode" if path in DIST_DECODE_SWIGLU else "train"
        rows[path]["path"] = (f"{path}, {step} step on the (2, 2) mesh "
                              "(one rank's shape, launches of all 4)")
        rows[path]["launches"] = l_out["swiglu_launches"][path]
    emit({"phase": "dist", "ok": True, "gpu": gpu,
          "wall_s": time.perf_counter() - t0, "l": l_out,
          "twin_checks": {n: len(r) for n, r in twins.items()},
          "launches": {p: r["launches"] for p, r in rows.items()}})
    return list(rows.values())


def _dist_one_rank(torch, fa, sw):
    """(k): a one-rank NCCL group, mesh (1, 1): llama3.2-3b's train step at
    full width through ``make_train_step(mesh=...)`` against the step
    without a mesh from the same parameters, 2 sequences of 4096 in 2
    micro-batches (train (a)'s); fp32 at depth 2 within 1e-6, bf16 at
    depth 4 normwise within 2e-2, the flash and SwiGLU launches by shape
    equal (bf16: train (a)'s shapes, all wgmma).  Then the same step on
    the multi-pod mesh (pod, data, model) = (1, 1, 1): its loss, every
    gradient and its launches bit for bit the (1, 1) step's."""
    from collections import Counter

    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.step import make_train_step

    rdv = ROOT / "build" / "chip_dist" / f"rendezvous_k_{os.getpid()}"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    out = {"backend": dist.get_backend()}
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        pod_mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        shape = ShapeConfig("train_4k", DIST_SEQ, TRAIN_BATCH, "train")
        for dtype, depth in DIST_K_DEPTH.items():
            cfg = _dist_cfg("llama3.2-3b", n_layers=depth, dtype=dtype)
            model = build_model(cfg)
            batch = _dist_batch(torch, cfg, TRAIN_BATCH)
            runs = []
            for where in (None, mesh, pod_mesh):
                grads = {}
                bundle = make_train_step(
                    model, _capture(grads, make_optimizer("adamw")), shape,
                    mesh=where, microbatches=TRAIN_MICRO)
                params = bundle.shard_params(model.init(0, trainable=True))
                state = bundle.init_state(params)
                _zero(fa, sw)
                with _launch_calls(fa, _flash_key) as fc, \
                        _launch_calls(sw, _swiglu_key) as sc:
                    _, _, metrics = bundle(params, state, batch)
                    loss = float(metrics["loss"])
                runs.append((loss, grads, Counter(fc), Counter(sc)))
                del params, state, bundle, metrics
                torch.cuda.empty_cache()
            (l1, g1, f1, s1), (l2, g2, f2, s2), (l3, g3, f3, s3) = runs
            pod_equal = l3 == l2 and f3 == f2 and s3 == s2 \
                and all(torch.equal(g3[n], g2[n]) for n in g2)
            check(pod_equal, "dist", f"(k) {dtype}: the (1, 1, 1) pod mesh "
                  f"step differs from the (1, 1) step (loss {l3} vs {l2})")
            del g3
            tol = 1e-6 if dtype == "float32" else 2e-2
            loss_rel = abs(l2 - l1) / abs(l1)
            if dtype == "float32":
                err = max(_normwise(torch, g2[n], g1[n]) for n in g1)
            else:
                err = _normwise(torch, torch.cat([g2[n].flatten()
                                                  for n in sorted(g1)]),
                                torch.cat([g1[n].flatten()
                                           for n in sorted(g1)]))
            check(math.isfinite(l2) and loss_rel <= tol and err <= tol,
                  "dist", f"(k) {dtype}: loss {l2} vs {l1}, grads {err}")
            check(f1 == f2 and s1 == s2, "dist",
                  f"(k) {dtype}: launches by shape differ on the mesh")
            if dtype == "bfloat16":
                runs_per = depth * TRAIN_MICRO
                check(f2 == Counter({(*TRAIN_FLASH_SHAPE[:7], "wgmma"):
                                     runs_per})
                      and s2 == Counter({(*TRAIN_SWIGLU_SHAPE, "wgmma"):
                                         runs_per}), "dist",
                      f"(k) launches {dict(f2)} {dict(s2)}")
            out[dtype] = {"depth": depth, "loss": l2, "loss_one_device": l1,
                          "pod_mesh_bit_for_bit": pod_equal,
                          "loss_rel": loss_rel, "grad_rel": err,
                          "flash_launches": sum(f2.values()),
                          "swiglu_launches": sum(s2.values())}
            del g1, g2
    finally:
        dist.destroy_process_group()
    return out


def _dist_shared_card(torch):
    """(l): the models of ``DIST_RUNS`` at full width and ``DIST_DEPTH``
    (every cross block's xgate 0.5), each in its dtypes: this process runs
    the one-rank step (no mesh) of every run from seeded parameters and
    writes the losses, grads and MoE routing under ``build/chip_dist/``
    (the bf16 step's grads in bf16, a rounding of 2^-9 against the
    normwise 2e-2), then frees the card; four ranks on this card, one gloo
    group, mesh (2, 2), draw the same parameters and batch from the same
    seeds, run the sharded steps one model at a time and hold their blocks
    of the loss and grads to the written ones."""
    import gc

    import torch.multiprocessing as mp

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_swiglu import kernel as sw
    from repro_torch.kernels.mlstm_scan import kernel as ml
    from repro_torch.kernels.ssm_scan import kernel as ssd
    from repro_torch.models.model import build_model
    from repro_torch.train.step import make_train_step

    out_dir = ROOT / "build" / "chip_dist"
    out_dir.mkdir(parents=True, exist_ok=True)
    spreads, anchors = {}, {}
    t_refs = time.perf_counter()
    for arch, dtypes in DIST_RUNS.items():
        seq, b, micro = _dist_shape(arch)
        shape = ShapeConfig("train_4k", seq, b, "train")
        model, params, batch = _dist_model(torch, arch)
        # an fp32 one-rank gradient for each bf16 run of DIST_BF16_TOL
        anchor = ("float32",) if arch in DIST_BF16_TOL \
            and "float32" not in dtypes else ()
        for dtype in anchor + dtypes:
            grads = {}
            run_model = build_model(dataclasses.replace(model.cfg,
                                                        dtype=dtype))
            step = make_train_step(run_model, _capture(grads), shape,
                                   microbatches=micro)
            pinned = arch in DIST_PINNED_RUNS and dtype == "float32"
            with _moe_routing(torch) as routing, \
                    (_normaliser_branches(torch) if pinned
                     else contextlib.nullcontext([])) as branches:
                _, _, metrics = step(params, {}, batch)
            # for DIST_SPREAD_RUNS in fp32, the spread of two other
            # correct one-rank runs, each leaf's: a plain path (the scans'
            # forwards by ssd_chunked, the other kernels by their twins),
            # as (g) takes it, and the step at 2 micro-batches, whose
            # halves of the batch are summed apart as the data ranks sum
            # theirs.  The SSD decay leaves (A_log, dt_bias) sum
            # cancelling terms whose value moves with the order and
            # rounding of the sums (C.3).  A pinned model's one such run
            # is the twin path with this run's normaliser branches
            top = {n: g.float().abs().max().item() for n, g in grads.items()}
            spread = dict.fromkeys(grads, 0.0)
            probes = ()
            if arch in DIST_SPREAD_RUNS and dtype == "float32":
                # (plain path's scans, micro-batches, branches to pin)
                probes = (("twin", micro, branches),) if pinned \
                    else (("chunked", 1, None), (None, 2, None))
            for scans, probe_micro, pin in probes:
                other = {}
                with (_plain_path(torch, fa, ssd, ml, sw, scans)
                      if scans else contextlib.nullcontext()), \
                        (_normaliser_branches(torch, pin) if pin
                         else contextlib.nullcontext()):
                    make_train_step(run_model, _capture(other), shape,
                                    microbatches=probe_micro)(params, {},
                                                              batch)
                err = {n: (other[n].float() - g.float()).abs().max().item()
                       for n, g in grads.items()}
                for n in grads:
                    spread[n] = max(spread[n], err[n] / max(top[n], 1e-30))
                del other
            spreads[f"{arch} {dtype}"] = spread
            if dtype == "bfloat16" and arch in DIST_BF16_TOL:
                anchors[arch] = _fp32_distance(
                    torch, grads, out_dir / f"ref_{arch}_float32.pt")
            keep = torch.bfloat16 if dtype == "bfloat16" else torch.float32
            torch.save({"loss": float(metrics["loss"]),
                        "grads": {n: g.to("cpu", keep)
                                  for n, g in grads.items()},
                        "routing": routing,
                        "branches": [m.cpu() for m in branches]},
                       out_dir / f"ref_{arch}_{dtype}.pt")
            del branches
            for p in params.parameters():
                p.grad = None
            del metrics, step, grads
        del model, params, batch
        gc.collect()
        torch.cuda.empty_cache()
    walls = {"train_refs": time.perf_counter() - t_refs}
    t_refs = time.perf_counter()
    decode_spread = _dist_decode_refs(torch, out_dir)
    walls["decode_refs"] = time.perf_counter() - t_refs
    t_refs = time.perf_counter()
    _dist_extra_refs(torch, out_dir)
    walls["extra_refs"] = time.perf_counter() - t_refs
    rdv = out_dir / f"rendezvous_l_{os.getpid()}"
    rdv.unlink(missing_ok=True)
    for r in range(4):
        (out_dir / f"dist_l_{r}.json").unlink(missing_ok=True)
    reserved = torch.cuda.memory_reserved() / 1e9   # while the ranks run
    t_ranks = time.perf_counter()
    mp.spawn(_dist_rank, args=(4, str(rdv), str(out_dir)), nprocs=4,
             join=True)
    walls["ranks"] = time.perf_counter() - t_ranks
    ranks = [json.loads((out_dir / f"dist_l_{r}.json").read_text())
             for r in range(4)]
    emit({"phase": "dist_l_walls", "parent": walls,
          "rank0": ranks[0]["walls"]})
    for ref in out_dir.glob("ref_*.pt"):
        ref.unlink()
    flash = {p: 0 for p in DIST_FLASH}
    swiglu = {p: 0 for p in {**DIST_SWIGLU, **DIST_DECODE_SWIGLU}}
    scans = {p: 0 for p in {**DIST_SSD, **DIST_MLSTM}}
    decodes = _dist_decode_checks(ranks, swiglu, decode_spread)
    long = _dist_long_checks(ranks, swiglu, decode_spread)
    extras = _dist_extra_checks(ranks)
    runs = ranks[0]["runs"]
    check(set(runs) == {f"{a} {d}" for a, ds in DIST_RUNS.items()
                        for d in ds}, "dist", f"(l) ran {sorted(runs)}")
    for key, run in runs.items():
        check(math.isfinite(run["loss"]) and run["loss_rel"] <= 1e-4
              if key.endswith("float32") else run["loss_rel"] <= 2e-2,
              "dist", f"(l) {key}: loss {run['loss']} vs {run['loss_ref']}")
        # fp32 each leaf within the larger of the gate and SPREAD_FACTOR x
        # its spread (0 outside DIST_SPREAD_RUNS), as (g) holds the SSD
        # decay leaves; bf16 the whole gradient
        tol = DIST_REL_TOL[key.split(" ")[-1]]
        spread = spreads[key]
        if key.endswith("float32"):
            tols = {n: max(tol, SPREAD_FACTOR * spread[n])
                    for n in run["leaf_rel"]}
            run["leaf_tol_widened"] = {n: t for n, t in tols.items()
                                       if t > tol}
            bad = {n: (r, tols[n]) for n, r in run["leaf_rel"].items()
                   if r > tols[n]}
            check(not bad, "dist", f"(l) {key}: grads {bad}")
        else:
            arch = key.split(" ")[0]
            run["tol"] = DIST_BF16_TOL.get(arch, tol)
            check(run["grad_rel"] <= run["tol"], "dist",
                  f"(l) {key}: grads {run['grad_rel']} > {run['tol']} "
                  f"(largest errors {run['worst_abs']})")
            if arch in anchors:
                # the mesh's and the one-rank step's distance from the
                # fp32 gradient, and each scalar xgate's three values
                run["one_rank_vs_fp32"] = anchors[arch]["whole"]
                for n, v in anchors[arch]["scalars"].items():
                    run["scalars"][n].insert(1, v[0])
        flips = [rk["runs"][key]["routing_flips"] for rk in ranks]
        if run["routing_calls"]:
            run["routing_flips_by_rank"] = flips
            run["flip_share"] = max(flips) / run["routing_tokens"]
            check(run["flip_share"] <= DIST_FLIP_FRACTION, "dist",
                  f"(l) {key}: routing flips {flips} of "
                  f"{run['routing_tokens']} token choices a rank")
        del run["leaf_rel"]
    for rk in ranks:
        for key, run in rk["runs"].items():
            arch = key.split(" ")[0]
            for p, case in DIST_SSD.items():
                if p.startswith(arch):
                    # every mamba layer's scan, in the forward and in its
                    # replay, on the rank's heads (fp32 in either dtype)
                    n = sum(1 for c in run["ssd_calls"]
                            if tuple(c[:6]) == case and c[6] == "wgmma")
                    check(n >= DIST_DEPTH[arch]
                          and n == len(run["ssd_calls"]), "dist",
                          f"(l) {key}: SSD calls {run['ssd_calls']}")
                    scans[p] += n if key.endswith("bfloat16") else 0
            for p, case in DIST_MLSTM.items():
                if p.startswith(arch):
                    # every mLSTM block's scan, in the forward and in its
                    # replay, on the rank's heads and rows (fp32 in either
                    # dtype)
                    _, _, micro = _dist_shape(arch)
                    blocks = _xlstm_blocks(arch)[0]
                    n = sum(1 for c in run["mlstm_calls"]
                            if tuple(c[:5]) == case and c[5] == "wgmma")
                    check(n == 2 * blocks * micro
                          and n == len(run["mlstm_calls"]), "dist",
                          f"(l) {key}: mLSTM calls {run['mlstm_calls']}")
                    scans[p] += n if key.endswith("bfloat16") else 0
            if not key.endswith("bfloat16"):
                continue
            want_f = {tuple(s[:7]) for p, s in DIST_FLASH.items()
                      if p.startswith(arch)}
            got_f = {tuple(c[:7]) for c in run["flash_calls"]}
            check(got_f == want_f and all(c[7] == "wgmma"
                                          for c in run["flash_calls"]),
                  "dist", f"(l) {key}: flash shapes {got_f}")
            for p, s in DIST_FLASH.items():
                flash[p] += sum(1 for c in run["flash_calls"]
                                if tuple(c[:7]) == tuple(s[:7])) \
                    if p.startswith(arch) else 0
            want_s = {case for p, case in DIST_SWIGLU.items()
                      if p.startswith(arch)}
            got_s = [tuple(c[:4]) for c in run["swiglu_calls"]]
            check(set(got_s) == want_s
                  and len(got_s) == DIST_SWIGLU_CALLS.get(arch, 0)
                  and all(c[4] == "wgmma" for c in run["swiglu_calls"]),
                  "dist", f"(l) {key}: SwiGLU calls {run['swiglu_calls']}")
            for p, case in DIST_SWIGLU.items():
                swiglu[p] += got_s.count(case) if p.startswith(arch) else 0
    return {"mesh": list(DIST_MESH), "transport": ranks[0]["transport"],
            "runs": runs, "decodes": decodes, "long": long,
            "extras": extras, "roofline": _dist_roofline(ranks),
            "flash_launches": flash,
            "swiglu_launches": swiglu, "scan_launches": scans,
            "parent_reserved_gb": reserved,
            "parent_host_rss_gb": _host_rss_bytes() / 1e9,
            "peak_gb_by_rank": [{k: r["peak_gb"]
                                 for k, r in rk["runs"].items()}
                                for rk in ranks]}


def _xlstm_blocks(arch):
    """(mLSTM blocks, sLSTM blocks) of ``arch`` at ``DIST_DEPTH``."""
    from repro_torch.models.transformer import xlstm_counts
    return xlstm_counts(_dist_cfg(arch, n_layers=DIST_DEPTH[arch]))


def _decode_case(torch, arch, dtype, b=DIST_DECODE_BATCH, start=0,
                 model=None):
    """(model, its served parameters from seed 0, a zero decode state of
    ``b`` sequences whose cross caches are drawn from seed 5, the tokens
    (steps, B), the lengths by step, from ``start``), ``dtype`` the
    compute dtype: the same in every process that asks.  A ``model``
    given is used with its parameters (None in the tuple)."""
    from repro_torch.models.model import build_model

    cfg = _dist_cfg(arch, n_layers=DIST_DEPTH[arch], dtype=dtype)
    given = model is not None
    if not given:
        model = build_model(cfg)
        if cfg.family in ("vlm", "audio"):
            model = _gated(model)
    state = model.decode_init(b, DIST_DECODE_LEN)
    g = torch.Generator("cuda").manual_seed(5)
    for k in ("xk", "xv"):
        if k in state:
            state[k].copy_(torch.randn(state[k].shape, generator=g,
                                       device="cuda"))
    tokens = torch.randint(0, cfg.vocab, (DIST_DECODE_STEPS, b),
                           generator=g, device="cuda")
    lens = [torch.arange(b, device="cuda") + start + t
            for t in range(DIST_DECODE_STEPS)]
    return model, None if given else model.init(0), state, tokens, lens


def _leaves(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
    return out


def _dist_decode_refs(torch, out_dir):
    """(l)'s one-rank decode of every family in each dtype, at
    ``DIST_DECODE_BATCH`` sequences and at one (the same parameters, from
    ``DIST_DECODE1_START``): each step's logits, the final state and the
    MoE routing, written under ``out_dir``; for bf16 also its distance
    from the fp32 run (normwise, the logits' largest over the steps and
    each state leaf's), keyed by the arch (and " b1" for batch 1)."""
    import gc

    from repro_torch.train.step import make_decode_step

    spread = {}
    for arch in DIST_DEPTH:
        runs = {}
        for dtype in DIST_DECODE_DTYPES:
            model, params, state, tokens, lens = _decode_case(torch, arch,
                                                              dtype)
            for b, tag in ((DIST_DECODE_BATCH, ""), (1, " b1")):
                if b == 1:
                    _, _, state, tokens, lens = _decode_case(
                        torch, arch, dtype, 1, DIST_DECODE1_START, model)
                step = make_decode_step(model)
                logits = []
                with _moe_routing(torch) as routing:
                    for t in range(DIST_DECODE_STEPS):
                        lg, state = step(params, state,
                                         {"tokens": tokens[t],
                                          "cache_len": lens[t]})
                        logits.append(lg.float().cpu())
                runs[dtype + tag] = {"logits": logits, "routing": routing,
                                     "state": {k: v.cpu() for k, v in
                                               _leaves(state).items()}}
                torch.save(runs[dtype + tag], out_dir /
                           f"ref_decode{tag.strip()}_{arch}_{dtype}.pt")
            del model, params, state, step
            gc.collect()
            torch.cuda.empty_cache()
        for tag in ("", " b1"):
            if f"float32{tag}" in runs and f"bfloat16{tag}" in runs:
                lo, hi = runs[f"bfloat16{tag}"], runs[f"float32{tag}"]
                spread[arch + tag] = {
                    "logits": max(_normwise(torch, a, b) for a, b in
                                  zip(lo["logits"], hi["logits"])),
                    **{n: _normwise(torch, lo["state"][n], hi["state"][n])
                       for n in hi["state"]}}
        del runs
    spread.update(_dist_long_refs(torch, out_dir))
    return spread


def _long_model(torch, dtype):
    """zamba2-7b at ``DIST_LONG_DEPTH`` in ``dtype`` and its served
    parameters from seed 0."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model

    model = build_model(dataclasses.replace(
        ARCHS[DIST_LONG_ARCH], attention_impl="pallas",
        n_layers=DIST_LONG_DEPTH, dtype=dtype))
    return model, model.init(0)


def _fill_long_cache(torch, out, which, p0, h0):
    """Fill ``out`` (P, H, hd) with positions ``[p0, p0 + P)`` and kv heads
    ``[h0, h0 + H)`` of the long decode's global ``which`` cache ("k" or
    "v"): standard normals, each chunk of ``DIST_LONG_CHUNK`` positions
    drawn from its own seed (the same values in every process, whichever
    block it draws)."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[DIST_LONG_ARCH]
    p1, h1 = p0 + out.shape[0], h0 + out.shape[1]
    g = torch.Generator("cuda")
    for c in range(p0 // DIST_LONG_CHUNK, -(-p1 // DIST_LONG_CHUNK)):
        a = c * DIST_LONG_CHUNK
        g.manual_seed(7919 * ("kv".index(which) + 1) + c)
        chunk = torch.randn((DIST_LONG_CHUNK, cfg.n_kv_heads, cfg.head_dim),
                            generator=g, device="cuda")
        lo, hi = max(a, p0), min(a + DIST_LONG_CHUNK, p1)
        out[lo - p0:hi - p0] = chunk[lo - a:hi - a, h0:h1]
        del chunk


def _long_tokens(torch):
    from repro_torch.configs import ARCHS

    g = torch.Generator("cuda").manual_seed(23)
    tokens = torch.randint(0, ARCHS[DIST_LONG_ARCH].vocab,
                           (DIST_DECODE_STEPS, 1), generator=g,
                           device="cuda")
    return tokens, [torch.full((1,), DIST_LONG_START + t, device="cuda")
                    for t in range(DIST_DECODE_STEPS)]


def _long_written(state, start):
    """The long decode's state leaves that a step writes: the cache rows
    from ``start`` (the rank's block of positions from there; ``start``
    within it) and the SSM state."""
    s = DIST_DECODE_STEPS
    return {"attn.k": state["attn"]["k"][:, :, start:start + s],
            "attn.v": state["attn"]["v"][:, :, start:start + s],
            **{f"ssm.{k}": v for k, v in state["ssm"].items()}}


def _dist_long_refs(torch, out_dir):
    """The long decode's one-rank runs (no mesh) in fp32 and bf16: every
    step's logits and the written state (``_long_written``), under
    ``out_dir``; returns the bf16 run's distance from the fp32 run, keyed
    "zamba2-7b long"."""
    import gc

    from repro_torch.train.step import make_decode_step

    tokens, lens = _long_tokens(torch)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        model, params = _long_model(torch, dtype)
        state = model.decode_init(1, DIST_LONG_LEN)
        for which in ("k", "v"):
            _fill_long_cache(torch, state["attn"][which][0, 0], which, 0, 0)
        step = make_decode_step(model)
        logits = []
        for t in range(DIST_DECODE_STEPS):
            lg, state = step(params, state, {"tokens": tokens[t],
                                             "cache_len": lens[t]})
            logits.append(lg.float().cpu())
        torch.cuda.synchronize()
        runs[dtype] = {"logits": logits, "state": {
            k: v.cpu() for k, v in
            _long_written(state, DIST_LONG_START).items()}}
        torch.save(runs[dtype], out_dir / f"ref_long_{dtype}.pt")
        del model, params, state, step
        gc.collect()
        torch.cuda.empty_cache()
    lo, hi = runs["bfloat16"], runs["float32"]
    return {f"{DIST_LONG_ARCH} long": {
        "logits": max(_normwise(torch, a, b) for a, b in
                      zip(lo["logits"], hi["logits"])),
        **{n: _normwise(torch, lo["state"][n], hi["state"][n])
           for n in hi["state"]}}}


def _dist_rank_decode(torch, arch, dtype, mesh, out_dir,
                      b=DIST_DECODE_BATCH, shared=None):
    """One of (l)'s ranks: ``arch``'s decode step of ``b`` sequences on
    the mesh (``make_decode_step(..., mesh=)``; at ``b`` = 1 the batch
    does not split and every rank holds the sequence), its blocks of
    every step's logits and of the final state against the one-rank
    run's (the largest error and value over the ranks), its SwiGLU calls
    by shape, the expert choices replayed from the one-rank run (flips
    counted), its counted operations and bytes and its collectives.
    ``shared``, a dict, carries the model and its sharded parameters from
    one call to the next of the same arch and dtype (the placements of
    the parameters do not depend on the batch)."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.fused_swiglu import kernel as sw
    from repro_torch.launch.comm_analysis import analyze_collectives
    from repro_torch.sharding import collectives as C
    from repro_torch.train.step import make_decode_step

    one = b == 1
    model, params = (shared or {}).get("model"), (shared or {}).get("params")
    model_, params_, full, tokens, lens = _decode_case(
        torch, arch, dtype, b, DIST_DECODE1_START if one else 0, model)
    bundle = make_decode_step(model_, mesh=mesh, shape=ShapeConfig(
        "decode", DIST_DECODE_LEN, b, "decode"))
    if params is None:
        model, params = model_, bundle.shard_params(params_)
        if shared is not None:
            shared.update(model=model, params=params)
    state = bundle.shard_state(full)
    del full
    torch.cuda.empty_cache()
    ref = torch.load(Path(out_dir) /
                     f"ref_decode{'b1' if one else ''}_{arch}_{dtype}.pt",
                     mmap=True, weights_only=True)
    per = 1 if one else b // DIST_MESH[0]
    d = 0 if one else mesh.coords()["data"]
    lsh, ssh = bundle.out_shardings
    stats = []
    _zero(sw)
    C.reset_tally()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _launch_calls(sw, _expert_swiglu_key) as sc, \
            _moe_routing(torch, ref["routing"],
                         slice(d * per, (d + 1) * per)) as flips:
        for t in range(DIST_DECODE_STEPS):
            lg, state = bundle(params, state, {"tokens": tokens[t],
                                               "cache_len": lens[t]})
            want = lsh.shard(ref["logits"][t]).to("cuda")
            stats.append([(lg.float() - want).abs().max().item(),
                          want.abs().max().item()])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / DIST_DECODE_STEPS * 1e3
    tally = analyze_collectives()
    names = sorted(ref["state"])
    got, shards = _leaves(state), _leaves(ssh)
    for n in names:
        want = shards[n].shard(ref["state"][n]).to("cuda").float()
        stats.append([(got[n].float() - want).abs().max().item(),
                      want.abs().max().item()])
    stats = torch.tensor(stats, dtype=torch.float64)
    dist.all_reduce(stats, op=dist.ReduceOp.MAX)
    rel = (stats[:, 0] / stats[:, 1].clamp_min(1e-30)).tolist()
    counted = _counted_step(torch, bundle, params, state, tokens, lens)
    k = DIST_DECODE_STEPS
    return {"logits_rel": max(rel[:k]),
            "state_rel": dict(zip(names, rel[k:])),
            "swiglu_calls": [list(c) for c in sc],
            "routing_flips": sum(flips), "routing_calls": len(flips),
            "step_ms": step_ms, "collectives": tally["per_op"],
            "collective_bytes": tally["collective_bytes"],
            "counted": counted,
            "state_gb_rank": sum(t.numel() * t.element_size()
                                 for t in got.values()) / 1e9}


def _counted(fc, bc, steps=1):
    """A step's FLOPs and bytes as the cost probe's counters saw them
    (the kernels, calls they do not see, left out)."""
    return {"flops": fc.get_total_flops() / steps, "bytes": bc.bytes / steps}


def _counted_step(torch, bundle, params, state, tokens, lens):
    """One more decode step, after the timed and compared ones (the
    counters' dispatch slows a host-bound step), at the next position:
    its FLOPs and bytes as the cost probe counts them."""
    from repro_torch.launch.probe import counting
    with counting() as (fc, bc):
        bundle(params, state, {"tokens": tokens[-1],
                               "cache_len": lens[-1] + 1})
    torch.cuda.synchronize()
    return _counted(fc, bc)


def _dist_rank_long(torch, mesh, out_dir):
    """One of (l)'s ranks: the long decode on the mesh in bf16
    (``make_decode_step(..., shape=long_500k)``: the cache's positions
    over ``data``, its kv heads over ``model``), the rank's blocks of the
    cache allocated (``bundle.init_state``) and filled with its blocks of
    the seeded normals; its blocks of every step's logits and of the
    written state against the one-rank run's (the largest error and value
    over the ranks), its SwiGLU calls, counts and collectives."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.kernels.fused_swiglu import kernel as sw
    from repro_torch.launch.comm_analysis import analyze_collectives
    from repro_torch.sharding import collectives as C
    from repro_torch.train.step import make_decode_step

    model, params = _long_model(torch, "bfloat16")
    bundle = make_decode_step(model, mesh=mesh, shape=SHAPES["long_500k"])
    params = bundle.shard_params(params)
    state = bundle.init_state("cuda")
    ssh = bundle.in_shardings[1]
    starts = {}
    for which in ("k", "v"):
        sh, blk = ssh["attn"][which], state["attn"][which]
        starts[which] = (sh.block(2) * blk.shape[2], sh.block(3) * blk.shape[3])
        _fill_long_cache(torch, blk[0, 0], which, *starts[which])
    torch.cuda.synchronize()
    cache_gb = sum(state["attn"][w].numel() * state["attn"][w].element_size()
                   for w in ("k", "v")) / 1e9
    tokens, lens = _long_tokens(torch)
    ref = torch.load(Path(out_dir) / "ref_long_bfloat16.pt", mmap=True,
                     weights_only=True)
    lsh = bundle.out_shardings[0]
    stats = []
    _zero(sw)
    C.reset_tally()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _launch_calls(sw, _expert_swiglu_key) as sc:
        for t in range(DIST_DECODE_STEPS):
            lg, state = bundle(params, state, {"tokens": tokens[t],
                                               "cache_len": lens[t]})
            want = lsh.shard(ref["logits"][t]).to("cuda")
            stats.append([(lg.float() - want).abs().max().item(),
                          want.abs().max().item()])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / DIST_DECODE_STEPS * 1e3
    tally = analyze_collectives()
    names = sorted(ref["state"])
    p0, h0 = starts["k"]
    local = DIST_LONG_START - p0
    held = 0 <= local < state["attn"]["k"].shape[2]
    mine = _long_written(state, local) if held else \
        {f"ssm.{k}": v for k, v in state["ssm"].items()}
    for n in names:
        whole = ref["state"][n]
        if n.startswith("attn."):
            if not held:
                stats.append([0.0, 0.0])
                continue
            hl = mine[n].shape[3]
            want = whole[:, :, :, h0:h0 + hl]
        else:
            want = ssh["ssm"][n.split(".")[1]].shard(whole)
        want = want.to("cuda").float()
        stats.append([(mine[n].float() - want).abs().max().item(),
                      want.abs().max().item()])
    stats = torch.tensor(stats, dtype=torch.float64)
    dist.all_reduce(stats, op=dist.ReduceOp.MAX)
    rel = (stats[:, 0] / stats[:, 1].clamp_min(1e-30)).tolist()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counted = _counted_step(torch, bundle, params, state, tokens, lens)
    k = DIST_DECODE_STEPS
    return {"logits_rel": max(rel[:k]), "state_rel": dict(zip(names, rel[k:])),
            "swiglu_calls": [list(c) for c in sc], "step_ms": step_ms,
            "collectives": tally["per_op"],
            "collective_bytes": tally["collective_bytes"],
            "counted": counted,
            "cache_gb_rank": cache_gb, "writes_rows": held,
            "peak_gb": peak_gb}


def _extra_model(torch):
    """llama3.2-3b at one layer in fp32 and its trainable parameters from
    seed 0."""
    from repro_torch.models.model import build_model

    model = build_model(_dist_cfg(DIST_B1_ARCH, n_layers=1,
                                  dtype="float32"))
    return model, model.init(0, trainable=True)


def _int8_moments(torch, mu):
    """Each leaf's int8 moments: {name.m|v: (q, scale)} on the host."""
    return {f"{n}.{k}": (mv[k]["q"].cpu(), mv[k]["scale"].cpu())
            for n, mv in mu.items() for k in ("m", "v")}


def _dist_extra_refs(torch, out_dir):
    """The one-rank runs of (l)'s llama3.2-3b extras: the prefill logits
    and then one train step's loss and grads at a batch of 1; one train
    step's loss and grads at DIST_BATCH (the pod mesh's); the int8 AdamW
    steps' losses and moments.  Written under ``out_dir``."""
    import gc

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.step import make_prefill_step, make_train_step

    model, params = _extra_model(torch)
    batch = _dist_batch(torch, model.cfg, 1)
    logits = make_prefill_step(model)(params, {"tokens": batch["tokens"]})
    grads = {}
    step = make_train_step(model, _capture(grads), ShapeConfig(
        "train_4k", DIST_SEQ, 1, "train"))
    _, _, metrics = step(params, {}, batch)
    torch.save({"logits": logits.cpu(), "loss": float(metrics["loss"]),
                "grads": {n: g.cpu() for n, g in grads.items()}},
               out_dir / "ref_b1.pt")
    del model, params, logits, grads, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    model, params = _extra_model(torch)
    batch = _dist_batch(torch, model.cfg, DIST_BATCH)
    grads = {}
    step = make_train_step(model, _capture(grads), ShapeConfig(
        "train_4k", DIST_SEQ, DIST_BATCH, "train"))
    _, _, metrics = step(params, {}, batch)
    torch.save({"loss": float(metrics["loss"]),
                "grads": {n: g.cpu() for n, g in grads.items()}},
               out_dir / "ref_pod.pt")
    del model, params, grads, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    model, params = _extra_model(torch)
    batch = _dist_batch(torch, model.cfg, DIST_BATCH)
    opt = make_optimizer("adamw", state_dtype="int8", lr=DIST_INT8_LR)
    step = make_train_step(model, opt, ShapeConfig("train_4k", DIST_SEQ,
                                                   DIST_BATCH, "train"))
    state = opt.init(dict(params.named_parameters()))
    losses = [float(step(params, state, batch)[2]["loss"])
              for _ in range(DIST_INT8_STEPS)]
    torch.save({"losses": losses,
                "moments": _int8_moments(torch, state["mu"])},
               out_dir / "ref_int8.pt")
    del model, params, state, step
    gc.collect()
    torch.cuda.empty_cache()


def _dist_rank_extras(torch, mesh, out_dir):
    """One of (l)'s ranks: llama3.2-3b's prefill and train step at a batch
    of 1 on the mesh against the one-rank run's (logits normwise, each
    gradient leaf), then its int8 AdamW steps: the losses, the moments'
    blocks against the one-rank run's own (within one quantisation step,
    q entries that differ counted), and rank 0 replays one rank's int8
    update on the whole gradients the mesh reduced (each step's, gathered
    from every rank's blocks) from the seed's parameters: the mesh's
    parameters, gathered, against that."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_swiglu import kernel as sw
    from repro_torch.launch.comm_analysis import analyze_collectives
    from repro_torch.launch.probe import counting
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding import collectives as C
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import make_prefill_step, make_train_step

    out = {}
    rank = dist.get_rank()
    # ---- batch 1: prefill, then one train step -------------------------
    model, params = _extra_model(torch)
    batch = _dist_batch(torch, model.cfg, 1)
    shape = ShapeConfig("train_4k", DIST_SEQ, 1, "train")
    grads = {}
    bundle = make_train_step(model, _capture(grads, make_optimizer("adamw")),
                             shape, mesh=mesh)
    prefill = make_prefill_step(model, mesh=mesh, shape=dataclasses.replace(
        shape, kind="prefill"))
    params = bundle.shard_params(params)
    state = bundle.init_state(params)
    ref = torch.load(Path(out_dir) / "ref_b1.pt", mmap=True,
                     weights_only=True)
    _zero(fa, sw)
    with _launch_calls(fa, _flash_key) as fc1, \
            _launch_calls(sw, _swiglu_key) as sc1:
        logits = prefill(params, {"tokens": batch["tokens"]})
        want = prefill.out_shardings.shard(ref["logits"]).to("cuda")
        pre = [(logits - want).abs().max().item(), want.abs().max().item()]
        del logits, want
        C.reset_tally()
        t0 = time.perf_counter()
        with counting() as (fc, bc):
            _, _, metrics = bundle(params, state, batch)
            loss = float(metrics["loss"])
        step_s = time.perf_counter() - t0
    tally = analyze_collectives()
    o_shard = bundle.in_shardings[1]
    names = sorted(grads)
    stats = torch.zeros(2, len(names) + 1, dtype=torch.float64)
    stats[:, 0] = torch.tensor(pre)
    for i, n in enumerate(names):
        want = o_shard["mu"][n]["m"].shard(ref["grads"][n]).to("cuda")
        stats[0, i + 1] = (grads[n] - want).abs().max().item()
        stats[1, i + 1] = want.abs().max().item()
    dist.all_reduce(stats, op=dist.ReduceOp.MAX)
    rel = (stats[0] / stats[1].clamp_min(1e-30)).tolist()
    out["b1"] = {"loss": loss, "loss_ref": ref["loss"],
                 "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
                 "prefill_rel": rel[0],
                 "leaf_rel": dict(zip(names, rel[1:])),
                 "flash_calls": [list(c) for c in fc1],
                 "swiglu_calls": [list(c) for c in sc1],
                 "step_s": step_s, "collectives": tally["per_op"],
                 "collective_bytes": tally["collective_bytes"],
                 "counted": _counted(fc, bc)}
    del model, params, state, bundle, prefill, grads, ref, metrics
    torch.cuda.empty_cache()
    out["pod"] = _dist_rank_pod(torch, out_dir)
    # ---- int8 AdamW, DIST_INT8_STEPS steps ------------------------------
    model, params = _extra_model(torch)
    batch = _dist_batch(torch, model.cfg, DIST_BATCH)
    shape = ShapeConfig("train_4k", DIST_SEQ, DIST_BATCH, "train")
    bundle = make_train_step(model, make_optimizer(
        "adamw", state_dtype="int8", lr=DIST_INT8_LR), shape, mesh=mesh)
    params = bundle.shard_params(params)
    for n, p in params.named_parameters():
        p._name = n
    state = bundle.init_state(params)
    seen = []
    real_leaf = step_mod._int8_leaf_

    def spy(adamw, g, mv, p, p_shard, q_shard, corrections):
        if rank == 0:            # the whole summed gradient the update got
            seen[-1][p._name] = g.cpu()
        real_leaf(adamw, g, mv, p, p_shard, q_shard, corrections)

    losses = []
    C.reset_tally()
    step_mod._int8_leaf_ = spy
    try:
        t0 = time.perf_counter()
        for _ in range(DIST_INT8_STEPS):
            seen.append({})
            losses.append(float(bundle(params, state, batch)[2]["loss"]))
        step_s = (time.perf_counter() - t0) / DIST_INT8_STEPS
    finally:
        step_mod._int8_leaf_ = real_leaf
    tally = analyze_collectives()
    ref = torch.load(Path(out_dir) / "ref_int8.pt", mmap=True,
                     weights_only=True)
    o_shard, p_shard = bundle.in_shardings[1], bundle.in_shardings[0]
    mine = _int8_moments(torch, state["mu"])
    # per moment: (largest excess over one quantisation step, q entries
    # that differ, largest q difference)
    excess, differ, top_dq = 0.0, 0, 0
    for key, (q, scale) in mine.items():
        n, k = key.rsplit(".", 1)
        sh = o_shard["mu"][n][k]
        rq = sh["q"].shard(ref["moments"][key][0])
        rs = sh["scale"].shard(ref["moments"][key][1])
        dq = (q.int() - rq.int()).abs()
        if sh["q"].spec or rank == 0:     # a replicated leaf counted once
            differ += int((dq > 0).sum())
        top_dq = max(top_dq, int(dq.max()))
        # one step of the block, the two scales' difference and the
        # products' own rounding
        step = (torch.maximum(scale, rs) + 127 * (scale - rs).abs()) \
            * (1 + 1e-5)
        gap = (q.float() * scale - rq.float() * rs).abs() - step
        excess = max(excess, gap.max().item())
    counts = torch.tensor([excess, differ, top_dq], dtype=torch.float64)
    both = torch.stack([counts, counts])
    dist.all_reduce(both[0], op=dist.ReduceOp.MAX)
    dist.all_reduce(both[1], op=dist.ReduceOp.SUM)
    gathered = {}
    for n, p in params.named_parameters():
        whole = C.gather_global(p.data, p_shard[n])
        if rank == 0:
            gathered[n] = whole.cpu()
        del whole
    replay = None
    if rank == 0:
        # one rank's int8 update on the mesh's gradients, from the seed's
        # parameters
        del params, state
        torch.cuda.empty_cache()
        _, whole = _extra_model(torch)
        opt = make_optimizer("adamw", state_dtype="int8", lr=DIST_INT8_LR)
        named = dict(whole.named_parameters())
        one = opt.init({n: p.data for n, p in named.items()})
        for g in seen:
            opt.update_({n: g[n].to("cuda") for n in named}, one,
                        {n: p.data for n, p in named.items()})
        replay = max((named[n].data.cpu() - gathered[n]).abs().max().item()
                     for n in named)
        del whole, one, named
    out["int8"] = {"losses": losses, "losses_ref": ref["losses"],
                   "moment_excess": both[0, 0].item(),
                   "q_differ": int(both[1, 1].item()),
                   "q_entries": sum(q.numel() for q, _ in
                                    ref["moments"].values()),
                   "q_max_diff": int(both[0, 2].item()),
                   "replay_param_err": replay, "step_s": step_s,
                   "collectives": tally["per_op"],
                   "collective_bytes": tally["collective_bytes"]
                   / DIST_INT8_STEPS}
    del gathered, seen
    torch.cuda.empty_cache()
    return out


def _dist_rank_pod(torch, out_dir):
    """One of (l)'s ranks on the multi-pod mesh (pod, data, model) =
    DIST_POD_MESH: llama3.2-3b's fp32 train step at DIST_BATCH sequences
    (one a (pod, data) rank), each gradient leaf and the loss against the
    one-rank step's, the kernels' launches and the bytes all-reduced over
    ``pod``."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_swiglu import kernel as sw
    from repro_torch.launch.comm_analysis import analyze_collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding import collectives as C
    from repro_torch.train.step import make_train_step

    mesh = make_mesh(DIST_POD_MESH, ("pod", "data", "model"), device="cpu")
    model, params = _extra_model(torch)
    batch = _dist_batch(torch, model.cfg, DIST_BATCH)
    grads = {}
    bundle = make_train_step(
        model, _capture(grads, make_optimizer("adamw")),
        ShapeConfig("train_4k", DIST_SEQ, DIST_BATCH, "train"), mesh=mesh)
    params = bundle.shard_params(params)
    state = bundle.init_state(params)
    ref = torch.load(Path(out_dir) / "ref_pod.pt", mmap=True,
                     weights_only=True)
    _zero(fa, sw)
    C.reset_tally()
    with _launch_calls(fa, _flash_key) as fcalls, \
            _launch_calls(sw, _swiglu_key) as scalls, \
            C.record_calls() as calls:
        t0 = time.perf_counter()
        _, _, metrics = bundle(params, state, batch)
        loss = float(metrics["loss"])
        step_s = time.perf_counter() - t0
    coll = analyze_collectives(calls=calls)
    o_shard = bundle.in_shardings[1]
    names = sorted(grads)
    stats = torch.zeros(2, len(names), dtype=torch.float64)
    for i, n in enumerate(names):
        want = o_shard["mu"][n]["m"].shard(ref["grads"][n]).to("cuda")
        stats[0, i] = (grads[n] - want).abs().max().item()
        stats[1, i] = want.abs().max().item()
    dist.all_reduce(stats, op=dist.ReduceOp.MAX)
    rel = (stats[0] / stats[1].clamp_min(1e-30)).tolist()
    pod_bytes = sum(d["operand_bytes"]
                    for axis, kinds in coll["per_axis"].items()
                    if "pod" in axis.split("+") for d in kinds.values())
    loss_ref = ref["loss"]
    del model, params, state, bundle, grads, ref, metrics
    torch.cuda.empty_cache()
    return {"mesh": list(DIST_POD_MESH), "loss": loss,
            "loss_ref": loss_ref,
            "loss_rel": abs(loss - loss_ref) / abs(loss_ref),
            "leaf_rel": dict(zip(names, rel)),
            "flash_calls": [list(c) for c in fcalls],
            "swiglu_calls": [list(c) for c in scalls],
            "step_s": step_s, "collectives_by_axis": coll["per_axis"],
            "collective_bytes": coll["collective_bytes"],
            "pod_axis_bytes": pod_bytes}


def _dist_decode_checks(ranks, swiglu, spread):
    """(l)'s decode results: every family's logits and state within its
    dtype's gate of the one-rank run's (bf16: twice ``spread``, the
    one-rank bf16 run's distance from fp32, where that is larger), each
    rank's SwiGLU calls at ``DIST_DECODE_SWIGLU``'s shapes in bf16 (their
    launches added to ``swiglu``; at batch 1 every call one row, and
    zamba2-7b's at its batch-1 shape), the routing flips within
    ``DIST_FLIP_FRACTION``."""
    out = {}
    for key, dec in ranks[0]["decodes"].items():
        arch, dtype = key.split(" ")[:2]
        b1 = key.endswith(" b1")
        ref = spread.get(arch + (" b1" if b1 else ""), {})
        tol = DIST_DECODE_TOL[dtype]
        tols = {n: max(tol, 2 * ref[n]) if dtype == "bfloat16"
                else tol for n in ["logits", *dec["state_rel"]]}
        got = {"logits": dec["logits_rel"], **dec["state_rel"]}
        bad = {n: (v, tols[n]) for n, v in got.items() if not v <= tols[n]}
        check(not bad, "dist", f"(l) {key} decode: {bad}")
        calls = [[tuple(c[:4]) for c in rk["decodes"][key]["swiglu_calls"]]
                 for rk in ranks]
        if dtype == "bfloat16":
            want = {case for p, case in DIST_DECODE_SWIGLU.items()
                    if p.startswith(arch) and ("batch-1" in p) == b1}
            for c in calls:
                # at batch 1 a family without a row of its own: every
                # call one row
                shapes_ok = all(m == 1 for _, m, _, _ in c) \
                    if b1 and not want else set(c) == want
                check(shapes_ok and len(c) ==
                      DIST_DECODE_SWIGLU_CALLS[arch] * DIST_DECODE_STEPS,
                      "dist", f"(l) {key} decode: SwiGLU calls {c}")
                for p, case in DIST_DECODE_SWIGLU.items():
                    if p.startswith(arch) and ("batch-1" in p) == b1:
                        swiglu[p] += c.count(case)
        flips = [rk["decodes"][key]["routing_flips"] for rk in ranks]
        if dec["routing_calls"]:
            tokens = dec["routing_calls"] * (1 if b1 else DIST_DECODE_BATCH
                                             // DIST_MESH[0])
            # batch 1 routes 8 tokens a rank: one near-tie allowed (2.7-2.9%
            # of a train step's tokens flip, so one of 8 does a fifth of
            # the time)
            check(max(flips) <= max(DIST_FLIP_FRACTION * tokens, b1),
                  "dist",
                  f"(l) {key} decode: routing flips {flips} of {tokens}")
        out[key] = {**{k: v for k, v in dec.items() if k != "swiglu_calls"},
                    "tols": tols, "swiglu_variants": sorted(
                        {c[4] for c in dec["swiglu_calls"]}),
                    "routing_flips_by_rank": flips,
                    "step_ms_by_rank": [rk["decodes"][key]["step_ms"]
                                        for rk in ranks]}
    return out


def _dist_long_checks(ranks, swiglu, spread):
    """The long decode: logits and written state within twice the
    one-rank bf16 run's distance from fp32 (at least 2e-2), the rows
    written by the ranks that hold them, every rank's SwiGLU calls at the
    batch-1 shape (added to its row)."""
    dec = ranks[0]["long"]
    ref = spread[f"{DIST_LONG_ARCH} long"]
    tols = {n: max(DIST_DECODE_TOL["bfloat16"], 2 * ref[n])
            for n in ["logits", *dec["state_rel"]]}
    got = {"logits": dec["logits_rel"], **dec["state_rel"]}
    bad = {n: (v, tols[n]) for n, v in got.items() if not v <= tols[n]}
    check(not bad, "dist", f"(l) long_500k decode: {bad}")
    holders = [rk["rank"] for rk in ranks if rk["long"]["writes_rows"]]
    check(len(holders) == DIST_MESH[1], "dist",
          f"(l) long_500k decode: ranks {holders} hold the new rows")
    path = "zamba2-7b batch-1 decode shared MLP"
    for rk in ranks:
        c = [tuple(x[:4]) for x in rk["long"]["swiglu_calls"]]
        check(c == [DIST_DECODE_SWIGLU[path]] * DIST_DECODE_STEPS,
              "dist", f"(l) long_500k decode: SwiGLU calls {c}")
        swiglu[path] += len(c)
    return {**{k: v for k, v in dec.items() if k != "swiglu_calls"},
            "tols": tols, "one_rank_bf16_vs_fp32": ref,
            "swiglu_variants": sorted({x[4] for x in dec["swiglu_calls"]}),
            "step_ms_by_rank": [rk["long"]["step_ms"] for rk in ranks],
            "peak_gb_by_rank": [rk["long"]["peak_gb"] for rk in ranks]}


def _dist_extra_checks(ranks):
    """llama3.2-3b on the pod mesh: loss and each gradient leaf within
    1e-4 of one rank's, the flash and SwiGLU kernels launched on every
    rank, bytes all-reduced over ``pod``; at a batch of 1: loss and each
    gradient leaf within 1e-4 of one rank's, the prefill logits within
    1e-4 normwise, the flash and SwiGLU kernels launched; int8 AdamW: the
    losses within 1e-4, every moment within one quantisation step of one
    rank's own (q entries differing by at most 1, counted), the
    parameters within 1e-5 of one rank's update of the mesh's
    gradients."""
    b1, i8 = ranks[0]["extras"]["b1"], ranks[0]["extras"]["int8"]
    pod = ranks[0]["extras"]["pod"]
    pod_worst = max(pod["leaf_rel"].values())
    check(pod["loss_rel"] <= 1e-4 and pod_worst <= 1e-4, "dist",
          f"(l) pod mesh {pod['mesh']}: loss {pod['loss_rel']}, grads "
          f"{pod_worst}")
    check(all(rk["extras"]["pod"]["flash_calls"]
              and rk["extras"]["pod"]["swiglu_calls"]
              and rk["extras"]["pod"]["pod_axis_bytes"] > 0
              for rk in ranks), "dist",
          "(l) pod mesh: a rank launched no flash or SwiGLU kernel or "
          "all-reduced nothing over pod")
    worst = max(b1["leaf_rel"].values())
    check(b1["loss_rel"] <= 1e-4 and worst <= 1e-4
          and b1["prefill_rel"] <= 1e-4, "dist",
          f"(l) batch 1: loss {b1['loss_rel']}, grads {worst}, prefill "
          f"{b1['prefill_rel']}")
    check(all(len(rk["extras"]["b1"]["flash_calls"]) >= 2
              and len(rk["extras"]["b1"]["swiglu_calls"]) >= 2
              for rk in ranks), "dist",
          "(l) batch 1: the flash and SwiGLU kernels were not launched")
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(i8["losses"], i8["losses_ref"]))
    check(loss_rel <= 1e-4 and i8["moment_excess"] <= 0
          and i8["q_max_diff"] <= 1 and i8["replay_param_err"] <= 1e-5,
          "dist", f"(l) int8: losses {loss_rel}, moments beyond a step "
          f"{i8['moment_excess']}, q {i8['q_max_diff']}, replay "
          f"{i8['replay_param_err']}")
    return {"b1": {**{k: v for k, v in b1.items()
                      if k not in ("leaf_rel", "flash_calls",
                                   "swiglu_calls")},
                   "grad_rel": worst,
                   "flash_launches": len(b1["flash_calls"]),
                   "swiglu_launches": len(b1["swiglu_calls"])},
            "pod": {**{k: v for k, v in pod.items()
                       if k not in ("leaf_rel", "flash_calls",
                                    "swiglu_calls")},
                    "grad_rel": pod_worst,
                    "flash_launches": len(pod["flash_calls"]),
                    "swiglu_launches": len(pod["swiglu_calls"])},
            "int8": {**i8, "loss_rel": loss_rel}}


def _dist_roofline(ranks):
    """The roofline row of every (l) record, against one card's data
    sheet (``launch/roofline.py``): its collective term (rank 0's
    collective bytes a step over NVLink's rate) and, for the decodes and
    the batch-1 train step, whose steps ran under the cost probe's
    counters, the compute and memory terms at rank 0's counts (the
    kernels, calls the counters do not see, left out) and the slowest of
    the three.  The other train steps are not counted: the counters'
    dispatch doubles the host-bound xlstm step, and the run keeps to its
    time."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import hw
    from repro_torch.launch.roofline import analyze, matmul_params

    rk = ranks[0]
    rows = []
    chips = DIST_MESH[0] * DIST_MESH[1]

    def row(name, arch, shape, rec, n_layers, steps=1, **over):
        coll = rec["collective_bytes"] / steps
        if "counted" not in rec:
            rows.append({"record": name, "collective_bytes": coll,
                         "t_collective_s": coll / hw.LINK_BYTES_PER_S,
                         "t_compute_s": None, "t_memory_s": None})
            return
        cfg = dataclasses.replace(_dist_cfg(arch, n_layers=n_layers), **over)
        r = analyze(arch, shape, rec["counted"]["flops"],
                    rec["counted"]["bytes"], n_params=matmul_params(cfg),
                    collective_bytes=coll, chips=chips)
        rows.append({"record": name, **{k: r[k] for k in (
            "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
            "collective_bytes", "roofline_fraction")}})

    for key, run in rk["runs"].items():
        arch = key.split(" ")[0]
        seq, b, _ = _dist_shape(arch)
        row(key, arch, ShapeConfig("train", seq, b, "train"), run,
            DIST_DEPTH[arch])
    for key, dec in rk["decodes"].items():
        arch = key.split(" ")[0]
        b = 1 if key.endswith(" b1") else DIST_DECODE_BATCH
        row(key + " decode", arch, ShapeConfig("decode", DIST_DECODE_LEN, b,
                                               "decode"),
            dec, DIST_DEPTH[arch], DIST_DECODE_STEPS)
    row("zamba2-7b long_500k decode", DIST_LONG_ARCH,
        ShapeConfig("long_500k", DIST_LONG_LEN, 1, "decode"), rk["long"],
        DIST_LONG_DEPTH, DIST_DECODE_STEPS,
        shared_attn_every=DIST_LONG_DEPTH)
    row("llama3.2-3b b1 train", DIST_B1_ARCH,
        ShapeConfig("train", DIST_SEQ, 1, "train"), rk["extras"]["b1"], 1)
    return rows


def _fp32_distance(torch, grads, path):
    """The normwise distance of the one-rank ``grads`` from the fp32
    one-rank gradient written at ``path``, and each scalar leaf's pair of
    values (these grads', fp32's)."""
    f32 = torch.load(path, mmap=True, weights_only=True)["grads"]
    err = top = 0.0
    scalars = {}
    for n, g in grads.items():
        want = f32[n].to(g.device)
        err = max(err, (g.float() - want).abs().max().item())
        top = max(top, want.abs().max().item())
        if want.dim() == 0:
            scalars[n] = [g.item(), want.item()]
    return {"whole": err / max(top, 1e-30), "scalars": scalars}


def _dist_model(torch, arch):
    """(model, its fp32 parameters from seed 0 on the card, the batch from
    its seed): the same in every process that asks."""
    from repro_torch.models.model import build_model

    cfg = _dist_cfg(arch, n_layers=DIST_DEPTH[arch])
    model = build_model(cfg)
    if cfg.family in ("vlm", "audio"):
        model = _gated(model)
    seq, b, _ = _dist_shape(arch)
    return model, model.init(0, trainable=True), \
        _dist_batch(torch, cfg, b, seq=seq)


def _dist_rank(rank, world, rdv, out_dir):
    """One of (l)'s ranks: the sharded steps of ``DIST_RUNS``, one model at
    a time, their launches by shape and their collectives, and its blocks
    of the grads against the one-rank step's (the largest error and value
    over the ranks, reduced with the world)."""
    import gc
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world, timeout=timedelta(minutes=5))
    try:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh(DIST_MESH, ("data", "model"), device="cpu")
        runs, decodes, walls = {}, {}, {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            gc.collect()
            torch.cuda.empty_cache()
            walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
            return out

        for arch, dtypes in DIST_RUNS.items():
            seq, b, _ = _dist_shape(arch)
            shape = ShapeConfig("train_4k", seq, b, "train")
            timed(f"train {arch}", _dist_rank_runs, torch, arch, dtypes,
                  mesh, shape, out_dir, runs)
        for arch in DIST_DEPTH:
            for dtype in DIST_DECODE_DTYPES:
                shared = {}
                for b, tag in ((DIST_DECODE_BATCH, ""), (1, " b1")):
                    decodes[f"{arch} {dtype}{tag}"] = timed(
                        f"decode {arch}", _dist_rank_decode, torch, arch,
                        dtype, mesh, out_dir, b, shared)
                del shared
        long = timed("long", _dist_rank_long, torch, mesh, out_dir)
        extras = timed("extras", _dist_rank_extras, torch, mesh, out_dir)
        Path(out_dir, f"dist_l_{rank}.json").write_text(json.dumps({
            "rank": rank, "runs": runs, "decodes": decodes, "long": long,
            "extras": extras, "walls": walls,
            "transport": "gloo, its collectives on CUDA tensors staged "
                         "through host copies (sharding.collectives)"}))
    finally:
        dist.destroy_process_group()


def _dist_rank_runs(torch, arch, dtypes, mesh, shape, out_dir, runs):
    """One rank's sharded steps of ``arch`` in ``dtypes``, into ``runs``."""
    import gc

    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_swiglu import kernel as sw
    from repro_torch.kernels.mlstm_scan import kernel as ml
    from repro_torch.kernels.ssm_scan import kernel as ssd
    from repro_torch.launch.comm_analysis import analyze_collectives
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding import collectives as C
    from repro_torch.train.step import make_train_step

    model, module, batch = _dist_model(torch, arch)
    _, _, micro = _dist_shape(arch)
    first = None
    for dtype in dtypes:
        cfg = dataclasses.replace(model.cfg, dtype=dtype)
        grads = {}
        bundle = make_train_step(
            build_model(cfg), _capture(grads, make_optimizer("adamw")),
            shape, mesh=mesh, microbatches=micro)
        p_shard, o_shard, _ = bundle.in_shardings
        with torch.no_grad():
            if first is None:      # this rank's blocks of the draw
                first = {n: p_shard[n].shard(t.data).contiguous()
                         .clone()
                         for n, t in module.named_parameters()}
            for n, t in module.named_parameters():
                t.data = first[n].clone()
                t._sharding = p_shard[n]
        gc.collect()
        torch.cuda.empty_cache()
        state = bundle.init_state(module)
        ref = torch.load(Path(out_dir) / f"ref_{arch}_{dtype}.pt", mmap=True,
                         weights_only=True)
        per, d = shape.global_batch // DIST_MESH[0], mesh.coords()["data"]
        rows = slice(d * per, (d + 1) * per)      # this rank's sequences
        pin = None
        if ref["branches"]:
            # each micro-batch's call holds its rows of the batch: this
            # rank's row block of those, and its block of the heads
            mine = per // micro
            hl = cfg.n_heads // DIST_MESH[1]
            h0 = mesh.coords()["model"] * hl
            pin = [m[d * mine:(d + 1) * mine, ..., h0:h0 + hl].to("cuda")
                   for m in ref["branches"]]
        _zero(fa, ssd, ml, sw)
        C.reset_tally()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # an MoE run replays the one-rank run's expert choices (a one-ulp
        # difference in the residual stream flips a near-tie): counted
        with _launch_calls(fa, _flash_key) as fc, \
                _launch_calls(sw, _expert_swiglu_key) as sc, \
                _launch_calls(ssd, _ssd_key) as dc, \
                _launch_calls(ml, _mlstm_key) as mc, \
                _moe_routing(torch, ref["routing"], rows) as flips, \
                (_normaliser_branches(torch, pin) if pin is not None
                 else contextlib.nullcontext([])) as seen:
            _, _, metrics = bundle(module, state, batch)
            loss = float(metrics["loss"])
        check(pin is None or len(seen) == len(pin), "dist",
              f"(l) {arch} {dtype}: {len(seen)} normaliser calls, the "
              f"one-rank run made {len(pin or ())}")
        step_s = time.perf_counter() - t0
        tally = analyze_collectives()
        names = sorted(grads)
        stats = torch.zeros(2, len(names), dtype=torch.float64)
        for i, n in enumerate(names):
            want = o_shard["mu"][n]["m"].shard(ref["grads"][n]) \
                .to("cuda", torch.float32)
            stats[0, i] = (grads[n] - want).abs().max().item()
            stats[1, i] = want.abs().max().item()
            del want
        dist.all_reduce(stats, op=dist.ReduceOp.MAX)
        rel = stats[0] / stats[1].clamp_min(1e-30)
        anchor = {"grad_rel_fp32": None, "scalars": {}}
        if dtype == "bfloat16" and arch in DIST_BF16_TOL:
            # the same blocks against the one-rank fp32 gradient
            f32 = torch.load(Path(out_dir) / f"ref_{arch}_float32.pt",
                             mmap=True, weights_only=True)["grads"]
            far = torch.zeros(2, len(names), dtype=torch.float64)
            for i, n in enumerate(names):
                want = o_shard["mu"][n]["m"].shard(f32[n]).to("cuda")
                far[0, i] = (grads[n] - want).abs().max().item()
                far[1, i] = want.abs().max().item()
                if want.dim() == 0:
                    anchor["scalars"][n] = [grads[n].item(), want.item()]
                del want
            dist.all_reduce(far, op=dist.ReduceOp.MAX)
            anchor["grad_rel_fp32"] = (far[0].max() / far[1].max()).item()
            del f32
        runs[f"{arch} {dtype}"] = {
            "loss": loss, "loss_ref": ref["loss"],
            "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
            "grad_rel": (rel.max() if dtype == "float32" else
                         stats[0].max() / stats[1].max()).item(),
            "worst_leaf": names[int(rel.argmax())],
            "leaf_rel": dict(zip(names, rel.tolist())),
            # the leaves of the largest absolute errors: (error, largest
            # value of the leaf)
            "worst_abs": {names[i]: [stats[0, i].item(), stats[1, i].item()]
                          for i in stats[0].argsort(descending=True)[:4]
                          .tolist()},
            "step_s": step_s,
            "flash_calls": [list(c) for c in fc],
            "swiglu_calls": [list(c) for c in sc],
            "ssd_calls": [list(c) for c in dc],
            "mlstm_calls": [list(c) for c in mc],
            "routing_flips": sum(flips),
            "routing_calls": len(flips),
            # each call routes the rank's sequences (DIST_SEQ = MAX_GROUP)
            "routing_tokens": len(flips) * per * shape.seq_len,
            **anchor,
            "collectives": tally["per_op"],
            "collective_bytes": tally["collective_bytes"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del grads, state, bundle, metrics, ref


if __name__ == "__main__":
    sys.exit(main())
