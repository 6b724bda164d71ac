"""Optimizer-state offload: plan AdamW moments as first-class arena slots.

Port of ``repro/core/optim_offload.py``.  The planning half (slots, the
packed device region and host pool, the prices) is a copy of the
reference's; the runtime half (:class:`OptimRuntime`,
:func:`offloaded_update`) is torch, with a real host tier.

The paper's small-batch personalization regime makes Adam's optimizer
state — two fp32 moments, 2x the parameter bytes — the dominant device
tenant, not activations.  This module extends the memory plan to cover it,
in the mold of 8-bit Adam and the 256KB-tier on-device training line of
work (PAPERS.md): per-layer optimizer slots become planned tensors with
their own execution-order windows, packed device/host arenas and typed
schedule ops.

Per trainable weighted layer ``<l>`` one slot ``O:<l>`` holds the layer's
flattened ``m || v`` fp32 moments (``2 * weight_nbytes``).  The slot is
only needed around the layer's compute-gradient phase (the AdamW update
reads and writes the moments there), so its *device* residency is the
short window ``[CG - prefetch_margin, CG + 1]`` — packed by the regular
interval planners into a working region a fraction of the all-resident
footprint.  Between updates the state lives in a host pool as an int8
block-scaled copy (``optim/compression.py``'s ``_q``/``_deq`` geometry:
one fp32 absmax scale per :data:`CBLOCK` elements, ~3.94x under fp32).

Lowering emits one :class:`repro_torch.core.plan.OptPrefetch` (compressed
host copy -> fp32 working buffer, ready by the CG update) and one
:class:`repro_torch.core.plan.OptSwapOut` (updated state back to the host
slot, re-quantized with error feedback) per slot; both executor backends
replay them and account them in ``SwapExecStats`` (``opt_*`` counters).

The ``m`` half quantizes linearly; the ``v`` half quantizes in log space
(8-bit-Adam style dynamic-range compression).  ``v`` spans many orders of
magnitude inside one 256-element block — linear (or even sqrt-space) int8
collapses small-``v`` elements to zero, turning the Adam denominator into
``eps`` and exploding that update ~1e8x.  In log space the int8 grid error
becomes a bounded *multiplicative* error on ``sqrt(v)`` (~e^(absmax/254)
per element, a few percent), so the denominator can never collapse and
the per-step update error stays a small fraction of ``lr``.

Error feedback keeps updates unbiased over time: the host re-quantization
of the swapped-out state carries its (encoded-space) rounding error into
the *next* quantization (``total = enc(state) + residual; residual =
total - deq(q)``).
The fp32 residual is host-persistent and never crosses the bus — DMA
carries only the compressed payload H2D and the fp32 working state D2H —
so it is reported separately (``ef_residual_host_bytes``) and NOT counted
against the packed host pool, which holds only the DMA-addressable
compressed copies.

On the card, :class:`OptimRuntime` keeps each slot's int8 blocks and fp32
scales in ONE pinned host buffer, allocated at construction, and the EF
residual in ordinary host memory.  :class:`OffloadedStep` is one update,
slot by slot, on a transfer engine's optimizer lane: a replay drives it at
the slot's planned ops (``OptPrefetch`` issues the H2D of the compressed
copy on the copy stream, the layer's CG phase fences it, ``OptSwapOut``
runs the update), and :func:`offloaded_update` drives it outside a
replay.  The copy is dequantized and decoded on the card, the AdamW math
runs there, and the updated fp32 state goes D2H into a pinned staging
buffer of one slot's size, where the host re-quantizes it with error
feedback — while the card already runs on.  With ``optim_compress=False`` the
host copies are exact fp32 (pinned too) and the update matches the
resident AdamW to float noise; with compression it matches within the
error-feedback tolerance.  With ``device="cpu"`` the same code runs with
both tiers on the host.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.execution_order import OrderedTensors
from repro_torch.core.graph import WEIGHTED_KINDS, LayerGraph
from repro_torch.core.lifespan import CreateMode, Lifespan, TensorSpec
from repro_torch.core.planner import Plan, _SpecSet, _align, get_planner
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.compression import _deq

_HOST = "@host"

# compression geometry mirrors optim/compression.py: int8 payload plus one
# fp32 absmax scale per CBLOCK elements
CBLOCK = 256

# pricing defaults mirror the remat_policy cost model's documented
# fallbacks (MemoryPlanConfig.dma_gbps / device_tflops override them)
_DEFAULT_DMA_GBPS = 32.0
_DEFAULT_DEVICE_TFLOPS = 200.0
# quantize (absmax reduction, scale divide, round/clip) + dequantize
# (multiply) per element, both directions of one step
_COMPRESS_FLOPS_PER_ELEM = 6


def compressed_nbytes(n_elems: int) -> int:
    """Host bytes for an int8 block-scaled copy of ``n_elems`` fp32 values."""
    return n_elems + 4 * (-(-n_elems // CBLOCK))


@dataclasses.dataclass(frozen=True)
class OptimSlot:
    """One layer's planned optimizer state (flattened ``m || v``, fp32)."""

    layer: str
    name: str                # "O:<layer>"
    n_elems: int             # 2 * weight elements (m and v)
    nbytes: int              # fp32 working-buffer bytes (n_elems * 4)
    host_nbytes: int         # compressed host-copy bytes (== nbytes uncompressed)
    prefetch_eo: int         # H2D issue phase (CG - prefetch_margin)
    read_eo: int             # the layer's CG phase: the update reads here
    swapout_eo: int          # CG + 1: updated state drains back to host

    @property
    def dma_bytes(self) -> int:
        """Bus traffic per step: fp32 state D2H + compressed copy H2D."""
        return self.nbytes + self.host_nbytes


@dataclasses.dataclass
class OptimPlan:
    """Packed optimizer-state offload plan, attached to the memory plan.

    ``device`` packs the fp32 working buffers over their short per-layer
    CG windows (a separate region — nothing here aliases the activation
    arena); ``host`` packs the persistent compressed copies (keyed
    ``<slot>@host``).  ``resident_bytes`` is the all-resident baseline the
    reduction claim is measured against: every slot live simultaneously,
    same alignment.
    """

    slots: Tuple[OptimSlot, ...]
    device: Plan
    host: Plan
    compress: bool
    resident_bytes: int
    est_dma_s_per_step: float
    est_compress_s_per_step: float

    @property
    def device_peak_bytes(self) -> int:
        return self.device.arena_bytes

    @property
    def host_pool_bytes(self) -> int:
        return self.host.arena_bytes

    @property
    def host_fp32_bytes(self) -> int:
        """What the host pool would cost without compression."""
        return sum(_align(s.nbytes) for s in self.slots)

    @property
    def ef_residual_host_bytes(self) -> int:
        """fp32 error-feedback residual held host-side (never on the bus)."""
        return sum(s.nbytes for s in self.slots) if self.compress else 0

    @property
    def dma_bytes_per_step(self) -> int:
        return sum(s.dma_bytes for s in self.slots)

    @property
    def compress_flops_per_step(self) -> int:
        if not self.compress:
            return 0
        return _COMPRESS_FLOPS_PER_ELEM * sum(s.n_elems for s in self.slots)

    @property
    def reduction_x(self) -> float:
        """Device-resident optimizer bytes, all-resident / planned peak."""
        return self.resident_bytes / max(1, self.device_peak_bytes)

    def slot(self, name: str) -> OptimSlot:
        for s in self.slots:
            if s.name == name:
                return s
        raise KeyError(name)

    def summary(self) -> Dict[str, Any]:
        return {
            "n_slots": len(self.slots),
            "compress": self.compress,
            "resident_bytes": self.resident_bytes,
            "device_peak_bytes": self.device_peak_bytes,
            "reduction_x": self.reduction_x,
            "host_pool_bytes": self.host_pool_bytes,
            "host_fp32_bytes": self.host_fp32_bytes,
            "ef_residual_host_bytes": self.ef_residual_host_bytes,
            "dma_bytes_per_step": self.dma_bytes_per_step,
            "compress_flops_per_step": self.compress_flops_per_step,
            "est_dma_s_per_step": self.est_dma_s_per_step,
            "est_compress_s_per_step": self.est_compress_s_per_step,
        }

    def validate(self) -> None:
        self.device.validate()
        self.host.validate()
        for s in self.slots:
            if not (s.prefetch_eo <= s.read_eo < s.swapout_eo):
                raise AssertionError(
                    f"{s.name}: window prefetch={s.prefetch_eo} "
                    f"read={s.read_eo} swapout={s.swapout_eo} out of order")
            dp = self.device.placements.get(s.name)
            if dp is None:
                raise AssertionError(f"{s.name}: no device placement")
            if dp.min_eo > s.prefetch_eo or dp.max_eo < s.swapout_eo:
                raise AssertionError(
                    f"{s.name}: device placement [{dp.min_eo},{dp.max_eo}] "
                    f"does not cover [{s.prefetch_eo},{s.swapout_eo}]")
            hp = self.host.placements.get(s.name + _HOST)
            if hp is None:
                raise AssertionError(f"{s.name}: no host-pool placement")
            if hp.nbytes < s.host_nbytes:
                raise AssertionError(
                    f"{s.name}: host slot {hp.nbytes}B < compressed copy "
                    f"{s.host_nbytes}B")


def optim_slot_specs(graph: LayerGraph, ordered: OrderedTensors,
                     prefetch_margin: int) -> List[Tuple[Any, OptimSlot]]:
    """(LayerNode, OptimSlot) for every layer owning trainable weights.

    E-shared unrolled copies (``shares_weights_with``) and frozen layers
    carry no optimizer state of their own and get no slot.
    """
    out: List[Tuple[Any, OptimSlot]] = []
    for l in graph.layers:
        if l.kind not in WEIGHTED_KINDS or not l.trainable:
            continue
        if l.shares_weights_with or not l.weight_shapes():
            continue
        eo_cg = ordered.layer_orders[l.name][1]
        nbytes = 2 * l.weight_nbytes()          # m and v, fp32
        n_elems = nbytes // 4
        out.append((l, OptimSlot(
            layer=l.name,
            name=f"O:{l.name}",
            n_elems=n_elems,
            nbytes=nbytes,
            host_nbytes=compressed_nbytes(n_elems),
            prefetch_eo=max(0, eo_cg - prefetch_margin),
            read_eo=eo_cg,
            swapout_eo=eo_cg + 1,
        )))
    return out


def plan_optim_offload(graph: LayerGraph, ordered: OrderedTensors,
                       config) -> Optional[OptimPlan]:
    """Price and pack the optimizer slots; None when nothing is eligible.

    The same joint cost model as the activation offload lane prices the
    decision: offloading costs ``dma_bytes_per_step`` bus time plus the
    de/requantization FLOPs (``config.dma_gbps`` / ``config.device_tflops``,
    remat-policy defaults when unset), and buys back
    ``resident_bytes - device_peak_bytes`` of device memory; keeping
    resident costs nothing but holds the full 2x-params footprint.  The
    honest prices land in :meth:`OptimPlan.summary` — the BENCH row and
    the serving admission controller consume them.
    """
    pairs = optim_slot_specs(graph, ordered, config.prefetch_margin)
    if not pairs:
        return None
    compress = bool(config.optim_compress)
    slots = tuple(
        s if compress else dataclasses.replace(s, host_nbytes=s.nbytes)
        for _, s in pairs)

    # fp32 working buffers over their CG windows -> separate device region
    device_specs = [
        TensorSpec(name=s.name, shape=(s.n_elems,), dtype="float32",
                   lifespan=Lifespan.BACKWARD, create_mode=CreateMode.CREATE,
                   exec_orders=(s.prefetch_eo, s.swapout_eo))
        for s in slots
    ]
    device = get_planner(config.planner).plan(
        _SpecSet(device_specs, ordered.eo_max))

    # persistent compressed copies -> host pool (live the whole iteration:
    # the state must survive from one step's swap-out to the next's prefetch)
    host_specs = [
        TensorSpec(name=s.name + _HOST, shape=(s.host_nbytes,), dtype="int8",
                   lifespan=Lifespan.MAX, create_mode=CreateMode.CREATE,
                   exec_orders=(0, ordered.eo_max))
        for s in slots
    ]
    host = get_planner(config.host_planner).plan(
        _SpecSet(host_specs, ordered.eo_max))

    dma_gbps = config.dma_gbps if config.dma_gbps else _DEFAULT_DMA_GBPS
    tflops = config.device_tflops if config.device_tflops \
        else _DEFAULT_DEVICE_TFLOPS
    dma_bytes = sum(s.dma_bytes for s in slots)
    flops = (_COMPRESS_FLOPS_PER_ELEM * sum(s.n_elems for s in slots)
             if compress else 0)

    plan = OptimPlan(
        slots=slots, device=device, host=host, compress=compress,
        resident_bytes=sum(_align(s.nbytes) for s in slots),
        est_dma_s_per_step=dma_bytes / (dma_gbps * 1e9),
        est_compress_s_per_step=flops / (tflops * 1e12),
    )
    plan.validate()
    return plan


# ---------------------------------------------------------------------------
# Numerical runtime: host-side compressed state + offloaded AdamW update
# ---------------------------------------------------------------------------

# bytes between two views of the pinned host buffer
_HOST_ALIGN = 64


def _requantize_(total: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 residual: torch.Tensor) -> None:
    """``q, scale = _q(total)`` and ``residual = total - _deq(q, scale)``,
    written into the given tensors with one temporary: the same fp32 ops
    as ``_q``/``_deq`` (the clamped, rounded quotients are the int8 values
    exactly, so scaling them back is ``_deq``), bit for bit."""
    n = total.numel()
    nb = q.shape[0]
    blocks = total.view(nb, CBLOCK) if nb * CBLOCK == n \
        else torch.nn.functional.pad(total, (0, nb * CBLOCK - n)).view(
            nb, CBLOCK)
    top = torch.linalg.vector_norm(blocks, ord=math.inf, dim=1, keepdim=True)
    s = top / torch.full((), 127.0, dtype=top.dtype, device=top.device)
    s = torch.where(s == 0, torch.ones_like(s), s)
    scale.copy_(s)
    work = torch.div(blocks, s)
    work.round_().clamp_(-127, 127)
    q.copy_(work)
    work.mul_(s)
    torch.sub(total, work.view(-1)[:n], out=residual)


class OptimRuntime:
    """Host tier of the offloaded optimizer: compressed copies + EF residual.

    One entry per :class:`OptimSlot`: the int8 block-scaled host copy of the
    layer's flattened ``m || v`` (or the exact fp32 copy when the plan is
    uncompressed) plus, under compression, the fp32 error-feedback residual
    that re-injects each re-quantization's rounding error into the next.
    The residual never crosses the bus; only :meth:`prefetch`'s host copy
    (H2D) and :meth:`swap_out`'s fp32 state (D2H) are DMA, both through a
    transfer engine's optimizer lane
    (:class:`repro_torch.core.exec.store.TransferEngine`).

    ``device`` is the working tier: the CUDA card when None (raises
    without one).  There the host copies are views of one pinned buffer
    allocated here, and D2H lands in a pinned staging buffer of the
    largest slot's size, reused by every slot and fenced before the host
    reads it.  ``timings`` accumulates the update's split: ``h2d_s``,
    ``device_s`` (dequantize, decode and the AdamW math) and ``d2h_s``
    from CUDA events on the card's clock (the host clock on the CPU), and
    ``host_quantize_s`` (encode, error feedback, re-quantize) on the host
    clock.
    """

    def __init__(self, plan: OptimPlan, graph: LayerGraph,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 device: DeviceLike = None):
        self.plan = plan
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.count = 0
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        # per-layer flat layout: (wname, shape, size) in weight_shapes order
        self.layouts: Dict[str, List[Tuple[str, Tuple[int, ...], int]]] = {}
        self.halves: Dict[str, int] = {}
        self.host_state: Dict[str, Any] = {}
        self.residual: Dict[str, torch.Tensor] = {}
        self.timings = dict.fromkeys(
            ("h2d_s", "device_s", "d2h_s", "host_quantize_s"), 0.0)
        self._events: List[Tuple[str, Any, Any]] = []
        self._engine = None
        for s in plan.slots:
            l = graph.layer(s.layer)
            self.layouts[s.layer] = [
                (w, tuple(shape), int(math.prod(shape)) if shape else 1)
                for w, shape in l.weight_shapes().items()]
            self.halves[s.layer] = sum(
                sz for _, _, sz in self.layouts[s.layer])
        self._pin_host_copies()
        self.staging = self._host_buffer(
            max((s.n_elems for s in plan.slots), default=0) * 4
            if plan.compress else 0).view(torch.float32)
        # the quantized zero state depends only on (n_elems, half)
        zeros: Dict[Tuple[int, int], str] = {}
        for s in plan.slots:
            if not plan.compress:
                self.host_state[s.layer].zero_()
                continue
            key = (s.n_elems, self.halves[s.layer])
            self.residual[s.layer] = torch.empty(s.n_elems)
            if key in zeros:
                for part in ("q", "scale"):
                    self.host_state[s.layer][part].copy_(
                        self.host_state[zeros[key]][part])
                self.residual[s.layer].copy_(self.residual[zeros[key]])
                continue
            zeros[key] = s.layer
            # the host copy lives in encoded space: quantize encode(0)
            # so the first prefetch decodes back to exact zero moments
            # (raw zeros would decode v to exp(0) ~ 1)
            enc = self._encode(s.layer, torch.zeros(s.n_elems))
            hs = self.host_state[s.layer]
            _requantize_(enc, hs["q"], hs["scale"], self.residual[s.layer])

    def _host_buffer(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.cuda)

    def _pin_host_copies(self) -> None:
        """Every slot's host copy as a view of ONE host buffer (pinned on
        the card): int8 blocks and fp32 scales, or the fp32 state."""
        layout, at = [], 0
        for s in self.plan.slots:
            nb = -(-s.n_elems // CBLOCK)
            parts = ((("q", torch.int8, (nb, CBLOCK)),
                      ("scale", torch.float32, (nb, 1)))
                     if self.plan.compress
                     else (("state", torch.float32, (s.n_elems,)),))
            for key, dtype, shape in parts:
                nbytes = math.prod(shape) * dtype.itemsize
                layout.append((s.layer, key, dtype, shape, at, nbytes))
                at += -(-nbytes // _HOST_ALIGN) * _HOST_ALIGN
        self.host_buf = self._host_buffer(at)
        for layer, key, dtype, shape, off, nbytes in layout:
            view = self.host_buf[off:off + nbytes].view(dtype).view(shape)
            if key == "state":
                self.host_state[layer] = view
            else:
                self.host_state.setdefault(layer, {})[key] = view

    @property
    def host_bytes(self) -> int:
        """Host bytes this runtime holds: the host copies' buffer, the
        staging buffer and the EF residual."""
        return (self.host_buf.numel() + self.staging.numel() * 4
                + sum(r.numel() * 4 for r in self.residual.values()))

    @property
    def engine(self):
        """The transfer engine of updates run outside a replay: a
        :class:`~repro_torch.core.exec.store.DeviceStreamEngine` on the
        working device, made on first use."""
        if self._engine is None:
            from repro_torch.core.exec.store import DeviceStreamEngine
            self._engine = DeviceStreamEngine(self.device)
        return self._engine

    # --------------------------------------------------------- quant space
    # The m half quantizes linearly (signed, roughly normal — the int8
    # grid fits; a collapsed m merely zeroes one step's momentum, which
    # error feedback re-injects).  The v half quantizes in LOG space:
    # v spans orders of magnitude within one block, and a small-v element
    # that linear int8 collapses to zero turns the update denominator
    # into ``eps`` — a 1e8x update explosion.  Encoding 0.5*log(v+floor)
    # makes the int8 grid error *multiplicative* on sqrt(v): with block
    # absmax <= 0.5*|log(floor)| ~ 18.4 the grid is ~0.145, so the
    # denominator is off by at most e^0.0725 ~ 7.5% — bounded, never
    # collapsed.  The floor maps v=0 to an exactly-representable block
    # constant that decodes back to exactly 0.
    _V_LOG_FLOOR = 1e-16

    def _encode(self, layer: str, state: torch.Tensor) -> torch.Tensor:
        """Encode ``state`` in place (it is the host's own copy)."""
        v = state[self.halves[layer]:]
        v.clamp_(min=0.0).add_(self._V_LOG_FLOOR).log_().mul_(0.5)
        return state

    def _decode(self, layer: str, enc: torch.Tensor) -> torch.Tensor:
        """Decode ``enc`` in place (a fresh dequantized tensor)."""
        v = enc[self.halves[layer]:]
        v.mul_(2.0).exp_().sub_(self._V_LOG_FLOOR).clamp_(min=0.0)
        return enc

    # ------------------------------------------------------------- transfers
    def _timed(self, kind: str, t0: float, span) -> None:
        """Credit a transfer to ``timings[kind]``: its (start, end) card
        events once they are read, or the host clock since ``t0`` when
        the engine finished the copy on return (``span`` None)."""
        if span is None:
            self.timings[kind] += time.perf_counter() - t0
        else:
            self._events.append((kind, *span))

    def prefetch(self, layer: str, engine, stats, host_offset: int = -1
                 ) -> List[torch.Tensor]:
        """H2D: issue the copy of ``layer``'s host copy (int8 blocks and
        scales, or the fp32 state) on ``engine``'s optimizer lane; returns
        the device copies, readable after ``engine.opt_fence``."""
        s = self.plan.slot(f"O:{layer}")
        hs = self.host_state[layer]
        t0 = time.perf_counter()
        copies, span = engine.opt_swap_in(
            s.name, s.nbytes, s.host_nbytes, stats, host_offset,
            srcs=[hs["q"], hs["scale"]] if self.plan.compress else [hs])
        self._timed("h2d_s", t0, span)
        return copies

    def load(self, layer: str, copies: List[torch.Tensor]) -> torch.Tensor:
        """The fp32 working state from the landed copies: dequantized and
        decoded on the working device when compressed."""
        if not self.plan.compress:
            return copies[0]
        n = self.plan.slot(f"O:{layer}").n_elems
        q, scale = copies
        return self._math(lambda: self._decode(layer, _deq(q, scale, (n,))))

    def _math(self, fn):
        """Run ``fn`` on the working device, its time credited to
        ``device_s``."""
        if not self.cuda:
            t0 = time.perf_counter()
            out = fn()
            self.timings["device_s"] += time.perf_counter() - t0
            return out
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        done.record()
        self._events.append(("device_s", start, done))
        return out

    def swap_out(self, layer: str, state: torch.Tensor, engine):
        """D2H of the updated state on ``engine``'s optimizer lane: into
        the host copy when uncompressed, into the staging buffer
        otherwise.  Returns what :meth:`settle` needs to finish it."""
        s = self.plan.slot(f"O:{layer}")
        dst = (self.staging[:s.n_elems] if self.plan.compress
               else self.host_state[layer])
        t0 = time.perf_counter()
        span = engine.opt_swap_out(s.name, state, dst)
        self._timed("d2h_s", t0, span)
        return layer, dst, None if span is None else span[1]

    def settle(self, owed) -> None:
        """Wait for an issued D2H, then (compressed) re-quantize it on the
        host with error feedback."""
        layer, dst, landed = owed
        if landed is not None:
            landed.synchronize()
        if not self.plan.compress:
            return
        t0 = time.perf_counter()
        # EF runs in the quantization (encoded) space: the residual
        # carries the encoded-domain rounding error forward
        total = self._encode(layer, dst).add_(self.residual[layer])
        hs = self.host_state[layer]
        _requantize_(total, hs["q"], hs["scale"], self.residual[layer])
        self.timings["host_quantize_s"] += time.perf_counter() - t0

    def resolve_timings(self) -> None:
        """Credit the card's event spans to ``timings`` (after a
        synchronisation; nothing to do on the CPU)."""
        if not self._events:
            return
        torch.cuda.synchronize(self.device)
        for kind, start, done in self._events:
            self.timings[kind] += start.elapsed_time(done) / 1e3
        self._events.clear()

    # --------------------------------------------------------------- packing
    def unpack(self, layer: str, flat):
        """Flat ``m || v`` vector -> ({wname: m}, {wname: v})."""
        layout = self.layouts[layer]
        half = sum(sz for _, _, sz in layout)
        ms, vs, off = {}, {}, 0
        for wname, shape, sz in layout:
            ms[wname] = flat[off:off + sz].reshape(shape)
            vs[wname] = flat[half + off:half + off + sz].reshape(shape)
            off += sz
        return ms, vs

    def pack(self, layer: str, ms, vs):
        layout = self.layouts[layer]
        parts = [ms[w].reshape(-1) for w, _, _ in layout]
        parts += [vs[w].reshape(-1) for w, _, _ in layout]
        return torch.cat(parts)


class OffloadedStep:
    """One AdamW step of ``runtime`` over ``params``, slot by slot.

    A replay drives it at the slot's planned ops
    (``cp.loss_and_grads(..., optim=step)``): at ``OptPrefetch``
    :meth:`prefetch` issues the H2D of the slot's host copy on the
    replay's engine; after the fence at the layer's CG phase, at
    ``OptSwapOut``, :meth:`update` decodes the landed state, applies the
    AdamW math with the layer's final grads and issues the updated
    state's D2H; :meth:`finish`, at the replay's end, settles the last
    D2H and leaves the updated params in :attr:`new_params`.  The host
    re-quantizes one slot while the card runs on.  The bias corrections
    are Python floats (fp32 when applied), as in the reference's runtime.
    ``params`` need not be the replay's own: the step updates them with
    the grads the replay computes.  Layers without a slot (frozen,
    E-shared) keep their params untouched.
    """

    def __init__(self, runtime: OptimRuntime, params):
        runtime.count += 1
        t = float(runtime.count)
        self.runtime = runtime
        self.params = params
        self.new_params: Dict[str, Dict[str, torch.Tensor]] = {
            ln: dict(entry) for ln, entry in params.items()}
        self._c = (1.0 - runtime.b1 ** t, 1.0 - runtime.b2 ** t)
        self._corr = None
        self._landed: Dict[str, List[torch.Tensor]] = {}
        self._owed = None

    def prefetch(self, engine, layer: str, stats, host_offset: int = -1
                 ) -> None:
        self._landed[layer] = self.runtime.prefetch(layer, engine, stats,
                                                    host_offset)

    def update(self, engine, layer: str, grads) -> None:
        """The slot's update, after its copy was fenced: ``grads`` are
        the layer's final grads (None when no gradient reached it; the
        layer's params and state then stay as they were)."""
        rt = self.runtime
        copies = self._landed.pop(layer)
        if grads is None:
            return
        flat = rt.load(layer, copies)
        del copies
        if self._corr is None:
            # fp32 tensors on the device: a true division, as the
            # reference's (dividing by a Python scalar on the card
            # multiplies by its reciprocal)
            self._corr = [torch.full((), c, dtype=torch.float32,
                                     device=flat.device) for c in self._c]
        b1, b2, eps = rt.b1, rt.b2, rt.eps
        lr, wd = rt.lr, rt.weight_decay
        corr, params = self._corr, self.params

        def adamw_math():
            ms, vs = rt.unpack(layer, flat)
            for wname, _, _ in rt.layouts[layer]:
                g = grads[wname].to(torch.float32)
                p = params[layer][wname]
                m = b1 * ms[wname] + (1 - b1) * g
                v = b2 * vs[wname] + (1 - b2) * g * g
                upd = (m / corr[0]) / (torch.sqrt(v / corr[1]) + eps)
                self.new_params[layer][wname] = (
                    p - lr * (upd + wd * p.to(torch.float32))).to(p.dtype)
                ms[wname], vs[wname] = m, v
            return rt.pack(layer, ms, vs)

        packed = rt._math(adamw_math)
        del flat
        if self._owed is not None:
            rt.settle(self._owed)
        self._owed = rt.swap_out(layer, packed, engine)

    def finish(self):
        """Settle the last D2H and read the card's timings; returns
        :attr:`new_params`."""
        if self._owed is not None:
            self.runtime.settle(self._owed)
            self._owed = None
        self._landed.clear()
        self.runtime.resolve_timings()
        return self.new_params


def offloaded_update(runtime: OptimRuntime, params, grads, stats=None,
                     engine=None):
    """One AdamW step through the offload dance, outside a replay; returns
    new params.

    The same :class:`OffloadedStep` a replay drives, walked over the slots
    in prefetch order on ``engine`` (the runtime's own
    :attr:`OptimRuntime.engine` when None): each slot's H2D is issued one
    slot ahead of its update.  ``stats`` (a ``SwapExecStats``) accumulates
    the ``opt_*`` counters.
    """
    from repro_torch.core.exec.store import SwapExecStats
    engine = engine if engine is not None else runtime.engine
    stats = stats if stats is not None else SwapExecStats()
    step = OffloadedStep(runtime, params)
    slots = [s for s in sorted(runtime.plan.slots,
                               key=lambda s: s.prefetch_eo)
             if s.layer in grads]
    for i, s in enumerate(slots):
        if i == 0:
            step.prefetch(engine, s.layer, stats)
        if i + 1 < len(slots):
            step.prefetch(engine, slots[i + 1].layer, stats)
        engine.opt_fence(s.name, stats)
        step.update(engine, s.layer, grads[s.layer])
        stats.opt_prefetches += 1
        stats.opt_swap_outs += 1
        stats.opt_dma_bytes += s.host_nbytes + s.nbytes
        stats.opt_compressed_bytes += s.host_nbytes
    engine.drain(stats)
    return step.finish()
