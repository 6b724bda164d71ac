"""Train, prefill and decode steps, on one device or on a mesh.

Port of ``repro/train/step.py``: ``make_train_step``, ``make_prefill_step``
and ``make_decode_step``, and ``build_step``, which picks one by the shape's
kind.  Without a mesh the steps are the model calls themselves (the serve
steps without autograd).  With a mesh (``repro_torch.launch.mesh``) every
family's train, prefill and decode steps run sharded over ``(data,
model)`` or ``(pod, data, model)``, every placement from the reference's
rule tables
(``repro_torch.sharding``):

* each parameter is stored as this rank's block of it
  (``param_shardings``: vocabulary and mlp columns over ``model``; under
  FSDP the ``embed`` dim over ``data``), each AdamW moment as its block
  under :func:`opt_state_spec_tree` (``embed`` over ``data`` always:
  ZeRO-1; int8 moments as blocks of the flat parameter over (data,
  model), :func:`_int8_leaf_`), and the batch over (pod, data), or
  whole on every rank where it does not split (the reference's rules
  then replicate the activations over ``data``, and an FSDP gather's
  backward keeps the rank's block of the gradient every rank holds
  whole: ``collectives.fetch``);
* the forward computes heads, mamba heads, mLSTM heads, experts, mlp
  columns and the vocabulary over ``model`` and gathers FSDP shards at
  use (``models/attention.py``, ``ssm.py``, ``xlstm.py``, ``moe.py``,
  ``layers.py``, ``transformer.py``); the sLSTM recurrence runs whole on
  every ``model`` rank;
* after the backward each gradient is summed over the batch axes (an
  FSDP gather's backward has reduce-scattered it over ``data`` already; a
  ZeRO-1 parameter's is reduce-scattered to its moment's block; then the
  block is all-reduced over ``pod``, where the mesh has one) and, for
  a replicated parameter each ``model`` rank computes only part of (the
  attention weights where the ranks split the heads, the router where
  they split the experts, a mamba layer's ``A_log``, ``D`` and
  ``dt_bias`` where they split its heads: each module's spec names them,
  ``sharding.api.SplitSpecs``), over ``model``;
* AdamW updates the moments' blocks and the parameters' matching blocks
  in place, and a ZeRO-1 parameter's blocks are gathered back over
  ``data``.

The loss is the mean over the global batch and ``grad_norm`` the norm of
the global gradient, every block counted once.  The decode step holds
the state in the reference's placement (``Model.decode_specs``) and
updates each rank's blocks in place; its layers fit their compute to
that placement.  A :class:`StepBundle` carries the placements as the
reference's does: ``in_shardings`` and ``out_shardings``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plan import CompiledMemoryPlan
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.sharding import api
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules as R
from repro_torch.sharding.rules import NamedSharding

@dataclasses.dataclass
class StepBundle:
    """The step function of one (arch, shape) cell and, for a train step,
    the compiled memory plan whose checkpoint policy the model installs
    around each block (the model's own plan at the micro-batch's tokens,
    ``transformer.memory_plan``).  On a mesh: ``in_shardings`` (the
    parameters', the optimizer state's and the batch's placements; the
    prefill step's parameters' and batch's) and ``out_shardings``, the
    mesh and the activation rules.  Calling the bundle calls ``fn``."""
    fn: Callable
    memory_plan: Optional[CompiledMemoryPlan] = None
    in_shardings: Any = None
    out_shardings: Any = None
    act_rules: Optional[Dict] = None
    mesh: Any = None
    init_state: Optional[Callable] = None

    def __call__(self, *args):
        return self.fn(*args)

    def shard_params(self, params: torch.nn.Module) -> torch.nn.Module:
        """Keep this rank's block of each of ``params`` (a module holding
        the global values), in place; a no-op without a mesh."""
        if self.mesh is None:
            return params
        return api.shard_module(params, self.in_shardings[0])

    def shard_state(self, state):
        """This rank's blocks of a global decode state (copies); the state
        itself without a mesh."""
        if self.mesh is None:
            return state
        return _shard_state(state, self.in_shardings[1])


def opt_state_spec_tree(opt_state, param_spec_tree):
    """Logical axes of an optimizer state, mirroring the parameters': fp32
    and bf16 moments take their parameter's axes; an int8 moment's
    ``{"q", "scale"}`` get ``("qblocks", None)`` (the block dim over
    (data, model) jointly); every other entry (``count``) is replicated.
    The reference's ``opt_state_spec_tree``; ``param_spec_tree`` is
    ``Model.param_specs()``."""
    def one_moment(m, pspec):
        if isinstance(m, dict):                      # int8 {"q", "scale"}
            return {"q": ("qblocks", None), "scale": ("qblocks", None)}
        return tuple(pspec)

    out = {"mu": {n: {k: one_moment(m, param_spec_tree[n])
                      for k, m in mv.items()}
                  for n, mv in opt_state["mu"].items()}}
    for k in opt_state:
        if k != "mu":
            out[k] = ()
    return out


def _batch_local(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's rows of every input (the active rules' ``batch``; every
    row where the rules give it None)."""
    return {k: R.constrain(v, "batch", *([None] * (v.dim() - 1)))
            if v.dim() else v for k, v in batch.items()}


def _check_mesh_model(cfg, mesh) -> None:
    m = mesh.shape.get("model", 1)
    if cfg.family == "ssm" and cfg.n_heads % m:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_heads} mLSTM heads do not split over a "
            f"model axis of {m} ranks (ROADMAP item 11: only whole heads a "
            "rank are run)")


def make_train_step(model: Model, optimizer: Optimizer, shape: ShapeConfig,
                    *, mesh=None, microbatches: int = 1) -> StepBundle:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is the model's trainable module and ``opt_state`` the
    optimizer state (``bundle.init_state(params)``); both are updated in
    place (the reference donates them) and returned.  The step is
    ``value_and_grad(model.loss_fn)``: with ``microbatches`` > 1 the
    batch is split along its first axis, the grads of the chunks summed
    and divided by ``microbatches``, and so is the loss.  Then the
    optimizer's in-place update (``Optimizer.update_``), and metrics
    ``{"loss", "grad_norm"}``, the latter the fp32 norm over all grads.
    The values stay on the device; reading one waits for the step.

    On a ``mesh``, ``params`` holds this rank's blocks
    (``bundle.shard_params``), ``batch`` the global batch (every rank the
    same; each takes its rows, or all of them where the batch does not
    split over (pod, data): the reference's rules then replicate the
    activations over ``data``), and the metrics are the global ones.
    Without one every block is the whole tensor and no collective is
    made: the step is the one-device step.
    """
    micro_tokens = (shape.global_batch // max(microbatches, 1)) \
        * shape.seq_len
    bundle = StepBundle(fn=None, memory_plan=transformer.memory_plan(
        model.cfg, micro_tokens))
    act, p_shard, q_shard, batch_axes, axes = None, None, None, (), ()
    zero = collections.defaultdict(list)       # (dim, axis) ZeRO-1 cuts
    rep = collections.defaultdict(lambda: 1)   # ranks holding each block
    partial = frozenset()                      # summed over model
    flat = False
    if mesh is not None:
        act, p_shard, zero, rep, partial = _mesh_layout(
            model, optimizer, shape, mesh, microbatches, bundle)
        batch_axes, axes = tuple(act["batch"] or ()), mesh.axis_names
        # moments that are blocks of the flat parameter (int8) line up
        # with no block of it: each leaf is updated by _int8_leaf_
        flat = optimizer.adamw.flat
        if flat:
            q_shard = {n: mv["m"]
                       for n, mv in bundle.in_shardings[1]["mu"].items()}

    def blocks(named):
        """The block of each parameter its moments cover (a view)."""
        out = {}
        for n, p in named.items():
            t = p.data
            for d, axis in zero[n]:
                size = t.shape[d] // mesh.shape[axis]
                t = t.narrow(d, mesh.coords()[axis] * size, size)
            out[n] = t
        return out

    def reduce_grad(n: str, g: torch.Tensor) -> torch.Tensor:
        if n in partial:
            # each model rank computed its own part through this
            # replicated parameter: the parts of its gradient add up
            g = C.all_reduce(g, "model")
        # the axes that cut the gradient first (data's reduce-scatter),
        # so that the others (pod's all-reduce) sum the block only
        used = p_shard[n].used_axes() if batch_axes else ()
        cuts = {a for _, a in zero[n]} | set(used)
        for axis in sorted(batch_axes, key=lambda a: a not in cuts):
            if axis in used:
                continue            # the FSDP gather's reduce-scatter
            dims = [d for d, a in zero[n] if a == axis]
            g = C.reduce_scatter(g, axis, dims[0]) if dims \
                else C.all_reduce(g, axis)
        for d, axis in zero[n]:
            if axis not in batch_axes:
                # a batch the axis does not split: every rank along it
                # holds the whole gradient, and keeps its block
                size = g.shape[d] // mesh.shape[axis]
                g = g.narrow(d, mesh.coords()[axis] * size,
                             size).contiguous()
        return g

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        if microbatches > 1:
            chunks = [{k: v.chunk(microbatches)[i] for k, v in batch.items()}
                      for i in range(microbatches)]
        else:
            chunks = [batch]
        loss = 0.0
        with R.use_mesh(mesh, act):
            for chunk in chunks:
                part = model.loss_fn(params, _batch_local(chunk))
                part.backward()
                loss = loss + part.detach()
            grads = {}
            for n, p in named.items():
                # a parameter the loss does not reach (in probe mode: the
                # bypassed kernels' weights) gets a zero gradient, as
                # jax.grad gives
                g = torch.zeros_like(p) if p.grad is None else p.grad
                grads[n] = reduce_grad(n, g)
                if grads[n] is not g:     # the unreduced gradient goes as
                    p.grad = None         # soon as it is reduced
            if microbatches > 1:
                for g in grads.values():
                    g.div_(microbatches)
                loss = loss / microbatches
            for axis in batch_axes:
                loss = C.all_reduce(loss, axis)
            sq = sum(torch.sum(torch.square(g.float())) / rep[n]
                     for n, g in grads.items())
            for axis in axes:
                sq = C.all_reduce(sq, axis)
            gnorm = torch.sqrt(sq)
            if flat:
                corrections = optimizer.adamw.begin(opt_state)
                for n, p in named.items():
                    p.grad = None
                    g = C.gather_global(grads.pop(n), p_shard[n])
                    _int8_leaf_(optimizer.adamw, g, opt_state["mu"][n], p,
                                p_shard[n], q_shard[n], corrections)
            else:
                optimizer.update_(grads, opt_state, blocks(named))
            with torch.no_grad():
                for n, p in named.items():
                    for d, axis in zero[n]:
                        p.data = C.all_gather(blocks({n: p})[n], axis, d)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    bundle.fn = train_step
    if flat:
        # this rank's blocks only, allocated at their shapes
        bundle.init_state = lambda params: optimizer.adamw.init_at(
            _shard_shapes(bundle.in_shardings[1]["mu"],
                          _moment_shapes(optimizer, model.param_shapes())
                          ["mu"]),
            next(params.parameters()).device)
    else:
        bundle.init_state = lambda params: optimizer.init(
            blocks(dict(params.named_parameters())))
    return bundle


def _int8_leaf_(adamw, g_whole: torch.Tensor, mv, p: torch.Tensor,
                p_shard: NamedSharding, q_shard: Dict[str, NamedSharding],
                corrections) -> None:
    """One parameter's int8 AdamW step on a mesh, as the reference places
    it: this rank's moments ``mv`` are the blocks ``q_shard`` (the ``q``
    and ``scale`` placements) gives it of the quantised flat global
    tensor, dim 0 the blocks: a contiguous range of the row-major
    elements that does not line up with the rank's block of the
    parameter.  ``g_whole`` is the summed gradient, whole (the rank's
    block gathered over the axes that split it).  The rank gathers the
    moments' blocks whole, as they are before the step, updates them
    whole (the optimizer's parts, element by element), updates its block
    of the parameter from them and stores its own run of blocks.  Where
    the block count does not split over the mesh the moments are whole on
    every rank and so is the run.  A leaf of N fp32 elements brings into
    each rank 4 N (1 - 1 / parts) bytes of gradient and about 2 N (1 - 1
    / blocks' parts) bytes of the moments' blocks; every rank dequantises
    and updates the whole leaf's moments."""
    old = {k: {part: C.gather_global(t, q_shard[part])
               for part, t in mv[k].items()} for k in ("m", "v")}
    m, v = adamw.moments(g_whole, old, g_whole.shape)
    del old
    adamw.param(p.data, p_shard.shard(m), p_shard.shard(v), corrections)
    rows = next(iter(mv["m"].values())).shape[0]
    r0 = next(iter(q_shard.values())).block(0) * rows
    adamw.store(mv, m, v, rows=(r0, r0 + rows))


def _shard_shapes(shardings, shapes):
    """The tree of this rank's block shapes of ``shapes``' leaves (tuples)
    under ``shardings``' placements (the same tree)."""
    if isinstance(shapes, dict):
        return {k: _shard_shapes(shardings[k], v) for k, v in shapes.items()}
    return shardings.shard_shape(shapes)


def _moment_shapes(optimizer: Optimizer, shapes):
    """The AdamW state's tree of leaf shapes: each moment's by the
    optimizer's layout (``AdamWParts.moment_shape``)."""
    one = optimizer.adamw.moment_shape
    return {"mu": {n: {"m": one(s), "v": one(s)} for n, s in shapes.items()},
            "count": ()}


def _mesh_layout(model: Model, optimizer: Optimizer, shape: ShapeConfig,
                 mesh, microbatches: int, bundle: StepBundle):
    """The train step's placements on ``mesh``, recorded on ``bundle``:
    returns the activation rules, the parameters' placements, each
    parameter's ZeRO-1 cuts, how many ranks hold each gradient block the
    optimizer is given and the parameters whose gradients are partial
    over ``model``."""
    cfg = model.cfg
    _check_mesh_model(cfg, mesh)
    if optimizer.adamw is None:
        raise NotImplementedError(
            f"{optimizer.name} on a mesh: the sharded step updates AdamW "
            "moments (fp32, bf16 or int8)")
    act = api.activation_rules(cfg, shape, mesh)
    act["qblocks"] = ("data", "model")
    batch_axes = act["batch"]
    if shape.global_batch % microbatches or (
            batch_axes is not None and (shape.global_batch // microbatches)
            % math.prod(mesh.shape[a] for a in batch_axes)):
        raise NotImplementedError(
            f"a batch of {shape.global_batch} in {microbatches} "
            f"micro-batches does not split over {batch_axes}: each "
            "micro-batch takes the global batch's placement, so it must "
            "split as the global batch does")
    specs, shapes = model.param_specs(), model.param_shapes()
    p_shard = api.param_shardings(mesh, cfg, specs, shapes)
    abstract = _moment_shapes(optimizer, shapes)
    o_shard = api.tree_shardings(
        mesh, opt_state_spec_tree(abstract, specs),
        {**act, "embed": ("data",), "qblocks": ("data", "model")}, abstract)
    replicated = NamedSharding(mesh, ())
    if batch_axes is None:
        b_shard = replicated
    else:
        b_shard = NamedSharding(mesh, (tuple(batch_axes)
                                       if len(batch_axes) > 1
                                       else batch_axes[0],))
    bundle.in_shardings = (p_shard, o_shard, b_shard)
    bundle.out_shardings = (p_shard, o_shard, {"loss": replicated,
                                               "grad_norm": replicated})
    bundle.act_rules, bundle.mesh = act, mesh
    with R.use_mesh(mesh, act):
        partial = api.partial_over_model(cfg, model.specs(), p_shard)
    if optimizer.adamw.flat:
        # the flat moment blocks cut no parameter: the optimizer is given
        # each parameter's gradient at its own block
        return (act, p_shard, {n: [] for n in shapes},
                {n: p_shard[n].replication() for n in shapes}, partial)
    m_shard = {n: o_shard["mu"][n]["m"] for n in shapes}
    return (act, p_shard,
            {n: _zero_dims(n, p_shard[n], m_shard[n]) for n in shapes},
            {n: m_shard[n].replication() for n in shapes}, partial)


def _zero_dims(name: str, param: NamedSharding, moment: NamedSharding):
    """(dim, axis) pairs along which the moments' placement cuts a
    parameter's block further (ZeRO-1: ``embed`` over ``data`` for a
    parameter stored whole along it)."""
    out = []
    for d in range(max(len(param.spec), len(moment.spec))):
        have, want = param.dim_axes(d), moment.dim_axes(d)
        if want[:len(have)] != have:
            raise NotImplementedError(f"{name}: the moments' placement "
                                      f"{moment.spec} does not refine the "
                                      f"parameter's {param.spec}")
        out += [(d, a) for a in want[len(have):]]
    if len(out) > 1:
        raise NotImplementedError(f"{name}: the moments cut the parameter "
                                  f"along more than one axis {out}")
    return out


def make_prefill_step(model: Model, *, mesh=None,
                      shape: Optional[ShapeConfig] = None) -> StepBundle:
    """(params, batch) -> logits (B, S, padded_vocab): ``model.forward``
    without autograd.  ``batch`` holds ``tokens`` (B, S) and, for the
    multimodal families, ``enc_frames`` (audio) or ``image_embeds`` (vlm),
    (B, T, d).

    On a ``mesh``: ``params`` holds this rank's blocks
    (``bundle.shard_params``) and ``batch`` the global batch; the result
    is this rank's block of the logits, its rows of the batch (every row
    where the batch does not split over (pod, data)) and, where the
    vocabulary is split over ``model``, its block of the columns (the
    reference's out placement: ``out_shardings``, for ``shape``'s batch,
    or a batch that splits if none is given)."""
    cfg = model.cfg

    @torch.no_grad()
    def prefill(params, batch):
        act = None
        if mesh is not None:
            b, s = batch["tokens"].shape
            act = api.activation_rules(
                cfg, ShapeConfig("prefill", s, b, "prefill"), mesh)
        with R.use_mesh(mesh, act):
            return model.forward(params, _batch_local(batch))

    if mesh is None:
        return StepBundle(fn=prefill)
    _check_mesh_model(cfg, mesh)
    p_shard = api.param_shardings(mesh, cfg, model.param_specs(),
                                  model.param_shapes())
    rows = _rows(mesh, () if shape is None
                 else api.activation_rules(cfg, shape, mesh)["batch"])
    return StepBundle(fn=prefill, in_shardings=(p_shard, None),
                      out_shardings=NamedSharding(mesh,
                                                  (rows, None, "model")),
                      mesh=mesh)


def _rows(mesh, batch_axes):
    """The spec entry of a batch dim: the batch axes (every one of the
    mesh's by default), None where the batch does not split."""
    if batch_axes is None:
        return None
    if batch_axes == ():
        batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return tuple(batch_axes) if len(batch_axes) > 1 else batch_axes[0]


def make_decode_step(model: Model, *, mesh=None,
                     shape: Optional[ShapeConfig] = None):
    """(params, cache, {"tokens": (B,), "cache_len": (B,)})
    -> (logits (B, padded_vocab), cache); the cache is updated in place.

    Without a ``mesh``, that function.  On one, a :class:`StepBundle` of
    the reference's placements for ``shape`` (its ``global_batch`` and
    ``seq_len``, the cache's length): ``in_shardings`` = (the parameters',
    the state's by ``model.decode_specs()`` under the activation rules,
    the tokens'), ``out_shardings`` = (the logits' over (batch,
    ``model``), the state's).  A batch that does not split over (pod,
    data) (batch 1 at ``long_500k``) is whole on every rank, and the
    rules put the state's sequence over ``data`` instead: the KV caches'
    positions (``kv_seq``, and over ``model`` too where the kv heads do
    not divide it) and the mLSTM state's key dim (``sp_seq``).  The
    bundle's function takes this rank's blocks of the parameters
    (``bundle.shard_params``) and of the state (``bundle.shard_state`` or
    ``bundle.init_state``) and the global tokens and lengths (each rank
    takes its rows), and returns this rank's block of the logits and the
    state, updated in place."""

    @torch.no_grad()
    def decode(params, state, batch):
        return model.decode_fn(params, state, batch["tokens"],
                               batch["cache_len"])

    if mesh is None:
        return decode
    cfg = model.cfg
    if shape is None:
        raise ValueError("a decode step on a mesh needs its shape (the "
                         "global batch and the cache's length)")
    _check_mesh_model(cfg, mesh)
    act = api.activation_rules(cfg, shape, mesh)
    p_shard = api.param_shardings(mesh, cfg, model.param_specs(),
                                  model.param_shapes())
    specs = model.decode_specs()
    # the state's leaves on the meta device: shapes and dtypes, nothing
    # allocated
    meta = model.decode_init(shape.global_batch, shape.seq_len,
                             device="meta")
    shapes = _map(lambda t: tuple(t.shape), meta)
    s_shard = api.tree_shardings(mesh, specs, act, shapes)
    unfit = api.tree_shardings(mesh, specs, act)
    flat_unfit, flat_shapes = _flat(unfit), _flat(shapes)
    for name, sh in _flat(s_shard).items():
        if sh.spec != flat_unfit[name].spec:
            raise NotImplementedError(
                f"{cfg.name}: decode state {name} {flat_shapes[name]} does "
                f"not split as the rules place it ({flat_unfit[name].spec}):"
                " only whole blocks are run (ROADMAP item 11)")
    rows = _rows(mesh, act["batch"])

    @torch.no_grad()
    def sharded(params, state, batch):
        with R.use_mesh(mesh, act):
            local = _batch_local(batch)
            return model.decode_fn(params, state, local["tokens"],
                                   local["cache_len"])

    bundle = StepBundle(fn=sharded,
                        in_shardings=(p_shard, s_shard,
                                      NamedSharding(mesh, (rows,) if rows
                                                    else ())),
                        out_shardings=(NamedSharding(mesh, (rows, "model")),
                                       s_shard),
                        act_rules=act, mesh=mesh)
    bundle.init_state = lambda device=None: _init_state(model, meta,
                                                         s_shard, device)
    return bundle


def _flat(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested dict as a flat one keyed by dotted paths."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def _shard_state(state, shardings):
    """This rank's block of every leaf of the global decode ``state``
    (copies)."""
    return {k: _shard_state(v, shardings[k]) for k, v in state.items()} \
        if isinstance(state, dict) \
        else shardings.shard(state).contiguous().clone()


def _init_state(model: Model, meta, shardings, device):
    """This rank's blocks of a fresh decode state (``meta``: its leaves on
    the meta device), allocated at their block shapes: every leaf of
    ``decode_init`` starts at one value (the mLSTM and sLSTM stabilisers
    at -1e30, the rest at 0), read off a state of one sequence of one
    position on the host."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    small = model.decode_init(1, 1, device="cpu")

    def one(m, s, sh):
        if isinstance(m, dict):
            return {k: one(m[k], s[k], sh[k]) for k in m}
        fill = s.flatten()[0]
        if not bool((s == fill).all()):
            raise ValueError("a decode state leaf does not start constant")
        return torch.full(sh.shard_shape(m.shape), fill.item(),
                          dtype=m.dtype, device=dev)

    return one(meta, small, shardings)


def build_step(model: Model, optimizer: Optional[Optimizer], mesh,
               shape: ShapeConfig, *, microbatches: int = 1) -> StepBundle:
    """The step of ``shape``'s kind on ``mesh``: the train step (with
    ``optimizer`` and ``microbatches``), the prefill or the decode step
    (the reference's ``build_step``)."""
    if shape.kind == "train":
        if optimizer is None:
            raise ValueError("a train step needs an optimizer")
        return make_train_step(model, optimizer, shape, mesh=mesh,
                               microbatches=microbatches)
    if shape.kind == "prefill":
        return make_prefill_step(model, mesh=mesh, shape=shape)
    return make_decode_step(model, mesh=mesh, shape=shape)
