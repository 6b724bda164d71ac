"""Layer-operation-basis graph IR (NNTrainer §4, Figure 3, Table 1).

NNTrainer is a *layer-operation-basis* framework: the unit of scheduling is
a layer's forward / compute-gradient / compute-derivative phase, not an
individual tensor op.  This module defines the graph IR that the Compiler's
Realizers lower, Algorithm 1 orders, and the Memory Planner packs.

A ``LayerNode`` declares, for a given batch size, the tensors it *requests*
from the Tensor Pool — each annotated with a :class:`Lifespan` and a
:class:`CreateMode` (see ``lifespan.py``).  The request rules below encode
the paper's Figure 4/5/6 exactly:

* weighted layers (linear / conv / lstm / embedding) save their **input**
  for compute-gradient  → input lifespan F+CG;
* in-place activations & batch-norm compute their derivative from the
  **output** → output lifespan F+CD, output storage is an ``MV`` view of
  the input, and the input's buffer is thereby released (Fig. 5);
* flatten/reshape outputs are ``RV`` views — merged regardless of interval
  overlap because data integrity is guaranteed (Fig. 6);
* incoming derivatives have Backward lifespan; weight gradients Backward;
  weights Max; time-unrolled weights are shared via ``E``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.lifespan import CreateMode, Lifespan, TensorSpec

# ---------------------------------------------------------------------------
# Layer kinds
# ---------------------------------------------------------------------------

WEIGHTED_KINDS = ("linear", "conv2d", "conv1d", "lstm", "embedding", "batchnorm")
INPLACE_KINDS = ("activation", "batchnorm")   # derivative computable from output
VIEW_KINDS = ("flatten", "reshape")           # RV: spec changes, data does not
LOSS_KINDS = ("loss_mse", "loss_ce")


@dataclasses.dataclass
class LayerNode:
    """One layer in the compiled graph.

    ``attrs`` carries kind-specific attributes:
      linear:   in_features, out_features, bias(bool)
      conv2d:   in_ch, out_ch, ksize, stride, padding("same"|"valid"), im2col(bool)
      activation: fn ("sigmoid"|"relu"|"tanh"|"softmax")
      lstm:     in_features, hidden, seq_len (1 for a single cell step)
      embedding: vocab, dim
      flatten/reshape: out_shape (without batch)
      pool2d:   ksize, stride
      add/concat: (inputs define arity), concat: axis
      loss_*:   (label shape == input shape)
      slice:    trainable(bool) — backbone sections get trainable=False
    """

    name: str
    kind: str
    inputs: List[str] = dataclasses.field(default_factory=list)   # producer layer names
    attrs: Dict = dataclasses.field(default_factory=dict)
    # Output activation shape per single example (no batch dim).
    out_shape: Tuple[int, ...] = ()
    trainable: bool = True
    # Set by RecurrentRealizer: name of the layer whose weights this unrolled
    # copy shares (Tensor-sharing mode E).
    shares_weights_with: Optional[str] = None
    # Set for the first layer / frozen backbone boundary: compute-derivative
    # can be skipped (paper Fig. 4: L0's CD order is parenthesised).
    needs_input_derivative: bool = True

    def weight_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Parameter name -> shape, matching the executor's conventions."""
        a = self.attrs
        if self.kind == "linear":
            shapes = {"w": (a["in_features"], a["out_features"])}
            if a.get("bias", True):
                shapes["b"] = (a["out_features"],)
            return shapes
        if self.kind == "conv2d":
            shapes = {"w": (a["out_ch"], a["in_ch"], a["ksize"], a["ksize"])}
            if a.get("bias", True):
                shapes["b"] = (a["out_ch"],)
            return shapes
        if self.kind == "conv1d":
            shapes = {"w": (a["out_ch"], a["in_ch"], a["ksize"])}
            if a.get("bias", True):
                shapes["b"] = (a["out_ch"],)
            return shapes
        if self.kind == "lstm":
            i, h = a["in_features"], a["hidden"]
            return {"wx": (i, 4 * h), "wh": (h, 4 * h), "b": (4 * h,)}
        if self.kind == "embedding":
            return {"w": (a["vocab"], a["dim"])}
        if self.kind == "batchnorm":
            c = a["channels"]
            return {"gamma": (c,), "beta": (c,)}
        return {}

    def weight_nbytes(self) -> int:
        return sum(
            int(math.prod(s)) * 4 for s in self.weight_shapes().values()
        )


@dataclasses.dataclass
class LayerGraph:
    """A topologically-ordered list of layers plus graph inputs.

    ``input_shape`` is per-example (no batch).  ``label_shape`` likewise.
    """

    layers: List[LayerNode]
    input_shape: Tuple[int, ...]
    label_shape: Tuple[int, ...]
    name: str = "model"

    def layer(self, name: str) -> LayerNode:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def consumers(self, name: str) -> List[LayerNode]:
        return [l for l in self.layers if name in l.inputs]

    def validate(self) -> None:
        seen = {"__input__"}
        for l in self.layers:
            for inp in l.inputs:
                if inp not in seen:
                    raise ValueError(
                        f"layer {l.name}: input {inp!r} not yet produced "
                        "(graph must be topologically ordered)"
                    )
            seen.add(l.name)


# ---------------------------------------------------------------------------
# Shape inference
# ---------------------------------------------------------------------------

def _conv_out_hw(h: int, w: int, k: int, stride: int, padding: str) -> Tuple[int, int]:
    if padding == "same":
        return (math.ceil(h / stride), math.ceil(w / stride))
    return ((h - k) // stride + 1, (w - k) // stride + 1)


def infer_shapes(graph: LayerGraph) -> Dict[str, Tuple[int, ...]]:
    """Per-example output shape for every layer (and ``__input__``)."""
    shapes: Dict[str, Tuple[int, ...]] = {"__input__": tuple(graph.input_shape)}
    for l in graph.layers:
        ins = [shapes[i] for i in l.inputs]
        a = l.attrs
        if l.kind == "input":
            out = ins[0]
        elif l.kind == "linear":
            out = ins[0][:-1] + (a["out_features"],)
        elif l.kind == "conv2d":
            c, h, w = ins[0]
            oh, ow = _conv_out_hw(h, w, a["ksize"], a.get("stride", 1),
                              a.get("padding", "same"))
            out = (a["out_ch"], oh, ow)
        elif l.kind == "conv1d":
            c, t = ins[0]
            out = (a["out_ch"], t)
        elif l.kind == "pool2d":
            c, h, w = ins[0]
            s = a.get("stride", a["ksize"])
            out = (c, h // s, w // s)
        elif l.kind in ("activation", "batchnorm", "dropout"):
            out = ins[0]
        elif l.kind in ("flatten",):
            out = (int(math.prod(ins[0])),)
        elif l.kind == "reshape":
            out = tuple(a["out_shape"])
        elif l.kind == "lstm":
            out = ins[0][:-1] + (a["hidden"],)
        elif l.kind == "embedding":
            out = ins[0] + (a["dim"],)
        elif l.kind == "add":
            out = ins[0]
        elif l.kind == "concat":
            axis = a.get("axis", -1)
            base = list(ins[0])
            base[axis] = sum(s[axis] for s in ins)
            out = tuple(base)
        elif l.kind == "multiout":
            out = ins[0]
        elif l.kind in LOSS_KINDS:
            out = ()  # scalar loss
        else:
            raise ValueError(f"unknown layer kind {l.kind!r}")
        l.out_shape = tuple(out)
        shapes[l.name] = tuple(out)
    return shapes


# ---------------------------------------------------------------------------
# Tensor requests (the Tensor Pool contents for one training iteration)
# ---------------------------------------------------------------------------

def _act_name(producer: str) -> str:
    return f"X:{producer}"


def _deriv_name(producer: str) -> str:
    return f"D:{producer}"


def tensor_requests(graph: LayerGraph, batch: int) -> List[Tuple[str, TensorSpec]]:
    """Enumerate every (requesting-layer, TensorSpec) pair for one iteration.

    Follows Figure 4's conventions.  Activation tensor ``X:<layer>`` is the
    output of ``<layer>`` (the graph input is ``X:__input__``); derivative
    tensor ``D:<layer>`` holds dLoss/d(output of <layer>).
    """
    infer_shapes(graph)
    shapes = {"__input__": graph.input_shape}
    for l in graph.layers:
        shapes[l.name] = l.out_shape

    reqs: List[Tuple[str, TensorSpec]] = []

    def act_spec(producer: str, lifespan: Lifespan, mode: CreateMode,
                 view_of: Optional[str] = None) -> TensorSpec:
        return TensorSpec(
            name=_act_name(producer),
            shape=(batch,) + tuple(shapes[producer]),
            lifespan=lifespan,
            create_mode=mode,
            view_of=view_of,
        )

    # Graph input: place-holder (external memory), saved through CG of its
    # consumers when they are weighted layers.
    first_consumer_weighted = any(
        l.kind in WEIGHTED_KINDS for l in graph.layers if "__input__" in l.inputs
    )
    reqs.append((
        graph.layers[0].name,
        act_spec(
            "__input__",
            Lifespan.FORWARD_GRAD if first_consumer_weighted else Lifespan.FORWARD,
            CreateMode.PLACEHOLDER,
        ),
    ))

    # Label: place-holder, needed by the loss layer during backward.
    reqs.append((
        graph.layers[-1].name,
        TensorSpec(
            name="X:__label__",
            shape=(batch,) + tuple(graph.label_shape),
            lifespan=Lifespan.FORWARD_BACKWARD,
            create_mode=CreateMode.PLACEHOLDER,
        ),
    ))

    for l in graph.layers:
        a = l.attrs
        # ---- output activation -------------------------------------------
        if l.kind in LOSS_KINDS:
            # Loss derivative overwrites the prediction in place (MV):
            # the Loss realizer guarantees d(pred) is computed from pred and
            # label only, so `D:<pred>` merges into `X:<pred>` (paper §5.1:
            # single-Linear ideal memory counts the prediction buffer once).
            pred = l.inputs[0]
            reqs.append((
                l.name,
                TensorSpec(
                    name=_deriv_name(pred),
                    shape=(batch,) + tuple(shapes[pred]),
                    lifespan=Lifespan.BACKWARD,
                    create_mode=CreateMode.MODIFY_VIEW,
                    view_of=_act_name(pred),
                ),
            ))
            # The predecessor reads this derivative during its own CG/CD —
            # register a second request under the predecessor's name so its
            # execution orders extend the tensor's live interval.
            if pred != "__input__":
                reqs.append((
                    pred,
                    TensorSpec(
                        name=_deriv_name(pred),
                        shape=(batch,) + tuple(shapes[pred]),
                        lifespan=Lifespan.BACKWARD,
                        create_mode=CreateMode.MODIFY_VIEW,
                        view_of=_act_name(pred),
                    ),
                ))
            continue

        if l.kind in ("activation",):
            # In-place: output is an MV view of the input activation; the
            # derivative is computed from the *output* (F + CD lifespan).
            reqs.append((
                l.name,
                act_spec(l.name, Lifespan.FORWARD_DERIV, CreateMode.MODIFY_VIEW,
                         view_of=_act_name(l.inputs[0])),
            ))
        elif l.kind == "multiout":
            # Pure fan-out: the output *is* the input (read-only view).
            reqs.append((
                l.name,
                act_spec(l.name, Lifespan.FORWARD, CreateMode.READONLY_VIEW,
                         view_of=_act_name(l.inputs[0])),
            ))
        elif l.kind in VIEW_KINDS:
            # Read-only view: merged unconditionally (integrity guaranteed).
            consumer_needs = _consumer_save_lifespan(graph, l)
            reqs.append((
                l.name,
                act_spec(l.name, consumer_needs, CreateMode.READONLY_VIEW,
                         view_of=_act_name(l.inputs[0])),
            ))
        else:
            consumer_needs = _consumer_save_lifespan(graph, l)
            reqs.append((l.name, act_spec(l.name, consumer_needs, CreateMode.CREATE)))

        # batchnorm is weighted *and* in-place-capable; model it as saving
        # its output (not input) for backward, like activations, but with a
        # CREATE'd output that allows the input to be freed by the planner
        # (the merge is only legal when the input has no later use).
        # ---- derivatives ---------------------------------------------------
        # D:<l> (derivative of l's output) is produced by the consumer's CD
        # and consumed by l's CG/CD — Backward lifespan.  Skipped entirely
        # when nothing upstream is trainable (dead-derivative pruning: the
        # backbone of a transfer-learning slice never materialises derivs).
        # When the unique consumer is an in-place activation, the incoming
        # derivative is overwritten elementwise (MV of the consumer's D);
        # flatten/reshape derivatives are pure reshapes (RV).
        consumed_by_loss = any(c.kind in LOSS_KINDS for c in graph.consumers(l.name))
        needs_out_deriv = (
            (l.kind in WEIGHTED_KINDS and l.trainable and bool(l.weight_shapes()))
            or _has_trainable_upstream(graph, l)
        )
        if not consumed_by_loss and graph.consumers(l.name) and needs_out_deriv:
            consumers = graph.consumers(l.name)
            dmode, dview = CreateMode.CREATE, None
            if len(consumers) == 1:
                c = consumers[0]
                if c.kind == "activation":
                    dmode, dview = CreateMode.MODIFY_VIEW, _deriv_name(c.name)
                elif c.kind in VIEW_KINDS:
                    dmode, dview = CreateMode.READONLY_VIEW, _deriv_name(c.name)
            reqs.append((
                l.name,
                TensorSpec(
                    name=_deriv_name(l.name),
                    shape=(batch,) + tuple(shapes[l.name]),
                    lifespan=Lifespan.BACKWARD,
                    create_mode=dmode,
                    view_of=dview,
                ),
            ))

        # ---- weights & gradients ------------------------------------------
        if l.kind in WEIGHTED_KINDS and l.weight_shapes():
            mode = CreateMode.EXTEND if l.shares_weights_with else CreateMode.CREATE
            target = l.shares_weights_with
            for wname, wshape in l.weight_shapes().items():
                reqs.append((
                    l.name,
                    TensorSpec(
                        name=f"W:{l.name}:{wname}",
                        shape=tuple(wshape),
                        lifespan=Lifespan.MAX,
                        create_mode=mode,
                        view_of=f"W:{target}:{wname}" if target else None,
                    ),
                ))
                if l.trainable:
                    # Gradient: Backward lifespan normally; Iteration lifespan
                    # when gradients accumulate across an unrolled recurrence
                    # (paper §5.2 Tacotron2: update once per iteration).
                    gls = (
                        Lifespan.ITERATION
                        if l.shares_weights_with or a.get("accumulate_grad")
                        else Lifespan.BACKWARD
                    )
                    gmode = CreateMode.EXTEND if l.shares_weights_with \
                else CreateMode.CREATE
                    reqs.append((
                        l.name,
                        TensorSpec(
                            name=f"G:{l.name}:{wname}",
                            shape=tuple(wshape),
                            lifespan=gls,
                            create_mode=gmode,
                            view_of=f"G:{target}:{wname}" if target else None,
                        ),
                    ))

        # ---- scratch: im2col for conv2d (paper §5.1 notes this overhead) --
        if l.kind == "conv2d" and a.get("im2col", False):
            c, h, w = shapes[l.inputs[0]]
            oh, ow = l.out_shape[1], l.out_shape[2]
            k = a["ksize"]
            reqs.append((
                l.name,
                TensorSpec(
                    name=f"S:{l.name}:im2col",
                    shape=(batch, oh * ow, c * k * k),
                    lifespan=Lifespan.FORWARD_GRAD,
                    create_mode=CreateMode.CREATE,
                ),
            ))
        # lstm gate scratch (saved for backward)
        if l.kind == "lstm":
            seq = a.get("seq_len", 1)
            reqs.append((
                l.name,
                TensorSpec(
                    name=f"S:{l.name}:gates",
                    shape=(batch, seq, 4 * a["hidden"]),
                    lifespan=Lifespan.FORWARD_GRAD,
                    create_mode=CreateMode.CREATE,
                ),
            ))
            reqs.append((
                l.name,
                TensorSpec(
                    name=f"S:{l.name}:cell",
                    shape=(batch, seq, a["hidden"]),
                    lifespan=Lifespan.FORWARD_GRAD,
                    create_mode=CreateMode.CREATE,
                ),
            ))
    return reqs


def _has_trainable_upstream(graph: LayerGraph, l: LayerNode) -> bool:
    """True if any (transitive) producer of ``l`` has trainable weights —
    i.e. the derivative of ``l``'s output must be propagated backward."""
    seen = set()
    stack = [i for i in l.inputs if i != "__input__"]
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        node = graph.layer(name)
        if node.kind in WEIGHTED_KINDS and node.trainable and node.weight_shapes():
            return True
        stack.extend(i for i in node.inputs if i != "__input__")
    return False


def _consumer_save_lifespan(graph: LayerGraph, l: LayerNode) -> Lifespan:
    """Lifespan of ``X:<l>`` based on what its consumers need.

    * consumed by a weighted layer          -> needed at that layer's CG
    * consumed by an in-place activation    -> F only (the MV merge takes over;
      the activation's derivative reads its *output*, never this input)
    * consumed by the loss                  -> needed through backward (the
      loss derivative is computed from it in place)
    * consumed by pool2d                    -> F + CD of the consumer
      (max-pool backward needs the argmax; modelled conservatively)
    """
    consumers = graph.consumers(l.name)
    if not consumers:
        return Lifespan.FORWARD
    needs_grad = any(c.kind in WEIGHTED_KINDS for c in consumers)
    is_loss = any(c.kind in LOSS_KINDS for c in consumers)
    needs_cd = any(c.kind in ("pool2d",) for c in consumers)
    if is_loss:
        return Lifespan.FORWARD_BACKWARD
    if needs_grad and needs_cd:
        return Lifespan.FORWARD_BACKWARD
    if needs_grad:
        return Lifespan.FORWARD_GRAD
    if needs_cd:
        return Lifespan.FORWARD_DERIV
    return Lifespan.FORWARD


# ---------------------------------------------------------------------------
# Realizers (Table 1) — graph → graph lowering passes
# ---------------------------------------------------------------------------

Realizer = Callable[[LayerGraph], LayerGraph]


def activation_realizer(graph: LayerGraph) -> LayerGraph:
    """Split ``activation=...`` attributes into standalone in-place layers."""
    out: List[LayerNode] = []
    rename: Dict[str, str] = {}
    for l in graph.layers:
        l.inputs = [rename.get(i, i) for i in l.inputs]
        act = l.attrs.pop("activation", None)
        out.append(l)
        if act:
            act_layer = LayerNode(
                name=f"{l.name}__act",
                kind="activation",
                inputs=[l.name],
                attrs={"fn": act},
            )
            out.append(act_layer)
            rename[l.name] = act_layer.name
    return LayerGraph(out, graph.input_shape, graph.label_shape, graph.name)


def flatten_realizer(graph: LayerGraph) -> LayerGraph:
    """Insert flatten before a linear layer following a spatial output."""
    out: List[LayerNode] = []
    rename: Dict[str, str] = {}
    shapes = infer_shapes(graph)
    for l in graph.layers:
        l.inputs = [rename.get(i, i) for i in l.inputs]
        if l.kind == "linear" and l.inputs:
            src = l.inputs[0]
            if len(shapes.get(src, ())) > 1:
                fl = LayerNode(name=f"{l.name}__flatten", kind="flatten", inputs=[src])
                out.append(fl)
                l.inputs = [fl.name] + l.inputs[1:]
        out.append(l)
    g = LayerGraph(out, graph.input_shape, graph.label_shape, graph.name)
    infer_shapes(g)
    return g


def loss_realizer(graph: LayerGraph) -> LayerGraph:
    """Cross-entropy: fold the preceding softmax activation into the loss
    (softmax+CE has a closed-form joint derivative — Table 1)."""
    out: List[LayerNode] = []
    removed: Dict[str, str] = {}
    layers = list(graph.layers)
    for idx, l in enumerate(layers):
        l.inputs = [removed.get(i, i) for i in l.inputs]
        if l.kind == "loss_ce":
            src = graph.layer(l.inputs[0]) if l.inputs[0] != "__input__" else None
            if src is not None and src.kind == "activation" \
                and src.attrs.get("fn") == "softmax":
                out.remove(src)
                removed[src.name] = src.inputs[0]
                l.inputs = [src.inputs[0]]
                l.attrs["from_logits"] = True
        out.append(l)
    return LayerGraph(out, graph.input_shape, graph.label_shape, graph.name)


def recurrent_realizer(graph: LayerGraph,
                       unroll: Optional[Dict[str, int]] = None) -> LayerGraph:
    """Unroll recurrent layers across time with E-shared weights (§5.2).

    ``unroll`` maps layer name -> number of time steps.  Each unrolled copy
    shares weights (CreateMode.EXTEND) and accumulates gradients with
    Iteration lifespan — the optimizer applies them once per iteration.
    """
    if not unroll:
        return graph
    out: List[LayerNode] = []
    rename: Dict[str, str] = {}
    for l in graph.layers:
        l.inputs = [rename.get(i, i) for i in l.inputs]
        steps = unroll.get(l.name, 0)
        if steps <= 1:
            out.append(l)
            continue
        prev = None
        first_name = f"{l.name}__t0"
        for t in range(steps):
            copy = LayerNode(
                name=f"{l.name}__t{t}",
                kind=l.kind,
                inputs=[prev] if prev else list(l.inputs),
                attrs=dict(l.attrs),
                trainable=l.trainable,
                shares_weights_with=None if t == 0 else first_name,
                needs_input_derivative=(t > 0) or l.needs_input_derivative,
            )
            out.append(copy)
            prev = copy.name
        rename[l.name] = prev
    g = LayerGraph(out, graph.input_shape, graph.label_shape, graph.name)
    infer_shapes(g)
    return g


def slice_realizer(graph: LayerGraph, freeze_until: Optional[str] = None) -> LayerGraph:
    """Transfer-learning slice: freeze the backbone up to ``freeze_until``.

    Frozen layers keep Forward-only activation lifespans (nothing saved for
    backward), drop gradient tensors, and the first trainable layer skips
    its input derivative — reproducing the paper's Fig. 12 transfer-learning
    memory savings.
    """
    if freeze_until is None:
        return graph
    frozen = True
    for l in graph.layers:
        if frozen:
            l.trainable = False
        if l.name == freeze_until:
            frozen = False
    # first trainable layer does not need dL/dX
    for l in graph.layers:
        if l.trainable and l.kind in WEIGHTED_KINDS:
            l.needs_input_derivative = False
            break
    return graph


def input_realizer(graph: LayerGraph) -> LayerGraph:
    """Ensure the first layer consumes ``__input__`` (Table 1 Input)."""
    if graph.layers and not graph.layers[0].inputs:
        graph.layers[0].inputs = ["__input__"]
    return graph


DEFAULT_REALIZERS: Sequence[Realizer] = (
    input_realizer,
    activation_realizer,
    flatten_realizer,
    loss_realizer,
)


def compile_graph(graph: LayerGraph,
                  realizers: Sequence[Realizer] = DEFAULT_REALIZERS,
                  unroll: Optional[Dict[str, int]] = None,
                  freeze_until: Optional[str] = None) -> LayerGraph:
    """The paper's *Compile* process: apply Realizers, validate ordering."""
    g = graph
    for r in realizers:
        g = r(g)
    g = recurrent_realizer(g, unroll)
    g = slice_realizer(g, freeze_until)
    infer_shapes(g)
    g.validate()
    return g
