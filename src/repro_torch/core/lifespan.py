"""Tensor lifespan and create-mode taxonomy (NNTrainer §4.1, Tables 2 & 3).

The paper's central abstraction: every tensor a layer requests is annotated
with a *lifespan* (during which training sub-processes it must stay valid)
and a *create mode* (how its storage relates to other tensors).  Execution
orders (EOs) are derived from these annotations (Algorithm 1) and the memory
planner (Algorithm 2) assigns arena offsets so that tensors with disjoint
EO intervals share storage.

Training is decomposed into three phases per layer (the paper's
layer-operation basis):

    F   forward
    CG  compute gradient  (dW from dY and saved X)
    CD  compute derivative (dX from dY and W)  -- includes apply-gradient

Lifespans map to subsets of those phases; create modes describe sharing:

    P   place-holder: storage owned externally (model inputs, labels)
    C   create: fresh allocation from the arena
    MV  modify-view: shares memory with a target tensor, data changes
        (in-place ops: activations, batch-norm)
    RV  read-only view: shares memory, data guaranteed unchanged
        (flatten / reshape)
    E   extend: shares *both* spec and data (time-unrolled weights)
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple


class Lifespan(enum.Enum):
    """When a tensor must be resident (Table 2)."""

    FORWARD = "F"                 # forward only
    CALC_GRAD = "CG"              # compute-gradient only
    CALC_DERIV = "CD"             # compute-derivative only
    FORWARD_GRAD = "F_CG"         # forward + compute-gradient (saved activations)
    FORWARD_DERIV = "F_CD"        # forward + compute-derivative
    BACKWARD = "B"                # compute-gradient + compute-derivative
    FORWARD_BACKWARD = "F_B"      # everything within the layer
    ITERATION = "I"               # valid for a whole iteration, reset after
    MAX = "M"                     # always valid (weights)

    @property
    def spans_forward(self) -> bool:
        return self in (
            Lifespan.FORWARD,
            Lifespan.FORWARD_GRAD,
            Lifespan.FORWARD_DERIV,
            Lifespan.FORWARD_BACKWARD,
            Lifespan.ITERATION,
            Lifespan.MAX,
        )

    @property
    def spans_calc_grad(self) -> bool:
        return self in (
            Lifespan.CALC_GRAD,
            Lifespan.FORWARD_GRAD,
            Lifespan.BACKWARD,
            Lifespan.FORWARD_BACKWARD,
            Lifespan.ITERATION,
            Lifespan.MAX,
        )

    @property
    def spans_calc_deriv(self) -> bool:
        return self in (
            Lifespan.CALC_DERIV,
            Lifespan.FORWARD_DERIV,
            Lifespan.BACKWARD,
            Lifespan.FORWARD_BACKWARD,
            Lifespan.ITERATION,
            Lifespan.MAX,
        )


class CreateMode(enum.Enum):
    """How a tensor's storage is created / shared (Table 3)."""

    PLACEHOLDER = "P"    # external memory, not planned by the arena
    CREATE = "C"         # new allocation
    MODIFY_VIEW = "MV"   # memory sharing, data changes
    READONLY_VIEW = "RV" # memory sharing, data does not change
    EXTEND = "E"         # tensor sharing: spec AND data shared


_DTYPE_BYTES = {
    "float32": 4,
    "bfloat16": 2,
    "float16": 2,
    "float64": 8,
    "int32": 4,
    "int64": 8,
    "int8": 1,
    "uint8": 1,
    "bool": 1,
}


def dtype_bytes(dtype: str) -> int:
    try:
        return _DTYPE_BYTES[str(dtype)]
    except KeyError as exc:
        raise ValueError(f"unknown dtype {dtype!r}") from exc


@dataclasses.dataclass
class TensorSpec:
    """Specification of a requested tensor, separate from its data.

    Mirrors NNTrainer's Tensor-Pool entries: the spec (shape/dtype/lifespan/
    create-mode) exists from *Initialize* onwards, while actual storage is
    assigned only once the Memory Planner has computed offsets.
    """

    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"
    lifespan: Lifespan = Lifespan.FORWARD
    create_mode: CreateMode = CreateMode.CREATE
    # For MV/RV/E tensors: the name of the target tensor whose storage we
    # try to share.  The merge rules of Algorithm 1 decide whether sharing
    # is legal given both tensors' execution orders.
    view_of: Optional[str] = None
    # Execution orders assigned by Algorithm 1 (sorted ascending).
    exec_orders: Tuple[int, ...] = ()
    # Arena placement assigned by Algorithm 2 (byte offset), or None if the
    # tensor was merged into another / is a placeholder.
    offset: Optional[int] = None
    # If merged, the name of the tensor that owns the storage.
    merged_into: Optional[str] = None

    @property
    def nelems(self) -> int:
        return int(math.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.nelems * dtype_bytes(self.dtype)

    @property
    def is_planned(self) -> bool:
        """True if this tensor receives its own arena storage."""
        return (
            self.create_mode in (CreateMode.CREATE,)
            and self.merged_into is None
        )

    def add_orders(self, orders) -> None:
        self.exec_orders = tuple(sorted(set(self.exec_orders) | set(orders)))

    @property
    def min_eo(self) -> int:
        if not self.exec_orders:
            raise ValueError(f"tensor {self.name} has no execution orders")
        return self.exec_orders[0]

    @property
    def max_eo(self) -> int:
        if not self.exec_orders:
            raise ValueError(f"tensor {self.name} has no execution orders")
        return self.exec_orders[-1]

    def largest_gap(self) -> Tuple[int, int]:
        """(last-access-before, first-access-after) of the widest idle window.

        The widest gap between *consecutive* accesses is the only interval in
        which the tensor can safely vacate its storage: min/max EO alone
        overstate idleness whenever intermediate accesses exist (e.g. a saved
        activation read by its consumer's forward right after being written).
        Returns ``(min_eo, min_eo)`` for tensors with a single access.
        """
        if not self.exec_orders:
            raise ValueError(f"tensor {self.name} has no execution orders")
        best = (self.exec_orders[0], self.exec_orders[0])
        for a, b in zip(self.exec_orders, self.exec_orders[1:]):
            if b - a > best[1] - best[0]:
                best = (a, b)
        return best


def kib(nbytes: int) -> float:
    return nbytes / 1024.0


def mib(nbytes: int) -> float:
    return nbytes / (1024.0 * 1024.0)
