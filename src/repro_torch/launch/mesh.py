"""The device mesh over the ranks of a ``torch.distributed`` world.

Port of ``repro/launch/mesh.py``.  A :class:`Mesh` names its axes and
their sizes (``axis_names``, ``shape``: the two things the sharding rules
read, as they read a JAX mesh's) and, once built over a process group,
holds the ``torch.distributed`` ``DeviceMesh`` whose per-axis groups carry
the collectives (``repro_torch.sharding.collectives``).  The axes keep the
reference's meaning:

    pod    -- across pods: pure data parallelism (the batch splits over
              (pod, data), the parameters are replicated over it)
    data   -- data parallelism / FSDP / sequence parallelism
    model  -- tensor parallelism: heads, mlp columns, vocabulary

Ranks are laid out row-major over the axes, as ``init_device_mesh`` lays
them: on a (data, model) = (2, 2) mesh rank ``r`` sits at data ``r // 2``,
model ``r % 2``, so the model groups are {0, 1} and {2, 3}; on a (pod,
data, model) = (2, 1, 2) mesh the pod groups are {0, 2} and {1, 3}.
``torch.distributed`` does not ask whether two ranks share a host, so a
pod mesh over four cards of one host runs the code two hosts would run;
only the rendezvous differs.

Nothing here touches a device at import.  The card's constants are in
``launch/hw.py``; the reference's TPU constants are not carried over.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch


class Mesh:
    """Named axes over the ranks of the world.  ``device_mesh`` is None for
    an abstract mesh (shapes only, no devices: the rule functions and the
    placement tables need no more); :meth:`coords` is then all zeros."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device_mesh=None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} does not name its "
                             f"axes {tuple(axes)}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(s) for s in shape)))
        self.device_mesh = device_mesh

    def coords(self) -> Dict[str, int]:
        """This rank's index along every axis."""
        if self.device_mesh is None:
            return dict.fromkeys(self.axis_names, 0)
        return {a: self.device_mesh.get_local_rank(a)
                for a in self.axis_names}

    def wide(self, axes) -> Tuple[str, ...]:
        """The axes of ``axes`` (one name or a tuple) with more than one
        rank, in the mesh's order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def group(self, axis):
        """The process group of this rank's line along ``axis``: one axis,
        or a tuple of axes whose axes of more than one rank are one axis
        (that axis's group) or every such axis of the mesh (the world's).
        Any other tuple raises: :func:`collectives.all_reduce` runs one
        collective an axis there."""
        if self.device_mesh is None:
            raise RuntimeError("an abstract mesh has no process groups")
        if isinstance(axis, tuple):
            wide = self.wide(axis)
            if not wide:
                raise ValueError(f"{axis} of {self} has no axis of more "
                                 "than one rank: no collective is needed")
            if len(wide) == 1:
                return self.device_mesh.get_group(wide[0])
            if wide != self.wide(self.axis_names):
                raise ValueError(f"no process group over {axis} of {self}:"
                                 " a group of several axes spans the mesh")
            import torch.distributed as dist
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: Optional[str] = None) -> Mesh:
    """A mesh of ``shape`` over every rank of the initialised world, on the
    CUDA card unless ``device="cpu"`` (the world's size must equal the
    mesh's)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {tuple(shape)} needs {n} ranks, the "
                         f"world has {dist.get_world_size()}")
    dev = "cuda" if device is None else torch.device(device).type
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for a mesh of host ranks")
    dm = init_device_mesh(dev, tuple(shape), mesh_dim_names=tuple(axes))
    return Mesh(shape, axes, dm)


def make_test_mesh(n_devices: Optional[int] = None, *, model: int = 2,
                   device: Optional[str] = None) -> Mesh:
    """(data, model) over ``n_devices`` ranks (the world's by default):
    data = max(n // model, 1), as the reference's mesh over however many
    devices exist."""
    import torch.distributed as dist
    n = n_devices or dist.get_world_size()
    data = max(n // model, 1)
    return make_mesh((data, model), ("data", "model"), device=device)


def make_pod_mesh(n_devices: Optional[int] = None, *, model: int = 2,
                  device: Optional[str] = None) -> Mesh:
    """(pod, data, model) = (2, data, model) over ``n_devices`` ranks (the
    world's by default): the reference's multi-pod (2, 16, 16) shape at
    the world's size, data = n // (2 model).  Four ranks make (2, 1, 2),
    or (2, 2, 1) with ``model=1``."""
    import torch.distributed as dist
    n = n_devices or dist.get_world_size()
    if n % (2 * model):
        raise ValueError(f"a pod mesh (2, data, {model}) does not divide "
                         f"{n} ranks")
    return make_mesh((2, n // (2 * model), model), ("pod", "data", "model"),
                     device=device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 256-chip (16, 16) and 512-chip (2, 16, 16) meshes
    need as many cards (at most four share a host here): out of scope.
    :func:`make_pod_mesh` is the multi-pod shape at the world's size."""
    shape = "(2, 16, 16) pod x data x model" if multi_pod \
        else "(16, 16) data x model"
    raise NotImplementedError(
        f"the production mesh {shape} spans {512 if multi_pod else 256} "
        "chips; the port runs on one host of at most four cards: use "
        "make_mesh, make_test_mesh or make_pod_mesh")
