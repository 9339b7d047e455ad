"""Meshes of ranks with named axes.

PyTorch counterpart of ``mxnet_tpu/parallel/mesh.py``, with one
difference of design. The JAX package is one controller over many
devices: a ``jax.sharding.Mesh`` holds every device, and one program
addresses them all. The port is multi-controller: one process per device,
joined by ``torch.distributed`` (``kvstore.init_distributed``). A
:class:`Mesh` therefore spans the ranks of that world, arranged as a grid
whose axes carry the reference's names (``MESH_AXES``): each axis has the
process group of the ranks that share every other coordinate, and the
collectives of an axis run on that group. A process with no group is a
world of one.

A mesh is arithmetic until it is used: over a world of one it may name
any grid of ``devices`` (rank ids), which the tests use to hold its shape
against the reference's; its groups are made only in a world of several
ranks, by every rank of the world, in one order
(``torch.distributed.new_group`` is collective). That holds for a mesh
over part of the world too (live elasticity's topologies): a rank
outside it builds the mesh and joins each ``new_group`` call but holds no
part, and its ``group``, ``axis_ranks``, ``axis_index`` and
``shard_batch`` raise. (``new_group(..., use_local_synchronization=True)``
would let the members make their groups alone, but torch names such a
group by its ranks and the number of groups the calling process has
made, so members whose counts differ wait on different names.)
"""

from __future__ import annotations

import numpy as _np

from ..base import MXNetError

_CURRENT = [None]

#: The axis-name contract, in canonical order: data, pipeline, tensor,
#: sequence, expert. A mesh may carry any subset (missing = size 1).
MESH_AXES = ("dp", "pp", "tp", "sp", "ep")


def world():
    """``(rank, world size)`` of this process: ``(0, 1)`` with no group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class PartitionSpec(tuple):
    """How a tensor is laid out over a mesh: one entry per dimension, the
    name of the mesh axis that splits it or None (whole); missing trailing
    entries are None. The counterpart of ``jax.sharding.PartitionSpec``:
    a tuple of its entries, compared by them, so ``P("tp", None)`` means
    here what it means in the JAX package."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


class Mesh:
    """A grid of ranks with named axes (the reference's
    ``jax.sharding.Mesh``: ``axis_names``, ``shape`` as name -> size,
    ``devices`` the grid, here of rank ids)."""

    def __init__(self, devices, axis_names):
        self.devices = _np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self._groups = {}
        self._singletons = {}  # an axis of one rank: this rank's group
        self._device_meshes = {}
        rank, size = world()
        self._partial = False
        if size > 1:
            ranks = sorted(int(r) for r in self.devices.flat)
            if len(set(ranks)) != len(ranks) or ranks[0] < 0 \
                    or ranks[-1] >= size:
                raise MXNetError(
                    f"mesh {self.shape} over ranks {ranks} is not a set of "
                    f"ranks of the world of {size}")
            self._partial = len(ranks) != size
            self._make_groups()

    @property
    def size(self):
        return int(self.devices.size)

    def is_member(self):
        """Does this rank hold a part of the mesh (always, in a world of
        one or on a mesh over the whole world)."""
        return not self._partial or world()[0] in self.devices

    def _member(self, what):
        if not self.is_member():
            raise MXNetError(
                f"mesh {self.shape} over ranks "
                f"{sorted(int(r) for r in self.devices.flat)}: rank "
                f"{world()[0]} holds no part of it ({what})")

    def _make_groups(self):
        """Each axis's groups, made by every rank of the world in one
        order; a rank keeps the group it belongs to (None: the whole
        world; a rank outside a partial mesh keeps none)."""
        import torch.distributed as dist

        rank, size = world()
        for ax, name in enumerate(self.axis_names):
            n = self.devices.shape[ax]
            if n == size:
                self._groups[name] = None
                continue
            moved = _np.moveaxis(self.devices, ax, -1).reshape(-1, n)
            for ranks in moved:
                ranks = [int(r) for r in ranks]
                g = dist.new_group(ranks) if n > 1 else None
                if rank in ranks:
                    self._groups[name] = g

    def device_mesh(self, axes=None, device_type="cpu"):
        """A ``torch.distributed.device_mesh.DeviceMesh`` over ``axes``
        (default: every axis) of the ranks that share this rank's
        coordinates on the others, built from the axes' process groups
        (``DeviceMesh.from_group``) on ``device_type``; what DTensors of
        a tensor-parallel step are placed on. Every rank calls it, in
        one order: an axis of one rank makes its groups here."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        axes = tuple(self.axis_names if axes is None else axes)
        key = (axes, device_type)
        if key in self._device_meshes:
            return self._device_meshes[key]
        rank, _ = world()
        where = tuple(int(i) for i in _np.argwhere(self.devices == rank)[0])
        sub = self.devices[tuple(
            slice(None) if n in axes else where[ax]
            for ax, n in enumerate(self.axis_names))]
        order = [n for n in self.axis_names if n in axes]
        sub = _np.moveaxis(sub, [order.index(a) for a in axes],
                           list(range(len(axes))))
        groups = []
        for a in axes:
            if self.shape[a] > 1:
                g = self._groups.get(a)
                groups.append(g if g is not None else dist.group.WORLD)
                continue
            if a not in self._singletons:
                for r in range(self.size):  # collective: every rank
                    g = dist.new_group([r])
                    if r == rank:
                        self._singletons[a] = g
            groups.append(self._singletons[a])
        dm = DeviceMesh.from_group(
            groups if len(axes) > 1 else groups[0], device_type,
            mesh=torch.as_tensor(sub.astype(_np.int64)),
            mesh_dim_names=axes)
        self._device_meshes[key] = dm
        return dm

    def group(self, name):
        """The process group of this rank along axis ``name`` (None: the
        default group, when the axis spans the world)."""
        self._member(f"group {name!r}")
        return self._groups.get(name)

    def axis_ranks(self, name):
        """The ranks along axis ``name`` through this rank (the others'
        coordinates fixed), in axis order: ``[rank]`` for an absent
        axis."""
        self._member(f"axis_ranks {name!r}")
        if name not in self.shape:
            return [world()[0]]
        rank, _ = world()
        where = _np.argwhere(self.devices == rank)
        coord = list(where[0]) if len(where) else [0] * self.devices.ndim
        ax = self.axis_names.index(name)
        coord[ax] = slice(None)
        return [int(r) for r in self.devices[tuple(coord)]]

    def axis_index(self, name):
        """This rank's coordinate along axis ``name``."""
        self._member(f"axis_index {name!r}")
        if name not in self.shape:
            return 0
        rank, _ = world()
        where = _np.argwhere(self.devices == rank)
        return int(where[0][self.axis_names.index(name)]) if len(where) \
            else 0

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(axes=None, devices=None):
    """A :class:`Mesh` over ``devices`` (rank ids; default: every rank of
    the world). ``axes``: axis name -> size, e.g. ``{"dp": 4, "tp": 2}``;
    the sizes multiply to the number of ranks (-1 once infers one)."""
    if devices is None:
        devices = list(range(world()[1]))
    devices = list(devices)
    n = len(devices)
    if axes is None:
        axes = {"dp": n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        sizes[sizes.index(-1)] = n // known
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    mesh = Mesh(_np.array(devices).reshape(sizes), names)
    _CURRENT[0] = mesh
    return mesh


def composed_mesh(dp=1, pp=1, tp=1, sp=1, ep=1, devices=None):
    """The canonical mesh ``(dp, pp, tp, sp, ep)``, axes in ``MESH_AXES``
    order whatever the call's order, size-1 axes kept; ``dp=-1`` infers
    the data axis from the number of ranks."""
    sizes = {"dp": dp, "pp": pp, "tp": tp, "sp": sp, "ep": ep}
    for name, s in sizes.items():
        if name != "dp" and (not isinstance(s, int) or s < 1):
            raise ValueError(f"composed_mesh: axis {name}={s!r} must be "
                             "a positive int (-1 inference is dp-only)")
    return make_mesh({name: sizes[name] for name in MESH_AXES},
                     devices=devices)


def axis_size(mesh, name):
    """Size of ``name`` in ``mesh`` (1 when the axis is absent)."""
    return int(mesh.shape[name]) if name in mesh.shape else 1


def validate_mesh_axes(mesh, where="mesh"):
    """Reject axis names outside the ``MESH_AXES`` contract (the legacy
    ``batch``, ``model``, ``x``/``y``, ``devices`` stay accepted); returns
    the mesh."""
    legacy = {"batch", "model", "x", "y", "devices"}
    unknown = [a for a in mesh.axis_names
               if a not in MESH_AXES and a not in legacy]
    if unknown:
        raise ValueError(
            f"{where}: unknown mesh axes {unknown}; the 4D-parallel "
            f"contract is {MESH_AXES}")
    return mesh


def data_parallel_mesh():
    """A ``dp`` mesh over every rank of the world."""
    return make_mesh({"dp": world()[1]})


def current_mesh():
    """The mesh ``make_mesh`` made last (None before one)."""
    return _CURRENT[0]
