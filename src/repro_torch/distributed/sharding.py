"""Sharding rules on one card: the port of ``repro.distributed.sharding``.

A mesh here is a *description*, axis names and sizes with no devices
(:class:`Mesh`): the three meshes of ``launch/mesh.py``

  smoke       (1,)            ("data",)                     one card
  single-pod  (16, 16)        ("data", "model")             256 chips
  multi-pod   (2, 16, 16)     ("pod", "data", "model")      512 chips

map logical roles to axes as the reference's do (batch -> ("pod", "data"),
model dims -> "model", long KV sequences -> "data"). One process computes
on one device, so nothing is partitioned: :func:`with_sharding` only
scrubs its spec against the mesh and returns the tensor, and the pod
meshes serve the dry run's per-device accounting (a leaf's shard shape
under its spec, ``models/steps.py``).

A partition spec is a plain tuple of entries, each ``None``, an axis name
or a tuple of axis names. The mesh is carried in a module-level context so
model code never takes a mesh parameter; launchers and tests call
``set_mesh`` / ``use_mesh``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

Spec = Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; ``device`` is where this process computes (a
    one-device mesh), None for a pod layout no process can hold."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: Optional[torch.device] = None

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} and names {self.axis_names} "
                             f"differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def current_mesh() -> Mesh:
    if _MESH is None:
        raise RuntimeError("no mesh set — call distributed.set_mesh(...) or use_mesh(...)")
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def axis_names() -> Tuple[str, ...]:
    return tuple(current_mesh().axis_names)


def batch_axes() -> Tuple[str, ...]:
    """Axes the batch dimension shards over (pod+data when present)."""
    return tuple(a for a in ("pod", "data") if a in axis_names())


def model_axis() -> Optional[str]:
    return "model" if "model" in axis_names() else None


def seq_axis() -> Optional[str]:
    """Axis used for sequence sharding of long KV caches (SP)."""
    return "data" if "data" in axis_names() else None


def data_parallel_size() -> int:
    m = current_mesh()
    n = 1
    for a in batch_axes():
        n *= m.shape[a]
    return n


def model_parallel_size() -> int:
    m = current_mesh()
    a = model_axis()
    return m.shape[a] if a else 1


def batch_spec(*trailing) -> Spec:
    """((pod, data), *trailing): the activation batch sharding."""
    ax = batch_axes()
    lead = ax if len(ax) > 1 else (ax[0] if ax else None)
    return (lead,) + tuple(trailing)


def scrub(spec: Spec) -> Spec:
    """``spec`` with every axis the current mesh lacks dropped."""
    names = set(axis_names())

    def entry(e):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a in names)
            return kept if kept else None
        return e if e in names else None
    return tuple(entry(e) for e in spec)


def with_sharding(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The reference's sharding constraint: the spec is scrubbed against
    the current mesh (axes it lacks dropped), and ``x`` comes back as it
    is, since one device has nothing to constrain."""
    scrub(spec)
    return x


def shard(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """``x`` placed on the process's device (the reference's device_put
    with a NamedSharding): a one-device mesh holds every shard."""
    mesh = current_mesh()
    scrub(spec)
    if mesh.device is None or mesh.size != 1:
        raise ValueError(f"mesh {mesh.axis_names} {mesh.axis_sizes} is a layout "
                         f"description: one process places no shards of it")
    return x.to(mesh.device)
