"""Meshes: the port of ``repro.launch.mesh``.

``make_production_mesh`` describes the reference's pod layouts (TPU v5e
pods, 256 chips each), axis names and sizes only:

  single-pod  (16, 16)        ("data", "model")
  multi-pod   (2, 16, 16)     ("pod", "data", "model")   2 pods = 512 chips

``make_smoke_mesh`` is the mesh of the devices this process computes on.
A process of the port computes on one device, so it is always the 1-wide
``("data",)`` mesh, the reference's fallback on one CPU device: a model
axis of ``n_model > 1`` does not divide one device.
"""

from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_smoke_mesh(n_model: int = 1, device=None) -> Mesh:
    """The reference's (n_devices / n_model, n_model) ("data", "model") mesh
    where ``n_model`` divides the process's devices, else (n_devices,)
    ("data",): one device, so always the latter, on ``device`` (``cuda``
    unless the caller names another)."""
    return Mesh((1,), ("data",), resolve_device(device))
