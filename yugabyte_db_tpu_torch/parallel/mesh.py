"""The device mesh of the mesh scans: a (t, b) grid of torch devices.

The port's counterpart of the JAX package's ``parallel/meshcompat.py``
and of the ``jax.sharding.Mesh`` its programs run over. The port's mesh
program is single-controller, as the JAX one is: one process drives
every device of the grid, with no ``torch.distributed``. Tablets split
over the "t" axis and each tablet's blocks over "b"
(``parallel.sharded``).

A grid may name one device more than once. That is the counterpart of
the JAX tests' virtual CPU devices (``tests/conftest.py``: 8 host
devices for a 4x2 mesh): the port's CPU tests and the smoke run the 4x2
shape on one device (``DeviceMesh.logical``), and the pieces a device
holds are one flattened run whatever the number of grid cells that name
it.
"""

from __future__ import annotations

import torch

AXES = ("t", "b")


class DeviceMesh:
    """A (t, b) grid of ``torch.device``s (``devices[i][j]``), named by
    ``AXES``; ``shape`` maps each axis to its size, as a JAX mesh's
    does."""

    def __init__(self, devices, axis_names=AXES):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid")
        if tuple(axis_names) != AXES:
            raise ValueError(f"the mesh's axes are {AXES}, not "
                             f"{tuple(axis_names)}")
        self.devices = rows
        self.axis_names = AXES
        self.shape = {"t": len(rows), "b": len(rows[0])}

    @classmethod
    def logical(cls, device, t: int, b: int) -> "DeviceMesh":
        """A t x b grid that names ``device`` in every cell."""
        return cls([[device] * b for _ in range(t)])

    def distinct(self) -> list:
        """The grid's devices, each once, in (t, b) order of first use."""
        out = []
        for row in self.devices:
            for d in row:
                if d not in out:
                    out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape['t']}x{self.shape['b']}, "
                f"{[str(d) for d in self.distinct()]})")


def mesh_from_visible(device_type: str = "cuda") -> DeviceMesh:
    """The JAX service's mesh policy (``tserver/mesh_scan.py``
    ``_get_mesh``) over the visible devices of ``device_type``: "b" gets 2
    when the count is even, "t" the rest. One card (or the CPU) makes a
    1x1 mesh that runs the same program."""
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is visible for the mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [torch.device(device_type)]
    n = len(devices)
    mesh_b = 2 if n % 2 == 0 else 1
    mesh_t = n // mesh_b
    return DeviceMesh([devices[i * mesh_b:(i + 1) * mesh_b]
                       for i in range(mesh_t)])


def device_label(device) -> str:
    """The residency cache's budget bucket of ``device`` ("cuda:0")."""
    from yugabyte_db_tpu_torch.storage.gpu_engine import \
        device_label as label

    return label(torch.device(device))
