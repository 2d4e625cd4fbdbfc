"""Device meshes: ``torch.distributed`` DeviceMeshes with named axes, the
counterpart of the reference's ``launch/mesh.py``.

Single pod: (16, 16) = 256 cards, axes (data, model).  Multi-pod: (2, 16,
16) = 512 cards, axes (pod, data, model); "pod" is one more data-parallel
axis.  Ranks fill a mesh in row-major order, as ``jax.make_mesh`` orders
its devices: rank r sits at ``numpy.unravel_index(r, shape)``.

The sharding rules (``launch/shardings.py``) take a ``MeshSpec``, the axes
and their sizes alone, so that a production mesh's rules are computed
without its processes; ``MeshSpec.of`` reads one off a DeviceMesh.

A DeviceMesh needs a process group first
(``torch.distributed.init_process_group`` with the address, world size and
rank given).  A CUDA mesh takes NCCL and nothing else; only an explicit
``device="cpu"`` takes gloo, which is what the tests run; a ``"meta"`` mesh
takes PyTorch's "fake" backend, which moves nothing, and serves a meta
model alone: the mesh dry run counts one rank of a production mesh in one
process (``fake_world``), each collective dispatched on meta tensors as on
a real group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# the backend each mesh device takes; nothing else is accepted
BACKENDS = {"cuda": "nccl", "cpu": "gloo", "meta": "fake"}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and sizes, without processes."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """{axis: size}, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @classmethod
    def of(cls, mesh: "MeshSpec | DeviceMesh") -> "MeshSpec":
        if isinstance(mesh, MeshSpec):
            return mesh
        # ``mesh.shape``, not ``mesh.mesh.shape``: the models read the spec
        # of the ambient mesh a few times a layer, and ``DeviceMesh.mesh``
        # builds the rank tensor anew at each call (tens of microseconds)
        return cls(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def production_spec(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_mesh(shape, axes, device="cuda") -> DeviceMesh:
    """A DeviceMesh of ``shape`` over every rank of the default process
    group, whose backend must be the device's (NCCL for CUDA, gloo for the
    CPU, fake for meta)."""
    from ..models.common import require_device   # models import this module
    device = require_device(device)
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group first")
    want = BACKENDS.get(device.type)
    if want is None or dist.get_backend() != want:
        raise RuntimeError(f"a {device.type} mesh takes the {want} backend; "
                           f"the process group runs {dist.get_backend()}")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"world has {dist.get_world_size()}")
    # a DeviceMesh's device type names a backend's device: the fake
    # backend's mesh is built as a CPU one (``mesh_device`` tells it)
    return init_device_mesh("cpu" if device.type == "meta" else device.type,
                            shape, mesh_dim_names=axes)


def mesh_device(mesh: DeviceMesh) -> str:
    """The device type of the models a mesh serves: "meta" on the fake
    backend (whose meshes are built as CPU ones), else the mesh's own."""
    if mesh.device_type != "cpu":
        return mesh.device_type
    group = mesh.get_group(mesh.mesh_dim_names[0])
    return "meta" if dist.get_backend(group) == "fake" else "cpu"


@contextlib.contextmanager
def fake_world(spec: MeshSpec, rank: int | None = None):
    """A world of ``spec.size`` ranks on the "fake" backend with this
    process at ``rank`` (default the last, every coordinate last), and the
    meta DeviceMesh of ``spec`` over it, destroyed on exit.  Refuses a
    process that has a default group already (an NCCL or gloo world): run
    it in a process of its own."""
    if dist.is_initialized():
        raise RuntimeError("a fake world needs a process without a default "
                           "process group; this one runs "
                           f"{dist.get_backend()}")
    # registers the "fake" backend with torch.distributed
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    rank = spec.size - 1 if rank is None else rank
    if not 0 <= rank < spec.size:
        raise ValueError(f"rank {rank} of a world of {spec.size}")
    dist.init_process_group("fake", rank=rank, world_size=spec.size,
                            store=dist.HashStore())
    try:
        yield make_mesh(spec.sizes, spec.axis_names, "meta")
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    spec = production_spec(multi_pod=multi_pod)
    return make_mesh(spec.sizes, spec.axis_names, device)


def make_local_mesh(device="cuda") -> DeviceMesh:
    """The 1 x 1 mesh of one rank (smoke runs, examples)."""
    return make_mesh((1, 1), ("data", "model"), device)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in MeshSpec.of(mesh).axis_names
                 if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


def coordinate(mesh: DeviceMesh) -> dict[str, int]:
    """This rank's position on each axis of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
