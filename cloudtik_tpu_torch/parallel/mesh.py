"""Device mesh with named parallelism axes, over `torch.distributed`.

Counterpart of `cloudtik_tpu/parallel/mesh.py`.  The axis vocabulary and
`MeshConfig` are the reference's (copied: the port imports nothing of the
JAX package).  A mesh is a `torch.distributed.device_mesh.DeviceMesh` over
the ranks of the default process group, one rank per card, laid out in
`MESH_AXES` order, outermost first (row-major over the global ranks):

    data    — pure data parallelism (gradient all-reduce)
    fsdp    — data parallelism with parameter/optimizer sharding (ZeRO-3)
    seq     — sequence parallelism (ring attention over this axis)
    tensor  — tensor parallelism within a layer (not ported yet)
    expert  — expert parallelism for MoE
    pipe    — pipeline stages (not ported yet)

With `num_slices > 1` the ranks are slice-major (slice k holds a
contiguous run of ranks), so the outermost `data` axis is the one that
crosses slices.  The helpers that only read axis sizes also take a plain
`{axis: size}` dict (an abstract mesh), as `MeshConfig.axis_sizes`
returns it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

# Canonical axis order, outermost (DCN-friendly) to innermost.
MESH_AXES: Tuple[str, ...] = ("data", "fsdp", "pipe", "expert", "seq",
                              "tensor")

# Axes over which data batches are split (batch sharding).
DATA_AXES: Tuple[str, ...] = ("data", "fsdp")

# Axes that split a batch's tokens: the batch axes and `seq`.  A rank's
# loss is its share of the global one over these, and the trainer sums
# gradients over them.
TOKEN_AXES: Tuple[str, ...] = DATA_AXES + ("seq",)

# The axes the port runs; tensor and pipe come with the next slice.
PORTED_AXES: Tuple[str, ...] = ("data", "fsdp", "expert", "seq")
NEXT_SLICE = "slice 12 of the port (ROADMAP A7)"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each named axis; -1 means "fill with remaining devices"."""

    data: int = 1
    fsdp: int = -1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1
    # Multi-slice: number of slices connected over DCN; the `data` axis is
    # laid out across slices when > 1.
    num_slices: int = 1

    def axis_sizes(self, num_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in MESH_AXES}
        fills = [a for a, s in sizes.items() if s == -1]
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if num_devices % fixed != 0:
            raise ValueError(
                f"{num_devices} devices not divisible by fixed axis product "
                f"{fixed} ({sizes})")
        remaining = num_devices // fixed
        if not fills:
            if fixed != num_devices:
                raise ValueError(
                    f"Mesh axes {sizes} use {fixed} devices but "
                    f"{num_devices} are available; set one axis to -1 to fill")
            return sizes
        if len(fills) > 1:
            raise ValueError(f"Only one axis may be -1, got {fills}")
        sizes[fills[0]] = remaining
        return sizes

    @staticmethod
    def fsdp_only() -> "MeshConfig":
        return MeshConfig()

    @staticmethod
    def dp(n: int = -1) -> "MeshConfig":
        return MeshConfig(data=n, fsdp=1)


AnyMesh = Union["DeviceMesh", Mapping[str, int]]  # noqa: F821


def axis_sizes_of(mesh: AnyMesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh or of an abstract {axis: size} mesh."""
    if isinstance(mesh, Mapping):
        return {a: int(s) for a, s in mesh.items()}
    return {a: int(s) for a, s in zip(mesh.mesh_dim_names, mesh.shape)}


def check_ported(sizes: Mapping[str, int]) -> None:
    """tensor > 1 and pipe > 1 are refused, naming the slice that ports
    them."""
    wide = {a: s for a, s in sizes.items()
            if s > 1 and a not in PORTED_AXES}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: the tensor and pipe axes come with "
            f"{NEXT_SLICE}")


def _per_slice_shape(shape: Tuple[int, ...],
                     num_slices: int) -> Tuple[int, ...]:
    # `data` is the outermost axis (index 0): divide it across slices.
    if shape[0] % num_slices != 0:
        raise ValueError(
            f"data axis size {shape[0]} not divisible by num_slices "
            f"{num_slices}")
    return (shape[0] // num_slices,) + shape[1:]


def build_mesh(config: Optional[MeshConfig] = None,
               device_type: Optional[str] = None):
    """A DeviceMesh with the canonical named axes over every rank of the
    default process group (which must be initialised: see
    `distributed.auto_initialize`).  `device_type` defaults to "cuda" when
    the group's backend is NCCL, else "cpu".  Every rank must call it, in
    the same order as any other group creation."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "build_mesh needs an initialised torch.distributed process "
            "group (parallel.distributed.auto_initialize, or torchrun)")
    config = config or MeshConfig()
    world = dist.get_world_size()
    sizes = config.axis_sizes(world)
    check_ported(sizes)
    shape = tuple(sizes[a] for a in MESH_AXES)
    if config.num_slices > 1:
        # ranks are slice-major, so an outer data axis that divides by
        # the slice count is the only one crossing slices
        _per_slice_shape(shape, config.num_slices)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


def slice_device_groups(ranks: Optional[Sequence[int]] = None,
                        num_slices: int = 1) -> Dict[int, List[int]]:
    """Partition ranks into per-slice groups: contiguous runs of equal
    size, slice-major (the reference's simulated-slice layout, over ranks
    instead of devices).  Group ids are dense ints from 0."""
    if ranks is None:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        ranks = range(world)
    ranks = list(ranks)
    if num_slices < 1 or len(ranks) % num_slices != 0:
        raise ValueError(
            f"{len(ranks)} devices not divisible into "
            f"{num_slices} simulated slices")
    per = len(ranks) // num_slices
    return {i: ranks[i * per:(i + 1) * per] for i in range(num_slices)}


def elastic_mesh_config(per_slice: MeshConfig, num_slices: int) -> MeshConfig:
    """The K-slice mesh config derived from ONE slice's layout: the data
    axis times the number of live slices (the reference's rule; the
    elastic re-mesh itself comes with slice 13)."""
    if per_slice.data == -1:
        raise ValueError(
            "elastic meshes need an explicit per-slice data axis "
            "(data=-1 would change the intra-slice layout as K varies)")
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    return dataclasses.replace(
        per_slice, data=per_slice.data * num_slices,
        num_slices=num_slices)


def mesh_summary(mesh: AnyMesh) -> Dict[str, int]:
    return {a: s for a, s in axis_sizes_of(mesh).items() if s > 1}


def data_axis_size(mesh: AnyMesh) -> int:
    sizes = axis_sizes_of(mesh)
    return math.prod(sizes[a] for a in DATA_AXES if a in sizes)


def local_batch_slice(mesh: AnyMesh, global_batch: int) -> int:
    """Per-data-shard batch size."""
    n = data_axis_size(mesh)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel size {n}")
    return global_batch // n
