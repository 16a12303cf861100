"""Logical-axis sharding rules: model code names axes, rules map them to
mesh axes.

Counterpart of `cloudtik_tpu/parallel/sharding.py`.  The rule table and
`logical_to_spec` are the reference's: a spec is a tuple with one entry
per array dimension (a mesh axis name, a tuple of names, or None), the
same entries as JAX's `PartitionSpec`, with absent and size-1 mesh axes
dropped and no mesh axis used twice.  `logical_to_placements` turns a spec
into DTensor placements (`Shard(dim)` / `Replicate()` per mesh dimension).

GSPMD derives the collectives from the placements; torch does not.  The
port's trainer places each parameter by `tree_to_shardings_safe` and
issues the gathers, reductions and the ring explicitly
(parallel/collectives.py, train/trainer.py); `with_sharding_constraint` is
a no-op here that only checks its logical names.  `use_mesh` sets the
ambient mesh that `mesh_axis_size` and the model code read (JAX:
`jax.sharding.set_mesh`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

from cloudtik_tpu_torch.parallel.mesh import axis_sizes_of

AxisRules = Tuple[Tuple[str, Union[None, str, Tuple[str, ...]]], ...]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Default rules: FSDP shards params on embed/vocab rows, tensor parallelism
# splits heads/mlp columns, sequence parallelism shards activations on seq,
# expert parallelism shards the expert dimension.
DEFAULT_RULES: AxisRules = (
    ("batch", ("data", "fsdp")),
    ("seq", "seq"),
    ("embed", "fsdp"),          # param row sharding (ZeRO-3 style)
    ("mlp", "tensor"),
    ("heads", "tensor"),
    ("kv", None),
    ("vocab", "tensor"),
    ("expert", "expert"),
    ("layers", "pipe"),         # layer stack staged over pipeline axis
    #                             (replicated when the mesh has no pipe)
    ("norm", None),
    ("conv_in", "fsdp"),        # conv kernels: rows FSDP, cols TP
    ("conv_out", "tensor"),
)


# What the transformer's (and LoRA's) code reads as this rank's slice, by
# mesh axis: Megatron's heads, d_ff columns and vocab rows over `tensor`,
# the experts over `expert`, the layer stack over `pipe`.  A spec names
# the table its model reads (`ModelSpec.reads_split`); a parameter
# dimension split any other way (over fsdp, `tensor` on `embed`, or any
# split of a model that reads none) is whole where the model reads it.
MEGATRON_READS = {"tensor": ("heads", "mlp", "vocab"),
                  "expert": ("expert",), "pipe": ("layers",)}


def reads_split(entry, logical: Optional[str], reads) -> bool:
    """Whether a model that reads the splits in `reads` ({mesh axis:
    logical names}) reads a dimension placed by spec `entry` with logical
    name `logical` as this rank's slice."""
    axes = spec_axes(entry)
    return len(axes) == 1 and logical in reads.get(axes[0], ())


def megatron_split(specs: Any, logical_tree: Any, reads) -> bool:
    """Whether every `tensor` split in a tree of specs is one a model that
    reads `reads` takes as this rank's slice.  Rules that give `tensor` to
    another dimension (embed=("fsdp", "tensor")) leave heads, d_ff and
    vocab whole in some leaves and split in others (no mesh axis is used
    twice in one leaf), so then no tensor split is read split: each is
    gathered before use, as GSPMD gathers it."""
    entries: list = []
    _map_axes(lambda names, spec: entries.extend(
        (e, names[d]) for d, e in enumerate(spec)
        if "tensor" in spec_axes(e)), logical_tree, specs)
    return all(reads_split(e, name, reads) for e, name in entries)


def make_rules(**overrides) -> AxisRules:
    """DEFAULT_RULES with per-logical-axis overrides, e.g.
    make_rules(embed=("fsdp", "tensor"))."""
    rules = dict(DEFAULT_RULES)
    for k, v in overrides.items():
        rules[k] = v
    return tuple(rules.items())


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: AxisRules = DEFAULT_RULES,
                    mesh=None) -> Spec:
    """Translate a tuple of logical axis names into a spec tuple.

    Mesh axes that don't exist in `mesh` (or have size 1) are dropped so
    the same model code runs on any mesh shape; `mesh` None keeps every
    mapped axis."""
    table = dict(rules)
    present = None
    if mesh is not None:
        present = {a for a, s in axis_sizes_of(mesh).items() if s > 1}
    spec: List[Union[None, str, Tuple[str, ...]]] = []
    used: set = set()

    def _filter(axes):
        if axes is None:
            return None
        if isinstance(axes, str):
            axes = (axes,)
        kept = tuple(a for a in axes
                     if (present is None or a in present) and a not in used)
        used.update(kept)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept

    for name in logical_axes:
        if name is None:
            spec.append(None)
            continue
        if name not in table:
            raise ValueError(f"Unknown logical axis {name!r}")
        spec.append(_filter(table[name]))
    return tuple(spec)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_placements(spec: Spec, mesh) -> list:
    """DTensor placements for a spec over `mesh`: per mesh dimension,
    `Shard(d)` for the array dimension d that names it, else
    `Replicate()`.  A dimension split over several mesh axes shards the
    outer axis first, as a PartitionSpec tuple does."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes_of(mesh))
    placements = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for a in spec_axes(entry):
            placements[names.index(a)] = Shard(dim)
    return placements


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def _map_axes(fn, tree, *rest):
    """fn over the logical-axes tuples of a tree of dicts and lists (a
    tuple of names is a leaf, not a container)."""
    if _is_axes(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_axes(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a logical-axes tree node: {tree!r}")


def tree_to_shardings(mesh, logical_tree: Any,
                      rules: AxisRules = DEFAULT_RULES) -> Any:
    """A tree of logical-axes tuples -> the same tree of specs."""
    return _map_axes(lambda axes: logical_to_spec(axes, rules, mesh),
                     logical_tree)


def tree_to_shardings_safe(mesh, logical_tree: Any, shape_tree: Any,
                           rules: AxisRules = DEFAULT_RULES) -> Any:
    """Like tree_to_shardings, but drops any mesh axis whose size does not
    divide the corresponding array dimension (e.g. a 3-channel conv stem
    under fsdp=2 stays replicated on that dim instead of erroring).
    `shape_tree` leaves are tensors or anything with `.shape`."""
    sizes = axis_sizes_of(mesh)

    def one(axes, leaf):
        shape = tuple(leaf.shape)
        spec = logical_to_spec(axes, rules, mesh)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        safe = []
        for dim, entry in zip(shape, entries):
            if entry is None:
                safe.append(None)
                continue
            total = math.prod(sizes[n] for n in spec_axes(entry))
            safe.append(entry if total and dim % total == 0 else None)
        return tuple(safe)

    return _map_axes(one, logical_tree, shape_tree)


def batch_sharding(mesh, rules: AxisRules = DEFAULT_RULES) -> Spec:
    """Spec for a [batch, ...] host array (inputs/labels)."""
    return logical_to_spec(("batch",), rules, mesh)


def batch_mesh_axes(mesh, rules: AxisRules = DEFAULT_RULES
                    ) -> Tuple[str, ...]:
    """The mesh axes the logical ``batch`` axis maps onto, filtered to
    those present in ``mesh`` with size > 1."""
    axes = dict(rules).get("batch")
    sizes = axis_sizes_of(mesh)
    return tuple(a for a in spec_axes(axes) if sizes.get(a, 1) > 1)


def replicated(mesh) -> Spec:
    return ()


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------

# A process-wide slot, not a context variable: the autograd engine runs a
# CUDA backward (and the recomputation of a checkpointed layer) on its own
# threads, which must see the mesh the forward saw.
_AMBIENT: list = [None]


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` (a DeviceMesh) the ambient mesh inside the block."""
    prev = _AMBIENT[0]
    _AMBIENT[0] = mesh
    try:
        yield mesh
    finally:
        _AMBIENT[0] = prev


def current_mesh():
    """The ambient DeviceMesh, or None."""
    return _AMBIENT[0]


def mesh_axis_size(axis: str) -> int:
    """Size of a named axis on the ambient mesh (1 = absent or no mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return axis_sizes_of(mesh).get(axis, 1)


def mesh_is_sharded() -> bool:
    """True when the ambient mesh has any nontrivial axis."""
    mesh = current_mesh()
    return mesh is not None and any(
        s > 1 for s in axis_sizes_of(mesh).values())


def logical_axis_size(name: str, rules: AxisRules = DEFAULT_RULES) -> int:
    """Product of the ambient-mesh sizes a logical axis maps onto (1
    without a mesh)."""
    axes = dict(rules).get(name)
    return math.prod(mesh_axis_size(a) for a in spec_axes(axes))


def axis_rank(axis: str) -> int:
    """This rank's coordinate along `axis` of the ambient mesh (0 without
    one)."""
    mesh = current_mesh()
    if mesh is None or mesh_axis_size(axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(axis: str):
    """The process group along `axis` of the ambient mesh, or None when the
    axis is absent or of size 1."""
    mesh = current_mesh()
    if mesh is None or mesh_axis_size(axis) == 1:
        return None
    return mesh.get_group(axis)


def with_sharding_constraint(x: Any, *logical_axes: Optional[str],
                             rules: AxisRules = DEFAULT_RULES) -> Any:
    """The reference's placement hint.  Without a mesh it is a no-op, as
    there; with one it checks the logical names and returns x unchanged:
    a rank holds its local block already, and the port issues its
    collectives explicitly."""
    if current_mesh() is not None:
        logical_to_spec(logical_axes, rules, current_mesh())
    return x

