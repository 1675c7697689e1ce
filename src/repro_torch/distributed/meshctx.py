"""The current mesh of the process, and the logical-to-mesh axis rules: a
copy of the JAX package's ``distributed/meshctx.py``.

Model code finds the mesh the launcher entered with ``get_current_mesh``
(``models/moe.py:moe_apply_ep`` does). The current mesh is the process's,
not the thread's as in the reference: autograd runs the backward of CUDA
tensors on a device thread of its own, and an activation checkpoint
(``remat_blocks``) recomputes the forward there, where a thread-local
mesh would be gone and the recomputed graph another. A placement is the counterpart of
a ``PartitionSpec``: for each dimension, a tuple of mesh axis names, or
None where the dimension is held whole. Logical -> mesh axes:
  batch   -> every data-like mesh axis present ('pod', 'data')
  seq     -> 'data'
  heads/kv_heads/mlp/vocab/experts/rank/sp -> 'model'
  anything else -> whole
The reference's ``constrain`` (``with_sharding_constraint``) has no
counterpart: a rank holds its local tensors and every collective is
explicit, so there is no partitioner to constrain.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

_STATE = {"mesh": None}

MODEL_AXES = ("heads", "kv_heads", "mlp", "vocab", "experts", "rank", "sp")
DATA_AXES = ("pod", "data")

Placement = Tuple[Optional[Tuple[str, ...]], ...]


def set_current_mesh(mesh) -> None:
    _STATE["mesh"] = mesh


def get_current_mesh():
    return _STATE["mesh"]


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` (or None) the process's current mesh for the block."""
    prev = get_current_mesh()
    set_current_mesh(mesh)
    try:
        yield mesh
    finally:
        set_current_mesh(prev)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def logical_to_spec(mesh, axes: Sequence[Optional[str]]) -> Placement:
    """The placement of logical ``axes`` on ``mesh``, conflict-free: a
    mesh axis is used at most once, and a later logical axis that would
    reuse one is held whole (so a factorized (out, rank) leaf comes out
    split on one dimension only, as in the reference)."""
    used = set()
    out = []
    for name in axes:
        phys: Optional[Tuple[str, ...]] = None
        if name == "batch":
            d = tuple(a for a in data_axes(mesh) if a not in used)
            if d:
                phys = d
                used.update(d)
        elif name == "seq":
            if "data" not in used and "data" in mesh.axis_names:
                phys = ("data",)
                used.add("data")
        elif name in MODEL_AXES:
            if "model" not in used and "model" in mesh.axis_names:
                phys = ("model",)
                used.add("model")
        out.append(phys)
    return tuple(out)
