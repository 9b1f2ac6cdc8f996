"""Process-wide model-execution state: the ambient model axis.

The counterpart of ``repro.models.runtime_flags``'s mesh. Under a mesh the
reference's model code reads it for its ``shard_map`` blocks; here the
layers read it for their collectives (``layers.reduce_model_axis``, the
vocabulary-sharded ``embed`` and ``unembed``). ``launch.steps.sharded_step``
sets it around each step it runs and clears it after. With no mesh it is
``None``, and every one-card path runs the code it runs without one.

The reference's ``scan_unroll`` has no counterpart: eager PyTorch runs each
layer, so nothing is undercounted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ModelAxis:
    """The model axis of this rank's mesh: its process group, this rank's
    coordinate on it, its size, and whether the vocabulary is sharded over
    it (the embedding's rows and the head's columns)."""
    group: Any
    rank: int
    size: int
    shard_vocab: bool

    @classmethod
    def of(cls, mesh, vocab_size: int) -> Optional["ModelAxis"]:
        """The model axis of a live ``DeviceMesh``; None where it has one
        rank (nothing to reduce)."""
        size = mesh.size(mesh.mesh_dim_names.index("model"))
        if size == 1:
            return None
        return cls(mesh.get_group("model"), mesh.get_local_rank("model"), size,
                   vocab_size % size == 0)


mesh: Optional[ModelAxis] = None


def set_mesh(m: Optional[ModelAxis]) -> None:
    global mesh
    mesh = m


def get_mesh() -> Optional[ModelAxis]:
    return mesh
