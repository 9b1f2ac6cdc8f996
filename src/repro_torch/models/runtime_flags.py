"""Process-wide model-execution state: the ambient model axis and, in a
sharded train step, the batch axes.

The counterpart of ``repro.models.runtime_flags``'s mesh. Under a mesh the
reference's model code reads it for its ``shard_map`` blocks; here the
layers read it for their collectives (``layers.reduce_model_axis`` and
``layers.copy_to_model_axis``, the vocabulary-sharded ``embed`` and
``unembed``, the MoE router's gather). ``launch.steps.sharded_step`` sets
it around each step it runs and clears it after. With no mesh it is
``None``, and every one-card path runs the code it runs without one. The
batch axes (``BatchAxes``) are set only inside a sharded train step, where
the MoE load-balance loss takes its means over the global batch through
them (``layers.mean_over_batch_axes``), and a sharded decode step, where
an MoE layer dispatches the global batch's tokens through them
(``moe.moe_forward``).

The reference's ``scan_unroll`` has no counterpart: eager PyTorch runs each
layer, so nothing is undercounted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


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


@dataclass(frozen=True)
class BatchAxes:
    """The batch axes of this rank's mesh (``data``, and ``pod`` where it has
    one): a process group each, and the number of ranks over all of them."""
    groups: Tuple[Any, ...]
    size: int

    @classmethod
    def of(cls, mesh, axes: Tuple[str, ...] = ("pod", "data")) -> Optional["BatchAxes"]:
        """The batch axes of a live ``DeviceMesh`` (those of ``axes`` it
        has); None where they hold one rank (nothing to reduce)."""
        names = [a for a in axes if a in mesh.mesh_dim_names]
        sizes = [mesh.size(mesh.mesh_dim_names.index(a)) for a in names]
        size = 1
        for n in sizes:
            size *= n
        if size == 1:
            return None
        return cls(tuple(mesh.get_group(a) for a, n in zip(names, sizes) if n > 1), size)


mesh: Optional[ModelAxis] = None
batch: Optional[BatchAxes] = None


def set_mesh(m: Optional[ModelAxis]) -> None:
    global mesh
    mesh = m


def get_mesh() -> Optional[ModelAxis]:
    return mesh


def set_batch_axes(b: Optional[BatchAxes]) -> None:
    global batch
    batch = b


def get_batch_axes() -> Optional[BatchAxes]:
    return batch
