"""Device meshes: not ported.

The reference builds a 16 x 16 (or 2 x 16 x 16) TPU mesh and shards every
step over it with GSPMD (``repro.launch.mesh``, ``repro.launch.shardings``,
``repro.launch.steps.jit_step``). The port runs on one card, where a
``torch.distributed`` tensor-parallel plan could be neither run nor
checked, so every entry point here raises ``NotImplementedError``
(ROADMAP.md, Queue A item 8b-ii). llama-70b at full width (141.10 GB of
bf16 weights against the card's 85.02 GB) waits on the same decision.
"""
from __future__ import annotations

_WHY = ("a device mesh is not ported to repro_torch: the port runs on one card "
        "(ROADMAP.md, Queue A item 8b-ii)")


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(_WHY)


def make_local_mesh(model_axis: int = 1):
    raise NotImplementedError(_WHY)


def mesh_axis_sizes(mesh) -> dict:
    raise NotImplementedError(_WHY)
