"""Instance enums of the cluster protocol the controllers speak.

The port's copy of ``InstanceType``, ``InstanceState`` and
``SLOW_SUSPECT_RATIO`` from the reference's ``sim/cluster.py``, with the
same values. The simulated data plane there (``SimCluster``,
``SimInstance``, the instance plane) is not ported yet (ROADMAP.md, Queue A
item 9); the port's cluster is the real one, ``serving/real_cluster.py``.
"""
from __future__ import annotations

import enum

# health-EWMA ratio (observed ITL / healthy-model ITL) above which an
# instance is suspected slow and routed around (slow-node degradation)
SLOW_SUSPECT_RATIO = 1.8


class InstanceType(enum.Enum):
    INTERACTIVE = "interactive"
    MIXED = "mixed"
    BATCH = "batch"


class InstanceState(enum.Enum):
    LOADING = "loading"
    ACTIVE = "active"
    RETIRED = "retired"
