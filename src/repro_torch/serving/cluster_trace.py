"""A replayable record of a real cluster's run, for parity checks.

``SharedClock`` gives ``serve_forever`` a clock that advances one tick per
call and every engine a clock that reads the same "now" without advancing
it, so that the ITL and throughput Algorithm 1 sees are one tick per loop
whatever the host does. ``ClusterRecorder`` wraps a cluster's ``provision``
and ``retire`` and each instance's ``admit``, ``evict_one_batch`` and
``step``, and logs, in order, every decision and, after every engine step,
each slot's request and next token, the requests that finished and those
the engine preempted. Requests are named by their index in the request
list and instances by their provision order, so the logs of two runs
compare as lists even where request and instance ids differ.

It touches only the duck-typed cluster protocol (and ``engine.clock``,
``engine.slots``), so it records the reference package's cluster the same
way; it changes no decision.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


class SharedClock:
    """``advance`` is ``serve_forever``'s clock; ``read`` the engines'."""

    def __init__(self, tick: float = 0.05):
        self.tick = tick
        self.t = 0.0

    def advance(self) -> float:
        self.t += self.tick
        return self.t

    def read(self) -> float:
        return self.t


def _token(tok):
    """A slot's next input token as an int (the reference keeps a (1,)
    array), or None for a free slot."""
    return None if tok is None else int(np.asarray(tok).reshape(-1)[0])


class ClusterRecorder:
    """Logs ``cluster``'s decisions and tokens (see the module docstring);
    with ``clock``, every provisioned engine reads ``clock.read``."""

    def __init__(self, cluster, requests: Sequence, clock: SharedClock = None):
        self.cluster = cluster
        self.clock = clock
        self.log: List[tuple] = []
        self._req = {id(r): i for i, r in enumerate(requests)}
        self._inst = {}
        self._provision, self._retire = cluster.provision, cluster.retire
        cluster.provision = self.provision
        cluster.retire = self.retire

    def req(self, r) -> int:
        return self._req[id(r)]

    def inst(self, inst) -> int:
        return self._inst[id(inst)]

    def provision(self, model, itype, now, **kw):
        inst = self._provision(model, itype, now, **kw)
        if inst is None:
            self.log.append(("provision refused", itype.value))
            return None
        self._inst[id(inst)] = len(self._inst)
        self.log.append(("provision", self.inst(inst), itype.value))
        if self.clock is not None:
            inst.engine.clock = self.clock.read
        self._wrap(inst)
        return inst

    def retire(self, inst):
        displaced = self._retire(inst)
        self.log.append(("retire", self.inst(inst),
                         sorted(self.req(r) for r in displaced)))
        return displaced

    def _wrap(self, inst) -> None:
        n = self.inst(inst)
        admit, evict, step = inst.admit, inst.evict_one_batch, inst.step

        def admit_logged(req, now):
            self.log.append(("admit", n, self.req(req)))
            return admit(req, now)

        def evict_logged(now):
            victim = evict(now)
            self.log.append(("evict", n, None if victim is None
                             else self.req(victim)))
            return victim

        def step_logged(now):
            stats = step(now)
            self.log.append((
                "step", n,
                [(self.req(s.request), _token(s.token))
                 for s in inst.engine.slots if s.active],
                sorted(self.req(r) for r in stats.finished),
                [self.req(r) for r in stats.preempted]))
            return stats

        inst.admit, inst.evict_one_batch, inst.step = \
            admit_logged, evict_logged, step_logged

    # ------------------------------------------------------------ views
    def decisions(self) -> List[tuple]:
        """The log without the engine steps: what the controller did."""
        return [e for e in self.log if e[0] != "step"]

    def tokens_of(self, index: int) -> List[int]:
        """Request ``index``'s next input token after each step that ran it."""
        return [tok for e in self.log if e[0] == "step"
                for i, tok in e[2] if i == index]
