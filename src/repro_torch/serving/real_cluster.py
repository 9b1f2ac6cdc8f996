"""Real-plane serving cluster: the SAME ChironController that drives the
reference's simulator drives actual PyTorch engines here (duck-typed to the
instance / cluster protocol the controllers use). This is Chiron in its
deployable form — on the GPU with the full configs, on the CPU with reduced
models through the kernels' plain versions.

Also implements Llumnix-style cross-instance request migration on top of
the engine's slot read/restore (used for rebalancing mixed instances).

The port's copy of the reference's ``serving/real_cluster.py``. On one card
every instance is a share of that card: ``serve_forever`` steps them in
turn, so the ITL an engine measures includes the other instances' steps.

One departure from the reference, in ``serve_forever``: a batch request the
engine preempts itself (an interactive request waits at a full instance,
``StepStats.preempted``) goes back to the global queue. The reference drops
it — it is never finished and the loop ends without it — because
``can_admit`` counts an engine's running slots but not its waiting list, so
one routing pass can hand a full instance more requests than it has slots.
"""
from __future__ import annotations

# mirror-sync: module ok(real engine has no RequestLedger/InstancePlane)
# The columnar mirrors exist only in the simulated data plane.
import itertools
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backpressure import LocalMetrics
from repro_torch.core.local_autoscaler import LocalAutoscaler
from repro_torch.models import Model
from repro_torch.models.api import resolve_device
from repro_torch.serving.engine import Engine, StepStats
from repro_torch.serving.request import Request, RequestState, RequestType
from repro_torch.sim.cluster import (SLOW_SUSPECT_RATIO, InstanceState,
                                     InstanceType)
from repro_torch.sim.perf_model import PerfModel

_inst_ids = itertools.count(1000)


class RealInstance:
    """Engine + instance type + local autoscaler; the instance protocol."""

    def __init__(self, cfg: ModelConfig, itype: InstanceType, now: float, *,
                 max_slots: int = 6, max_len: int = 128,
                 local_autoscaler: Optional[LocalAutoscaler] = None,
                 static_batch: Optional[int] = None,
                 load_time: float = 0.0, params=None, seed: int = 0,
                 model: str = "llama-8b", device="cuda",
                 dtype=torch.float32):
        self.id = next(_inst_ids)
        self.cfg = cfg
        self.model = model           # served model (multi-model routing key)
        self.itype = itype
        self.state = InstanceState.LOADING
        self.ready_time = now + load_time
        self.local = local_autoscaler
        self.static_batch = static_batch
        device = resolve_device(device)
        gen = None
        if params is None:           # weights of its own, from ``seed``
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
        self.engine = Engine(cfg, gen=gen, params=params,
                             max_slots=max_slots, max_len=max_len,
                             max_batch_size=(local_autoscaler.max_batch_size
                                             if local_autoscaler
                                             else static_batch or max_slots),
                             dtype=dtype, device=device)
        self._last_stats: Optional[StepStats] = None
        # slow-node health protocol: the routing layer reads
        # ``suspected_slow``; a real deployment would EWMA observed step
        # time against a per-hardware baseline, but nothing here has a
        # calibrated expected-ITL model yet, so real instances never
        # self-report degradation (as in the reference)
        self.health_ewma = 1.0

    def update_health(self, alpha: float = 0.5) -> None:
        pass

    @property
    def suspected_slow(self) -> bool:
        return self.health_ewma > SLOW_SUSPECT_RATIO

    # ------------------------------------------------ protocol: state
    def activate_if_ready(self, now: float) -> None:
        # Real engine: no simulated-float drift between ready_time and now.
        # repro-lint: ok(DET205, both times come from one monotonic clock)
        if self.state == InstanceState.LOADING and now >= self.ready_time:
            self.state = InstanceState.ACTIVE

    @property
    def active(self) -> bool:
        return self.state == InstanceState.ACTIVE

    @property
    def max_batch_size(self) -> int:
        if self.local is not None:
            return self.local.max_batch_size
        return self.static_batch or self.engine.max_slots

    @property
    def n_running(self) -> int:
        return self.engine.n_active

    @property
    def running(self):
        """Instance protocol: items expose ``.request``."""
        return [s for s in self.engine.slots if s.active]

    def slot_utilization(self) -> float:
        return self.engine.n_active / max(self.max_batch_size, 1)

    def kv_utilization(self) -> float:
        return self.slot_utilization()

    def runs_interactive(self) -> bool:
        return any(s.request.is_interactive for s in self.running)

    def n_running_batch(self) -> int:
        return sum(1 for s in self.running
                   if not s.request.is_interactive)

    def min_itl_slo(self) -> float:
        return min((s.request.slo.itl for s in self.running),
                   default=float("inf"))

    def spare_throughput(self) -> float:
        spare = self.max_batch_size - self.n_running
        thr = self.engine.throughput()
        if spare <= 0 or self.n_running == 0 or thr <= 0:
            return 0.0
        return thr * spare / self.n_running

    # ------------------------------------------------ protocol: intake
    def can_admit(self, req: Request) -> bool:
        if not self.active or self.n_running >= self.max_batch_size:
            return False
        if req.model != self.model:
            return False            # never serve a wrong-model request
        return self.engine._free_slot() is not None

    def admit(self, req: Request, now: float) -> None:
        self.engine.submit(req)

    def evict_one_batch(self, now: float) -> Optional[Request]:
        return self.engine.preempt_one_batch(now)

    # ------------------------------------------------ execution
    def step(self, now: float) -> StepStats:
        stats = self.engine.step()
        self._last_stats = stats
        return stats

    def update_local_autoscaler(self) -> None:
        if self.local is None or self._last_stats is None or \
                self._last_stats.n_active == 0:
            return
        self.local.update(LocalMetrics(
            observed_itl=self._last_stats.itl,
            throughput=max(self._last_stats.throughput, 1e-6),
            itl_slo=self.min_itl_slo(),
            n_active=self._last_stats.n_active,
            batch_size=self.local.max_batch_size))
        self.engine.set_max_batch_size(self.local.max_batch_size)

    # ------------------------------------------------ migration
    def migrate_out(self, req_id: int) -> Optional[Request]:
        """Remove a running request, carrying its KV state (Llumnix-style
        live migration): the slot's cache is copied to the host."""
        for i, s in enumerate(self.engine.slots):
            if s.active and s.request.req_id == req_id:
                req = s.request
                req.saved_kv = self.engine._read_slot(i)
                req.state = RequestState.PREEMPTED
                self.engine.slots[i] = type(s)()
                return req
        return None


class RealCluster:
    """The cluster protocol over real engines.

    Instances share one set of initialized params per model config (real
    clusters load the same checkpoint): made once, on ``device`` in
    ``dtype``, from a generator on that device seeded with 0, unless
    ``params`` are given. Each instance has its own KV pool of
    ``max_slots`` x ``max_len``. `load_time` models bring-up delay in the
    serving loop's clock without sleeping.
    """

    def __init__(self, cfg: ModelConfig, *, max_chips: int = 64,
                 chips_per_instance: int = 1, max_slots: int = 6,
                 max_len: int = 128, load_time: float = 0.0,
                 device="cuda", dtype=torch.float32, params=None):
        self.cfg = cfg
        self.max_chips = max_chips
        self.chips_per_instance = chips_per_instance
        self.max_slots = max_slots
        self.max_len = max_len
        self.load_time = load_time
        self.device = resolve_device(device)
        self.dtype = dtype
        self.instances: List[RealInstance] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.chip_seconds = 0.0
        self.peak_chips = 0
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            params = Model(cfg).init(gen, dtype=dtype, device=self.device)
        self._shared_params = params
        # planning estimate for Algorithm 2's Theta (perf model of the
        # full-size family member; production would calibrate online)
        self.perf_factory: Callable[[str], PerfModel] = \
            lambda name: PerfModel(name if name in
                                   ("llama-8b", "llama-70b") else "llama-8b")

    # ------------------------------------------------ protocol
    def by_type(self, itype: InstanceType) -> List[RealInstance]:
        return [i for i in self.instances if i.itype == itype]

    def by_model(self, model: str, itype: InstanceType) -> List[RealInstance]:
        return [i for i in self.instances
                if i.itype == itype and i.model == model]

    def instances_of(self, model: str) -> List[RealInstance]:
        return [i for i in self.instances if i.model == model]

    def active_instances(self) -> List[RealInstance]:
        return [i for i in self.instances if i.active]

    def used_chips(self) -> int:
        return len(self.instances) * self.chips_per_instance

    def provision(self, model: str, itype: InstanceType, now: float,
                  **inst_kw) -> Optional[RealInstance]:
        if self.used_chips() + self.chips_per_instance > self.max_chips:
            return None
        inst = RealInstance(self.cfg, itype, now, max_slots=self.max_slots,
                            max_len=self.max_len,
                            load_time=self.load_time,
                            params=self._shared_params, model=model,
                            device=self.device, dtype=self.dtype,
                            **inst_kw)
        self.instances.append(inst)
        self.scale_ups += 1
        self.peak_chips = max(self.peak_chips, self.used_chips())
        return inst

    def retire(self, inst: RealInstance) -> List[Request]:
        displaced = []
        for i, s in enumerate(inst.engine.slots):
            if s.active:
                r = inst.migrate_out(s.request.req_id)
                if r is not None:
                    displaced.append(r)
        displaced.extend(inst.engine.waiting)
        inst.engine.waiting.clear()
        inst.engine.close()          # frees its decode graph's memory pool
        inst.state = InstanceState.RETIRED
        self.instances.remove(inst)
        self.scale_downs += 1
        return displaced

    def tick_accounting(self, dt: float) -> None:
        self.chip_seconds += self.used_chips() * dt

    # ------------------------------------------------ migration
    def migrate(self, req_id: int, src: RealInstance,
                dst: RealInstance) -> bool:
        """Move a running request between instances, KV state and all."""
        if not dst.active or dst.engine._free_slot() is None:
            return False
        req = src.migrate_out(req_id)
        if req is None:
            return False
        dst.engine.submit(req)
        return True

    def rebalance(self, now: float, threshold: float = 0.9) -> int:
        """Move batch requests off crowded mixed instances onto idle ones
        (Llumnix-style defragmentation); returns migrations performed."""
        moved = 0
        insts = self.active_instances()
        for src in insts:
            if src.slot_utilization() < threshold:
                continue
            dsts = [d for d in insts
                    if d is not src and d.slot_utilization() < 0.5
                    and d.engine._free_slot() is not None]
            if not dsts:
                continue
            victims = [s.request for s in src.running
                       if s.request.request_type == RequestType.BATCH]
            if not victims:
                continue
            dst = min(dsts, key=lambda d: d.slot_utilization())
            if self.migrate(victims[-1].req_id, src, dst):
                moved += 1
        return moved


def serve_forever(requests: List[Request], controller, cluster: RealCluster,
                  *, max_steps: int = 2000, control_every: int = 5,
                  clock=None) -> Dict:
    """Drive a real cluster: arrivals -> controller.route (shared with the
    reference's simulator) -> engine steps -> local autoscaler updates."""
    from repro_torch.serving.global_queue import GlobalQueue
    clock = clock or time.monotonic
    t0 = clock()
    queue = GlobalQueue()
    pending = sorted(requests, key=lambda r: r.arrival_time)
    pi = 0
    steps = 0
    while steps < max_steps:
        now = clock() - t0
        while pi < len(pending) and pending[pi].arrival_time <= now:
            queue.push(pending[pi])
            pi += 1
        for inst in cluster.instances:
            inst.activate_if_ready(now)
        if steps % control_every == 0:
            controller.control(cluster, queue, now)
            for inst in cluster.active_instances():
                inst.update_local_autoscaler()
        controller.route(cluster, queue, now)
        for inst in cluster.active_instances():
            for victim in inst.step(now).preempted:
                queue.requeue(victim)       # the reference drops these
        cluster.tick_accounting(0.0)
        steps += 1
        if pi >= len(pending) and len(queue) == 0 and \
                all(i.n_running == 0 and i.engine.n_waiting == 0
                    for i in cluster.instances):
            break
    done = [r for r in requests if r.state == RequestState.FINISHED]
    return {"steps": steps, "finished": len(done), "total": len(requests),
            "wall_s": clock() - t0,
            "scale_ups": cluster.scale_ups,
            "scale_downs": cluster.scale_downs}
