"""Fault-tolerance runtime: heartbeats, straggler detection, elastic re-mesh;
the counterpart of the JAX package's ``runtime/elastic.py``, the same logic.

Designed for 1000+ node fleets; the mechanisms are pure control-plane logic
(unit-testable on CPU with simulated clocks) wired into the training launcher:

* ``HeartbeatMonitor``  — per-host liveness; a host silent for > timeout is
  declared failed (in a real deployment heartbeats ride the coordination
  service / GCS bucket; here they are injected by the launcher or tests).
* ``StragglerDetector`` — sliding-window per-host step times; hosts slower
  than ``k × median`` for ``patience`` consecutive windows are flagged so the
  launcher can exclude or deprioritize them (straggler mitigation).
* ``ElasticPlan``       — given surviving hosts, choose the largest usable
  mesh (keeping the "model" axis intact, shrinking "data"/"pod"), and the
  batch re-sharding plan; training resumes from the last checkpoint.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from collections import defaultdict, deque


class HeartbeatMonitor:
    def __init__(self, hosts, timeout_s: float = 30.0, clock=time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        now = clock()
        self.last_seen = {h: now for h in hosts}

    def beat(self, host):
        self.last_seen[host] = self.clock()

    def failed_hosts(self):
        now = self.clock()
        return sorted(h for h, t in self.last_seen.items()
                      if now - t > self.timeout)

    def alive_hosts(self):
        failed = set(self.failed_hosts())
        return sorted(h for h in self.last_seen if h not in failed)


class StragglerDetector:
    def __init__(self, window: int = 20, threshold: float = 1.5,
                 patience: int = 3):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self.times = defaultdict(lambda: deque(maxlen=window))
        self.strikes = defaultdict(int)

    def record(self, host, step_time_s: float):
        self.times[host].append(step_time_s)

    def stragglers(self):
        means = {h: statistics.fmean(ts) for h, ts in self.times.items() if ts}
        if len(means) < 2:
            return []
        med = statistics.median(means.values())
        out = []
        for h, m in means.items():
            if m > self.threshold * med:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.patience:
                out.append(h)
        return sorted(out)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple          # new (pod, data, model) / (data, model)
    axis_names: tuple
    n_hosts_used: int
    dropped_hosts: tuple
    note: str


def plan_elastic_mesh(alive_hosts, hosts_per_pod: int, chips_per_host: int,
                      model_axis: int, multi_pod: bool) -> ElasticPlan:
    """Shrink the mesh to the largest power-of-two data axis that fits.

    The "model" axis is preserved (param sharding layout unchanged => cheap
    restart from checkpoint); "data" (and "pod") shrink. Hosts beyond the
    chosen size are released back to the scheduler.
    """
    n = len(alive_hosts)
    if n == 0:
        raise RuntimeError("no alive hosts")
    chips = n * chips_per_host
    if chips < model_axis:
        raise RuntimeError(f"not enough chips ({chips}) for model axis {model_axis}")
    rest = chips // model_axis
    data = 1 << (rest.bit_length() - 1)        # largest pow2 <= rest
    if multi_pod and data >= 2:
        pods = 2
        shape = (pods, data // pods, model_axis)
        names = ("pod", "data", "model")
    else:
        shape = (data, model_axis)
        names = ("data", "model")
    used_chips = 1
    for s in shape:
        used_chips *= s
    n_used = -(-used_chips // chips_per_host)
    dropped = tuple(alive_hosts[n_used:])
    return ElasticPlan(shape, names, n_used, dropped,
                       f"kept model={model_axis}, data-parallel shrunk to {data}")


class ElasticController:
    """Glue: monitors -> plan -> restart decision for the launcher loop."""

    def __init__(self, hosts, hosts_per_pod, chips_per_host, model_axis,
                 multi_pod, heartbeat_timeout_s=30.0, clock=time.monotonic):
        self.hb = HeartbeatMonitor(hosts, heartbeat_timeout_s, clock)
        self.straggler = StragglerDetector()
        self.hosts_per_pod = hosts_per_pod
        self.chips_per_host = chips_per_host
        self.model_axis = model_axis
        self.multi_pod = multi_pod
        self._known_failed: set = set()

    def on_step(self, host_times: dict):
        for h, t in host_times.items():
            self.hb.beat(h)
            self.straggler.record(h, t)

    def check(self):
        """Returns (needs_restart, ElasticPlan|None, stragglers)."""
        failed = set(self.hb.failed_hosts())
        stragglers = self.straggler.stragglers()
        if failed - self._known_failed:
            self._known_failed = failed
            plan = plan_elastic_mesh(self.hb.alive_hosts(), self.hosts_per_pod,
                                     self.chips_per_host, self.model_axis,
                                     self.multi_pod)
            return True, plan, stragglers
        return False, None, stragglers
