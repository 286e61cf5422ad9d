"""The port's ``runtime/elastic.py`` against the JAX package's: the
reference's own cases (``tests/test_elastic.py``), and both controllers fed
one seeded sequence of heartbeats, step times and clock ticks, their
``check()`` results equal at every step."""
import dataclasses

import numpy as np
import pytest

from repro.runtime import elastic as ref
from repro_torch.runtime import elastic as port
from repro_torch.runtime.elastic import (ElasticController, HeartbeatMonitor,
                                         StragglerDetector, plan_elastic_mesh)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_heartbeat_failure_detection():
    clk = FakeClock()
    hb = HeartbeatMonitor(["h0", "h1", "h2"], timeout_s=10, clock=clk)
    clk.t = 5
    hb.beat("h0")
    hb.beat("h1")
    clk.t = 12
    assert hb.failed_hosts() == ["h2"]
    assert hb.alive_hosts() == ["h0", "h1"]


def test_straggler_detection_with_patience():
    sd = StragglerDetector(window=5, threshold=1.5, patience=2)
    for _ in range(5):
        for h in ("a", "b", "c"):
            sd.record(h, 1.0)
        sd.record("slow", 3.0)
    assert sd.stragglers() == []          # patience 2 not yet reached
    for h in ("a", "b", "c"):
        sd.record(h, 1.0)
    sd.record("slow", 3.0)
    assert sd.stragglers() == ["slow"]


def test_straggler_recovers():
    sd = StragglerDetector(window=3, threshold=1.5, patience=1)
    for h in ("a", "b"):
        sd.record(h, 1.0)
    sd.record("c", 5.0)
    assert sd.stragglers() == ["c"]
    for _ in range(3):
        sd.record("c", 1.0)
        sd.record("a", 1.0)
        sd.record("b", 1.0)
    assert sd.stragglers() == []


def test_elastic_plan_preserves_model_axis():
    plan = plan_elastic_mesh(list(range(100)), hosts_per_pod=64,
                             chips_per_host=4, model_axis=16, multi_pod=True)
    assert plan.axis_names[-1] == "model"
    assert plan.mesh_shape[-1] == 16
    total = 1
    for s in plan.mesh_shape:
        total *= s
    assert total <= 100 * 4
    assert plan.n_hosts_used <= 100


def test_elastic_plan_too_few_chips():
    with pytest.raises(RuntimeError):
        plan_elastic_mesh(["h0"], 64, 4, model_axis=16, multi_pod=False)


def test_controller_triggers_restart_once():
    clk = FakeClock()
    hosts = [f"h{i}" for i in range(8)]
    ctl = ElasticController(hosts, 4, 4, model_axis=4, multi_pod=False,
                            heartbeat_timeout_s=10, clock=clk)
    clk.t = 8
    ctl.on_step({h: 1.0 for h in hosts[:-1]})   # h7 silent
    clk.t = 14                                  # h7 stale (14 > 10), rest ok
    restart, plan, _ = ctl.check()
    assert restart and plan is not None
    assert plan.mesh_shape[-1] == 4
    restart2, _, _ = ctl.check()                # same failure: no re-trigger
    assert not restart2


@pytest.mark.parametrize("seed,multi_pod", [(0, True), (1, False), (2, True)])
def test_controllers_agree_on_a_seeded_sequence(seed, multi_pod):
    """Hosts fall silent one by one, some run slow for a while; the clock
    advances by random ticks.  Both packages' controllers see the same beats
    and step times and return the same (restart, plan, stragglers)."""
    rng = np.random.default_rng(seed)
    hosts = [f"host{i}" for i in range(16)]
    clocks = FakeClock(), FakeClock()
    ctls = [mod.ElasticController(hosts, hosts_per_pod=8, chips_per_host=4,
                                  model_axis=4, multi_pod=multi_pod,
                                  heartbeat_timeout_s=6, clock=clk)
            for mod, clk in zip((ref, port), clocks)]
    dead_at = {h: int(rng.integers(5, 120)) for h in rng.choice(hosts, 5, replace=False)}
    slow = set(rng.choice(hosts, 3, replace=False))
    restarts = stragglers = 0
    for step in range(150):
        tick = float(rng.uniform(0.5, 2.0))
        times = {}
        for h in hosts:
            if step >= dead_at.get(h, 10**9) or rng.random() < 0.05:
                continue                       # failed, or a missed beat
            t = float(rng.uniform(0.9, 1.1))
            if h in slow and 30 <= step < 90:
                t *= float(rng.uniform(1.4, 2.5))
            times[h] = t
        for clk, ctl in zip(clocks, ctls):
            clk.t += tick
            ctl.on_step(times)
        got = [ctl.check() for ctl in ctls]
        (r0, p0, s0), (r1, p1, s1) = got
        assert (r0, s0) == (r1, s1), step
        assert (p0 is None) == (p1 is None), step
        if p0 is not None:
            assert dataclasses.astuple(p0) == dataclasses.astuple(p1), step
        restarts += r0
        stragglers += bool(s0)
    assert restarts >= 2 and stragglers >= 1       # the sequence exercised both
