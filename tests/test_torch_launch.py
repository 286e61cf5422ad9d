"""The port's launcher (``launch/train.py``) and examples
(``examples/{quickstart,serve_lm,train_lm,elastic_train}.py``) on the CPU, in
process, on one intra-op thread (so that CPU sums run in one order and two
runs can be compared bit for bit):

* a run resumed from its checkpoint ends in the same checkpoint, bit for
  bit, as one uninterrupted run;
* ``--preset`` and ``--compress`` change nothing on one device (no "pod"
  axis: the gradient is not compressed, as in the reference);
* ``--production-mesh`` is refused with the devices it needs and found;
* each example runs with few steps; ``elastic_train`` restarts at the
  reference's step, with the reference's plan.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.runtime import elastic as ref_elastic
from repro_torch.examples import elastic_train, quickstart, serve_lm, train_lm
from repro_torch.launch import train

SMALL = ["--smoke", "--device", "cpu", "--seq", "32", "--batch", "4"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(step_dir: Path) -> dict:
    with np.load(step_dir / "arrays.npz") as data:
        return {k: data[k] for k in data.files}


def test_a_resumed_run_ends_where_an_uninterrupted_one_does(tmp_path, capsys):
    train.main(SMALL + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    train.main(SMALL + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a")])
    assert "[launch] resumed from step 4" in capsys.readouterr().out
    train.main(SMALL + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b")])
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["step_4", "step_6"]
    a, b = _arrays(tmp_path / "a" / "step_6"), _arrays(tmp_path / "b" / "step_6")
    assert a.keys() == b.keys() and len(a) > 20
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _losses(out: str) -> list:
    return re.findall(r"step +\d+ loss \S+ grad_norm \S+", out)


def test_preset_and_compress_change_nothing_on_one_device(tmp_path, capsys):
    train.main(SMALL + ["--steps", "3", "--ckpt-dir", str(tmp_path / "a")])
    base = _losses(capsys.readouterr().out)
    train.main(SMALL + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b"),
                        "--preset", "tp", "--compress", "int8"])
    out = capsys.readouterr().out
    assert "policy=tp/dots/mb2/adamw/f32/compress int8" in out
    assert len(base) == 3 and _losses(out) == base


def test_the_production_mesh_needs_256_devices(tmp_path):
    with pytest.raises(SystemExit) as e:
        train.main(SMALL + ["--steps", "1", "--ckpt-dir", str(tmp_path),
                            "--production-mesh"])
    assert e.value.code == "--production-mesh needs 256 devices (the 16x16 mesh); " \
                           "found 1 cpu device(s)"
    assert not any(tmp_path.iterdir())


def test_quickstart(capsys):
    quickstart.main(["--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step   0 loss" in out and out.count("  request ") == 4
    assert "'prefills': 4" in out


def test_serve_lm(capsys):
    serve_lm.main(["--requests", "3", "--slots", "2", "--max-new", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    # the first token of each request comes from its prefill
    assert out.startswith("3 requests, 9 tokens in ") and "3 prefills" in out


def test_train_lm_saves_and_resumes(tmp_path, capsys):
    args = ["--seq", "32", "--batch", "4", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    train_lm.main(args + ["--steps", "2"])
    train_lm.main(args + ["--steps", "1", "--resume"])
    out = capsys.readouterr().out
    assert "model: llama-20m, " in out and "resumed from step 2" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3"]


def _reference_plan(steps: int):
    """The reference's controller fed ``elastic_train``'s beats (pure logic;
    its example trains with JAX around the same calls): (the step of the
    restart, its plan)."""
    class Clock:
        t = 0.0

        def __call__(self):
            return self.t
    clock = Clock()
    hosts = [f"host{i}" for i in range(8)]
    ctl = ref_elastic.ElasticController(hosts, hosts_per_pod=4, chips_per_host=4,
                                        model_axis=4, multi_pod=True,
                                        heartbeat_timeout_s=5, clock=clock)
    for i in range(steps):
        clock.t += 1.0
        times = {h: 1.0 for h in hosts
                 if not (h == "host7" and i >= elastic_train.FAILED_AT)}
        times["host3"] = 1.8 if i % 3 == 0 else 1.0
        ctl.on_step(times)
        restart, plan, _ = ctl.check()
        if restart:
            return i, plan
    raise AssertionError("no restart")


def test_elastic_train_restarts_as_the_reference(capsys):
    elastic_train.main(["--steps", "18", "--device", "cpu"])
    out = capsys.readouterr().out
    step, plan = _reference_plan(18)
    assert (step, dataclasses.astuple(plan)) == (17, (
        (2, 2, 4), ("pod", "data", "model"), 4, ("host4", "host5", "host6"),
        "kept model=4, data-parallel shrunk to 4"))
    assert (f"step  17 HOST FAILURE detected: {plan.dropped_hosts} -> new mesh "
            f"{dict(zip(plan.axis_names, plan.mesh_shape))} ({plan.note})") in out
    assert "resumed from checkpoint step 15" in out and "survived the failure" in out
