"""The port's ``launch/dryrun.py`` against the JAX package's: its policies
and applicability on every (arch, shape) pair, exactly; one production cell
traced on fake ``cpu`` tensors over the 16x16 mesh of the fake process group
(the cheapest that traces, a decode step), a skipped cell, and ``main``'s
files and exit code.  The reference compiles for 256 host devices, which is
not run here: the traced cell is held to the port's own rules (no failed
trace, no op replicated outside ``parity.REPLICATED_OPS``).  The fake group
stays for the worker's life, as in the other measuring test files."""
import dataclasses
import json
from pathlib import Path

import pytest

from repro.configs import base as ref_base
from repro.launch import dryrun as ref_dryrun
from repro_torch.configs import base
from repro_torch.launch import dryrun

PAIRS = [(a, s) for a in base.list_archs() for s in base.SHAPES]
SUMMARY_KEYS = {"status", "mesh_kind", "roofline", "memory", "compile_s",
                "replicated_ops", "unlisted_replications", "host_s"}


def test_the_same_archs_and_shapes():
    assert base.list_archs() == ref_base.list_archs() and len(PAIRS) == 40
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_base.SHAPES.items()}


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_policy_and_applicability_equal_the_references(arch, shape):
    cfg, rcfg = base.get_config(arch), ref_base.get_config(arch)
    sh, rsh = base.SHAPES[shape], ref_base.SHAPES[shape]
    assert dataclasses.asdict(dryrun.default_policy(cfg, sh)) == \
        dataclasses.asdict(ref_dryrun.default_policy(rcfg, rsh))
    over = dict(sharding_preset="dp", n_microbatch=4, grad_compress="int8")
    assert dataclasses.asdict(dryrun.default_policy(cfg, sh, **over)) == \
        dataclasses.asdict(ref_dryrun.default_policy(rcfg, rsh, **over))
    assert dryrun.cell_applicable(cfg, sh) == ref_dryrun.cell_applicable(rcfg, rsh)


def test_results_stay_out_of_the_references_directory():
    assert "benchmarks" not in Path(dryrun.RESULTS_DIR).parts
    assert Path(dryrun.RESULTS_DIR).parts[-2:] == ("results_torch", "dryrun")


def test_a_production_cell_traces():
    res = dryrun.run_cell("internvl2-1b", "decode_32k", False, device="cpu")
    assert SUMMARY_KEYS <= set(res), set(res)
    assert res["status"] == "ok" and res["mesh_kind"] == "single"
    assert res["mesh"] == {"data": 16, "model": 16}
    assert res["unlisted_replications"] == [] and res["replicated_ops"] == {}
    assert 0 < res["roofline"]["useful_flops_ratio"] <= 1.01
    assert res["memory"]["peak_bytes"] > 0 and res["host_s"] > 0


def test_a_full_attention_arch_skips_long_500k():
    res = dryrun.run_cell("qwen2-1.5b", "long_500k", True, device="cpu")
    ok, why = ref_dryrun.cell_applicable(ref_base.get_config("qwen2-1.5b"),
                                         ref_base.SHAPES["long_500k"])
    assert not ok
    assert res == {"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": "multi",
                   "status": "skipped", "reason": why}


def test_main_writes_a_file_a_cell_and_fails_on_a_failed_cell(tmp_path, capsys):
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k", "--mesh", "both",
                 "--out", str(tmp_path / "skip"), "--device", "cpu"])
    files = sorted(p.name for p in (tmp_path / "skip").iterdir())
    assert files == ["qwen2-1.5b__long_500k__multi.json",
                     "qwen2-1.5b__long_500k__single.json"]
    assert all(json.loads(p.read_text())["status"] == "skipped"
               for p in (tmp_path / "skip").iterdir())
    assert capsys.readouterr().out.count("[skip] ") == 2
    with pytest.raises(SystemExit) as e:       # no such preset: every cell fails
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k", "--mesh", "both",
                     "--preset", "nosuch", "--out", str(tmp_path / "fail"),
                     "--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert out.count("[FAIL] ") == 2
    assert [json.loads(p.read_text())["status"] for p in (tmp_path / "fail").iterdir()] \
        == ["fail", "fail"]


def test_the_rglru_gates_view_gathers_a_width_its_blocks_cannot_split():
    """recurrentgemma-2b's RG-LRU width (2560) sharded 16 ways on the
    production mesh's model axis, viewed as its 10 gate blocks: DTensor
    cannot place 16 ranks on 10 blocks, so the trace's form gathers the
    width (one all-gather) instead of running the view, and the block after
    it, replicated."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import traceanalysis, xlaforms
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.rglru import block_view
    dm = make_production_mesh().device_mesh("cpu")
    fake = FakeTensorMode()
    rec = traceanalysis.Recorder(fake)
    with fake:
        x = DTensor.from_local(torch.empty(8, 160), dm, [Shard(0), Shard(1)],
                               run_check=False, shape=torch.Size((128, 2560)),
                               stride=(2560, 1))
    with fake, rec, traceanalysis.dtensor_hooks(rec), xlaforms.XlaForms():
        xg = block_view(x, 10)
    assert tuple(xg.shape) == (128, 10, 256)
    assert list(xg.placements) == [Shard(0), Replicate()]
    assert rec.replicated == {}
    assert [r["coll"] for r in rec.records if r["kind"] == "collective"] == ["all-gather"]
    plain = torch.arange(2 * 2560.0).reshape(2, 2560)
    assert torch.equal(block_view(plain, 10), plain.reshape(2, 10, 256))


def test_recurrentgemma_decode_traces_at_production_size():
    """The production cell the gates' view failed before the form: [ok]
    with nothing replicated, and the useful-FLOP ratio within the bound of
    the reference's dry-run on 512 host devices (0.9438; the port computes
    every gate block on each rank, XLA half of them)."""
    res = dryrun.run_cell("recurrentgemma-2b", "decode_32k", False, device="cpu")
    assert res["status"] == "ok" and res["replicated_ops"] == {}
    useful = res["roofline"]["useful_flops_ratio"]
    assert abs(useful - 0.9438) <= 0.10 * 0.9438, useful


def test_rwkv6_folds_its_sequence_shards_in_place():
    """rwkv6's sequence-parallel WKV folds (B, G, ...) into rows; at
    production size under fsdp both B (data) and the sequence shards G
    (model) are sharded, which DTensor can only view replicated: the trace's
    forms fold and unfold each rank's rows in place, with no collective."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch import traceanalysis, xlaforms
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.rwkv6 import fold_shards, unfold_shards
    dm = make_production_mesh().device_mesh("cpu")
    fake = FakeTensorMode()
    rec = traceanalysis.Recorder(fake)
    with fake:
        x = DTensor.from_local(torch.empty(2, 1, 8, 4, 4), dm, [Shard(0), Shard(1)],
                               run_check=False, shape=torch.Size((32, 16, 8, 4, 4)),
                               stride=(2048, 128, 16, 4, 1))
    with fake, rec, traceanalysis.dtensor_hooks(rec), xlaforms.XlaForms():
        f = fold_shards(x)
        back = unfold_shards(f * 2, x)
    assert tuple(f.shape) == (512, 8, 4, 4) and list(f.placements) == [Shard(0), Shard(0)]
    assert tuple(f.to_local().shape) == (2, 8, 4, 4)
    assert tuple(back.shape) == (32, 16, 8, 4, 4) and list(back.placements) == [Shard(0),
                                                                                Shard(1)]
    assert rec.replicated == {}
    assert not [r for r in rec.records if r["kind"] == "collective"]
    plain = torch.arange(4 * 3 * 2.0).reshape(4, 3, 2)
    assert torch.equal(fold_shards(plain), plain.reshape(12, 2))
    assert torch.equal(unfold_shards(fold_shards(plain), plain), plain)
