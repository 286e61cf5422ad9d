"""The trace's bytes counted over XLA-style fusion groups
(``repro_torch.launch.traceanalysis.fusion_groups``).

* On op sequences traced by hand (fake tensors, the recorder's dataflow):
  an elementwise chain is one fusion; a reduction takes its producers; a
  product stands alone; a cheap producer read by two fusions is duplicated
  into both, an expensive one written once; a slice of a stacked param
  reads only the slice (and a producer fused through a slice computes that
  slice); no fusion crosses a collective; a bf16 tensor is counted at f32
  width outside the products; a lookup reads the rows it gathers; a bf16 ->
  f32 upcast that a product reads is free and the product reads the bf16
  original; views and in-place updates keep their ids.
* The port's bytes a device at the three cells whose compiled HLO
  ``tests/fixtures/`` holds (qwen2-1.5b fsdp ``train_s`` with remat dots
  and 2 microbatches, mixtral-8x7b ep ``prefill_s``, qwen2-1.5b tp
  ``decode_s``), within 0.85-1.15x of the reference's, measured afresh on
  the same points (``tests/reference_counters.py --fixture-bytes``, in a
  subprocess).  The fixtures were compiled by an older XLA build: its CPU
  backend expanded the embedding and label scatters into per-row loops, so
  ``expected_hlo_analysis.json``'s ``bytes_hbm`` is 38x (train) and 61x
  (prefill) today's; the port is held to today's reference, whose values
  ``TODAY_BYTES`` records (and ``chip_smoke.py``'s measure phase reads
  through ``parity.FIXTURE_BYTES``): the test holds them to the fresh run
  within 1 %, and checks that they still differ from the fixture's by more.
* A product whose operand XLA lays out anew: the layout copy counts in
  ``transpose_bytes``, as the reference's top-level copies do.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import parity
from repro_torch.launch import traceanalysis as ta
from repro_torch.launch import xlaforms

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reference's hlo_bytes_per_dev at the fixture cells, from its
# measure_cell (XLA's compile on the CPU, 32 host devices, jax 0.9.0) on
# this tree's src/repro, at the points of tests/fixtures/capture_fixtures.py:
# `python tests/reference_counters.py --fixture-bytes`, which `reference`
# runs again; core/parity.py keeps the same for chip_smoke.py's measure phase
TODAY_BYTES = {"train": 1926124770.0, "prefill": 854703374.0, "decode": 28951802.0}
BOUNDS = (0.85, 1.15)


@pytest.fixture(scope="module")
def reference():
    """{fixture name: the reference's bytes a device}, measured now."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=32",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "reference_counters.py"),
                        "--fixture-bytes"], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _trace(fn, *shapes, dtype=torch.float32):
    """(records, argument ids, output ids) of ``fn`` on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode()
    with fake:
        args = [torch.empty(s, dtype=d) for s, d in
                ((s, dtype) if not isinstance(s[-1], torch.dtype) else (s[:-1], s[-1])
                 for s in shapes)]
    rec = ta.Recorder(fake)
    arg_ids = {rec.id_of(a) for a in args}
    with fake, rec, xlaforms.XlaForms():
        out = fn(*args)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return rec.records, arg_ids, {rec.id_of(o) for o in outs}


def _groups(fn, *shapes, dtype=torch.float32):
    records, args, outs = _trace(fn, *shapes, dtype=dtype)
    groups = ta.fusion_groups(records, outs, args)
    ops = lambda g: [records[k]["op"].split(".")[1] for k in g[1]]
    return [(g[0], ops(g), g[2], g[3]) for g in groups]


def test_an_elementwise_chain_is_one_fusion():
    g = _groups(lambda x: torch.tanh(x * 2.0 + 1.0), (64, 32))
    assert g == [("fuse", ["mul", "add", "tanh"], 64 * 32 * 4, 64 * 32 * 4)]


def test_a_reduction_takes_its_producers():
    g = _groups(lambda x: (x * x + 1.0).sum(-1), (64, 32))
    assert g == [("reduce", ["mul", "add", "sum"], 64 * 32 * 4, 64 * 4)]


def test_a_product_stands_alone():
    g = _groups(lambda x, w: (x * 2.0) @ w, (64, 32), (32, 16))
    assert [(r, o) for r, o, _, _ in g] == [("fuse", ["mul"]), ("alone", ["dot_general"])]
    assert g[0][2:] == (64 * 32 * 4, 64 * 32 * 4)
    assert g[1][2:] == (64 * 32 * 4 + 32 * 16 * 4, 64 * 16 * 4)


def test_a_cheap_producer_is_duplicated_into_each_fusion():
    """A bf16 -> f32 upcast read by two reductions: no fusion writes it,
    both read the bf16 input (at its f32 width in XLA's CPU module)."""
    def fn(x):
        y = x.float()
        return y.sum(-1), y.amax(-1)
    g = _groups(fn, (64, 32, torch.bfloat16))
    assert [(r, o) for r, o, _, _ in g] == [("reduce", ["_to_copy", "sum"]),
                                             ("reduce", ["_to_copy", "amax"])]
    assert [rb for _, _, rb, _ in g] == [64 * 32 * 4] * 2


def test_an_expensive_producer_is_written_once():
    def fn(x):
        y = torch.exp(x)
        return y.sum(-1), y.amax(-1)
    g = _groups(fn, (64, 32))
    assert [(r, o) for r, o, _, _ in g] == [("fuse", ["exp"]), ("reduce", ["sum"]),
                                             ("reduce", ["amax"])]
    assert g[0][3] == 64 * 32 * 4 and g[1][2] == g[2][2] == 64 * 32 * 4


def test_a_slice_of_a_stacked_param_reads_only_the_slice():
    g = _groups(lambda x, w: x * w[1], (32, 16), (4, 32, 16))
    assert g == [("fuse", ["mul"], 2 * 32 * 16 * 4, 32 * 16 * 4)]
    g = _groups(lambda x, w: x * w[1] + w[2], (32, 16), (4, 32, 16))
    assert g[0][2] == 3 * 32 * 16 * 4
    # a producer fused in through a slice computes that slice only
    g = _groups(lambda w: (w * 2.0)[1].sum(), (4, 32, 16))
    assert g == [("reduce", ["mul", "sum"], 32 * 16 * 4, 4)]


def test_no_fusion_crosses_a_collective():
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch.mesh import make_mesh
    dm = make_mesh((4,), ("model",)).device_mesh("cpu")

    def fn(x):
        y = funcol.all_reduce(x * 2.0, "sum", (dm, 0))
        return funcol.wait_tensor(y) * 3.0
    g = _groups(fn, (64, 32))
    assert [(r, o) for r, o, _, _ in g] == [("fuse", ["mul"]), ("fuse", ["mul"])]
    assert all(rb == wb == 64 * 32 * 4 for _, _, rb, wb in g)


def test_bf16_outside_the_products_counts_at_f32_width():
    g = _groups(lambda x, w: torch.relu(x @ w), (64, 32, torch.bfloat16),
                (32, 16, torch.bfloat16))
    assert g[0][0] == "alone" and g[0][2:] == ((64 * 32 + 32 * 16) * 2, 64 * 16 * 4)
    assert g[1] == ("fuse", ["relu"], 64 * 16 * 4, 64 * 16 * 4)


def test_a_lookup_reads_the_rows_it_gathers():
    g = _groups(lambda t, i: F.embedding(i, t), (1000, 32), (4, 8, torch.int64))
    assert g == [("alone", ["embedding"], 4 * 8 * 32 * 4 + 4 * 8 * 8, 4 * 8 * 32 * 4)]


def test_an_upcast_a_product_reads_is_free():
    g = _groups(lambda x, t: x @ t.float().t(), (4, 32), (1000, 32, torch.bfloat16))
    assert [(r, o) for r, o, _, _ in g] == [("alone", ["dot_general"])]
    assert g[0][2] == 4 * 32 * 4 + 1000 * 32 * 2


def test_views_and_in_place_updates_keep_the_dataflow():
    def fn(c, v):
        c[1].copy_(v)              # the layer's slice of a cache, in place
        return c.sum()
    records, args, outs = _trace(fn, (4, 8, 16), (8, 16))
    sel = next(r for r in records if r["op"].startswith("aten.select"))
    cp = next(r for r in records if r["op"].startswith("aten.copy_"))
    sm = next(r for r in records if r["op"].startswith("aten.sum"))
    assert sel["reads"][0][0] == sel["writes"][0][0] in args
    assert cp["targets"] == [0] and cp["writes"][0][0] not in args
    assert sm["reads"][0][0] == cp["writes"][0][0]


@pytest.mark.parametrize("eqn,n,order,ok", [
    ("aby,yz->abz", 0, "aby", True),
    ("aby,yz->abz", 1, "yz", True),
    ("aby,yz->abz", 1, "zy", True),         # no batch dim: either order
    ("abz,aby->yz", 0, "abz", False),       # contracted dims lead: XLA transposes
    ("bqkgd,btkd->bkgqt", 1, "btkd", False),
    ("bqkgd,btkd->bkgqt", 1, "bktd", False),
    ("bqkgd,btkd->bkgqt", 1, "bkdt", True),
    ("bkgqt,btkd->bqkgd", 2, "bqkgd", False),
])
def test_the_dot_layouts_xla_takes(eqn, n, order, ok):
    letters = eqn.replace("->", ",").split(",")[n]
    shape = [2] * len(letters)
    stride = [0] * len(letters)
    s = 1
    for ch in reversed(order):
        stride[letters.index(ch)] = s
        s *= 2
    assert ta._dot_layout_ok(eqn, n, (tuple(shape), tuple(stride), 0)) is ok


def test_a_layout_copy_of_a_product_operand_is_transpose_bytes():
    """``abz,aby->yz`` contracts the leading dims: XLA copies each operand
    to the layout its dot takes, a top-level copy."""
    records, args, outs = _trace(lambda a, b: torch.einsum("abz,aby->yz", a, b),
                                 (4, 8, 16), (4, 8, 32))
    copies = [g for g in ta.fusion_groups(records, outs, args) if g[0] == "copy"]
    assert copies
    out = ta.analyze(records, arg_ids=args, out_ids=outs)
    assert out["transpose_bytes"] == sum(g[2] + g[3] for g in copies)


@pytest.mark.parametrize("name", sorted(TODAY_BYTES))
def test_the_recorded_bytes_are_todays_reference(reference, name):
    assert abs(TODAY_BYTES[name] / reference[name] - 1) <= 0.01, (TODAY_BYTES[name],
                                                                   reference[name])


def test_todays_reference_differs_from_the_fixture():
    fixture = json.loads((ROOT / "tests" / "fixtures" / "expected_hlo_analysis.json").read_text())
    for name, today in TODAY_BYTES.items():
        assert abs(today / fixture[name]["bytes_hbm"] - 1) > 0.01, name
    assert parity.FIXTURE_BYTES == TODAY_BYTES and parity.FIXTURE_BYTES_BOUNDS == BOUNDS


@pytest.mark.parametrize("name", sorted(TODAY_BYTES))
def test_bytes_a_device_at_the_fixture_cells(reference, name):
    from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
    from repro_torch.core.counters import measure_cell
    from repro_torch.core.searchspace import SearchSpace
    from repro_torch.launch.steps import build_cell
    space = SearchSpace(bench_archs(["qwen2-1.5b", "mixtral-8x7b"]), BENCH_SHAPES)
    cfg, shape, policy, mesh_kind = space.to_run(parity.fixture_point(space, name))
    m = measure_cell(build_cell(cfg, shape, policy, bench_meshes()[mesh_kind]), device="cpu")
    ratio = m.roofline["hlo_bytes_per_dev"] / reference[name]
    assert BOUNDS[0] <= ratio <= BOUNDS[1], ratio
