"""The JAX package's counters, measured afresh: its ``measure_cell`` (an XLA
compile on the CPU with 32 host devices) at search points, printed as JSON.

  python tests/reference_counters.py POINTS.json
      POINTS.json holds [points, archs, restrict]; prints the list of their
      counter dicts (``perf.*``/``diag.*``) on one line.
  python tests/reference_counters.py --pairs [--moe] [--shard i/n] --out PATH
      measures the points of benchmarks/results/bench_fidelity_pairs.json
      that need no MoE (``--moe``: those that do; every n-th from the i-th)
      and writes
      {pair index: counters} to PATH, which
      ``python -m repro_torch.core.parity --reference PATH ...`` reads.
  python tests/reference_counters.py --fixture-bytes
      prints the bytes a device (``roofline["hlo_bytes_per_dev"]``) at the
      three cells whose compiled HLO tests/fixtures/ holds, at the points
      of ``repro_torch.core.parity.FIXTURE_CELLS`` (``FIXTURE_BYTES``).

It sets ``XLA_FLAGS`` and ``JAX_PLATFORMS`` itself when they are unset.  The
port's tests run it in a subprocess; the port itself never imports JAX.
"""
import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")


def measure(points, archs, restrict) -> list:
    from repro.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
    from repro.core.counters import measure_cell
    from repro.core.searchspace import SearchSpace
    from repro.launch.steps import build_cell
    space = SearchSpace(bench_archs(archs), BENCH_SHAPES,
                        restrict={k: tuple(v) for k, v in restrict.items()} or None)
    meshes = bench_meshes()
    out = []
    for p in points:
        cfg, shape, policy, mk = space.to_run(space.normalize(p))
        m = measure_cell(build_cell(cfg, shape, policy, meshes[mk]))
        out.append({**{"perf." + k: v for k, v in m.perf.items()},
                    **{"diag." + k: v for k, v in m.diag.items()}})
    return out


def fixture_bytes() -> dict:
    """{fixture name: the reference's bytes a device} at the fixture cells."""
    from repro.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
    from repro.core.counters import measure_cell
    from repro.core.searchspace import SearchSpace
    from repro.launch.steps import build_cell
    from repro_torch.core.parity import FIXTURE_CELLS, fixture_point
    space = SearchSpace(bench_archs(["qwen2-1.5b", "mixtral-8x7b"]), BENCH_SHAPES)
    out = {}
    for name in sorted(FIXTURE_CELLS):
        cfg, shape, policy, mk = space.to_run(fixture_point(space, name))
        m = measure_cell(build_cell(cfg, shape, policy, bench_meshes()[mk]))
        out[name] = m.roofline["hlo_bytes_per_dev"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("points", nargs="?", help="JSON file: [points, archs, restrict]")
    ap.add_argument("--pairs", action="store_true",
                    help="measure the pairs file's points that need no MoE")
    ap.add_argument("--moe", action="store_true", help="--pairs: the points that need MoE")
    ap.add_argument("--shard", default="0/1", help="every n-th pairs point from the i-th")
    ap.add_argument("--out", default=None, help="where --pairs writes its JSON")
    ap.add_argument("--fixture-bytes", action="store_true",
                    help="the bytes a device at the fixture cells")
    a = ap.parse_args(argv)
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=32")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))
    if a.fixture_bytes:
        print(json.dumps(fixture_bytes()))
        return
    if not a.pairs:
        points, archs, restrict = json.loads(pathlib.Path(a.points).read_text())
        print(json.dumps(measure(points, archs, restrict)))
        return
    data = json.loads((ROOT / "benchmarks" / "results" / "bench_fidelity_pairs.json").read_text())
    archs = [x for x in data["archs"] if a.moe or x not in MOE]
    rows = [(i, p) for i, (p, m) in enumerate(data["pairs"])
            if m and p["arch"] in archs and (p["arch"] in MOE) == a.moe]
    i0, n = (int(x) for x in a.shard.split("/"))
    rows = rows[i0::n]
    got = measure([p for _, p in rows], archs, data["restrict"])
    out = json.dumps({str(i): c for (i, _), c in zip(rows, got)})
    if a.out:
        pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(a.out).write_text(out)
    else:
        print(out)


if __name__ == "__main__":
    main()
