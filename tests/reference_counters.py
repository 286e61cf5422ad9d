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
  python tests/reference_counters.py --wire SPEC.json
      SPEC.json holds [point, n_layers, seq_len, global_batch] (nulls: the
      bench cell's own): the point's bench cell cut to that depth and
      shape; prints the wire bytes a device by collective kind, the
      collectives of each loop body, and each computation's bytes and wire
      (``wire``).

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


def wire(point, n_layers=None, seq_len=None, batch=None) -> dict:
    """Of ``point``'s bench cell (at ``n_layers`` layers, ``seq_len`` and
    ``batch`` where given): the wire bytes a device by collective kind; the
    collectives of each computation XLA runs more than once (a loop body),
    [multiplier, [[kind, operand bytes], ...]]; and each computation's
    bytes and wire a device, {name: [multiplier, bytes, {kind: wire}]},
    as ``hloanalysis.analyze`` counts them (their bytes sum to its
    ``bytes_hbm``, which is checked; its loop bodies' names tell the layer
    loop's forward and backward bodies and the WKV's chunk loop)."""
    import dataclasses
    from collections import defaultdict
    from repro.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
    from repro.core.searchspace import SearchSpace
    from repro.launch import hloanalysis as H
    from repro.launch.steps import build_cell
    space = SearchSpace(bench_archs([point["arch"]]), BENCH_SHAPES)
    cfg, shape, policy, mk = space.to_run(space.normalize(point))
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if seq_len:
        shape = dataclasses.replace(shape, seq_len=seq_len, global_batch=batch)
    text = build_cell(cfg, shape, policy, bench_meshes()[mk]).lower().compile().as_text()
    comps = H.parse_hlo(text)
    edges, fused = H._call_graph(comps)
    mult = H._multipliers(comps, edges)
    phantoms, converting = H._phantom_upcasts(comps, fused)
    loops, by_comp = [], {}
    for name, comp in comps.items():
        m = mult.get(name, 0)
        if name == "__entry__" or name in fused or not m:
            continue
        ops, nb, wires = [], 0.0, defaultdict(float)
        for i in comp.instrs:
            if i.coll_base:
                if not i.opcode.endswith("-done"):
                    ob = sum(H._res_bytes(comp.by_name[o]) for o in i.operands
                             if o in comp.by_name)
                    g = H._GROUPS_RE.search(i.attrs)
                    ops.append([i.coll_base, ob])
                    wires[i.coll_base] += ob * H._WIRE_FACTOR[i.coll_base](
                        max(int(g.group(2)) if g else 2, 2)) * m
                continue
            if i.opcode in H._SKIP_BYTES_OPS or i.name in phantoms:
                continue
            nb += m * _instr_bytes(H, i, comp, comps, phantoms, converting)
        if ops and m > 1:
            loops.append([m, ops])
        by_comp[name] = [m, nb, dict(wires)]
    whole = H.analyze(text)
    # the computations' bytes are analyze's, split by computation
    assert abs(sum(v[1] for v in by_comp.values()) - whole["bytes_hbm"]) \
        <= 1e-9 * whole["bytes_hbm"], (sum(v[1] for v in by_comp.values()), whole["bytes_hbm"])
    return {"collective_wire": whole["collective_wire"], "loops": loops,
            "computations": by_comp}


def _instr_bytes(H, i, comp, comps, phantoms, converting) -> float:
    """An instruction's bytes as ``hloanalysis.analyze`` counts them."""
    if i.opcode == "fusion" and i.calls in comps:
        return H._fusion_io_bytes(i, comps[i.calls])
    out = H._res_bytes(i)
    users = comp.consumers.get(i.name, ())
    if i.opcode == "dot" and i.result_type.startswith("f32") and users \
            and all(j.name in phantoms for j in users):
        out //= 2
    if i.name in converting and i.name not in phantoms and users \
            and all(j.opcode == "dot" for j in users):
        out //= 2
    for o in i.operands:
        if o in comp.by_name:
            ob = H._res_bytes(comp.by_name[o])
            out += ob // 2 if o in phantoms or (o in converting and i.opcode == "dot") else ob
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
    ap.add_argument("--wire", default=None,
                    help="JSON file: [point, n_layers, seq_len, global_batch] (nulls: the cell's)")
    a = ap.parse_args(argv)
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=32")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))
    if a.fixture_bytes:
        print(json.dumps(fixture_bytes()))
        return
    if a.wire:
        print(json.dumps(wire(*json.loads(pathlib.Path(a.wire).read_text()))))
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
