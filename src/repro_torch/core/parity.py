"""How the port's measurement is held against the reference's, and where it
differs by construction (ROADMAP queue 3).

* Kinds, at the committed corpus's witnesses and controls
  (``corpus_points``; ``moe=True`` for the mixtral-8x7b entries'): the port
  reports exactly the kinds of the reference run today (``REFERENCE``),
  except at the points of ``KIND_DIFFERENCES``, each with both kind sets,
  the counter that decides, both values and the cause, and any new
  difference fails.  (Both mixtral-8x7b A1 witnesses show no A1 in the
  reference today: its committed verdicts are not ground truth.)
* The corpus replay's verdicts (``corpus.replay``): the reference's today
  (``REPLAY_REFERENCE``), except ``REPLAY_DIFFERENCES``
  (``unlisted_replay_differences``).
* ``perf.useful_flops_ratio``: within ``USEFUL_RATIO_REL_BOUND`` of the
  reference's, except at the points of ``USEFUL_RATIO_DIFFERENCES``, each
  with both values (CPU trace and CPU compile) and its cause.
* Ops the trace runs replicated (DTensor refused to place them): only those
  of ``REPLICATED_OPS``, each at the points of its class only
  (``unlisted_replications``), with its cause.
* Kinds at points of ``benchmarks/results/bench_fidelity_pairs.json`` (the
  reference's counters of a search campaign): the file's stored counters
  came from another XLA build than the reference the tests run, and today's
  reference gives other kinds at some of its points
  (``PAIR_STORED_DIFFERENCES``, both values each).  The port's engine gives
  today's reference kinds at the points ``tests/test_torch_search.py``
  measures, except those of ``PAIR_KIND_DIFFERENCES``, each with both kind
  sets, the deciding counters' two values and the cause; the test holds
  both tables to a fresh run of the reference.  The dp microbatch split on
  the multi mesh is held by counter values (``MICROBATCH_COUNTERS``).
  ``python -m repro_torch.core.parity`` measures every such point that
  needs no MoE and prints where the port's kinds agree with the stored ones
  (not gated).

``REFERENCE`` holds the reference's measurement (its XLA compile on the CPU,
32 host devices), so that ``chip_smoke.py --measure`` can hold the port to it
on the card, where the JAX package is not run; ``tests/test_torch_measure.py``
holds these values to a fresh run of the reference.
"""
from __future__ import annotations

import json

USEFUL_RATIO_REL_BOUND = 0.10

_MOE = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")

# (arch, shape, preset, mesh, remat) -> (port, reference, cause): none now.
# (Under tp and ep, qwen2's 12 query heads over 2 KV heads on 4 model ranks
# once ran attention replicated on the model axis, at 0.54-0.59x the
# reference's ratio; the trace's GQA form, ``xlaforms._group_heads``, keeps
# it sharded on the heads.)
# A key may also be a corpus point's (``corpus_key``), where its point_key
# is shared by a point with another microbatch count.
USEFUL_RATIO_DIFFERENCES: dict = {
    ("mixtral-8x7b", "train_s", "dp", "single", "none", True, True, "witness", 8):
        (0.3022, 0.8004, "8 microbatches of 4 rows on the 16 dp ranks: each split "
         "runs replicated (see _MICRO)"),
}

_MICRO = ("the microbatch split of the batch (B rows -> n microbatches of B/n) "
          "where the batch is sharded over ranks that do not divide n: DTensor's "
          "view rule keeps a split dim's sharding on its leading part only, so it "
          "refuses the view or plans it over-sharded; the split then runs "
          "replicated (the batch is all-gathered) and each microbatch is sharded "
          "again only where the rules' batch axes divide its rows, where XLA "
          "shards the inner part and reshards it with all-to-alls and "
          "collective-permutes (see MICROBATCH_COUNTERS)")

# ops the trace may run replicated -> ((point class, cause), ...): the op may
# run replicated only at points of one of its classes.  A class maps "arch"
# (the bench arch's base name), "preset" (the sharding preset), "kind" (the
# shape's kind) and "microbatched" (n_microbatch > 1) to the values it admits.
REPLICATED_OPS = {
    "aten.view.default": (
        ({"kind": ("train",), "microbatched": (True,)}, _MICRO),
        ({"arch": _MOE, "kind": ("decode",), "preset": ("dp", "fsdp", "tp", "ep")},
         "MoE's view of a decode step's tokens as groups, (16,1,D) -> (2,8,D) (16 lanes "
         "over 8 experts make 2 groups of 8): the lanes are sharded over 4 or 16 ranks, "
         "more than there are groups, and DTensor cannot split a mesh axis between "
         "the group and the token dims as XLA tiles them; the view runs replicated "
         "(the 16 lanes' activations, 8 KB, are gathered)"),
        ({"arch": _MOE, "kind": ("prefill",), "preset": ("dp",)},
         "MoE's view of the groups back to (B,S,D), (32,256,D) -> (8,1024,D): dp shards "
         "the 32 groups over all 16 ranks, the 8 prefill rows only over the 4 of the "
         "data axis, and DTensor cannot move the excess onto the sequence as XLA does; "
         "the view runs replicated (the output is gathered on the model axis)"),
        ({"kind": ("train",), "microbatched": (True,)},
         "a view that merges a dim sharded behind an unsharded one, which DTensor "
         "plans strided-sharded (no registered product's strategy takes that, and "
         "a fake trace cannot gather it): in the backward of a microbatch whose "
         "rows no batch axis divides, where DTensor shards the head dim instead "
         "(qwen2-1.5b-bench train_s, fsdp, multi mesh, 16 microbatches)")),
    "prims.rev.default": (
        ({"kind": ("train",)},
         "torch 2.11's DTensor has no rule for flip (the cumsum backward), which "
         "it decomposes to prims.rev on a one-rank mesh: nothing is gathered"),),
}


def unlisted_replications(ops, arch: str, preset: str, kind: str,
                          n_microbatch: int) -> list:
    """The ops of ``ops`` (op -> count) that ``REPLICATED_OPS`` does not admit
    at a point of this arch (its config's name, with or without the bench
    suffix), preset, shape kind and microbatch count."""
    cls = {"arch": arch.removesuffix("-bench"), "preset": preset, "kind": kind,
           "microbatched": n_microbatch > 1}
    return sorted(op for op in ops
                  if not any(all(cls[k] in v for k, v in cond.items())
                             for cond, _ in REPLICATED_OPS.get(op, ())))


def unlisted_at(replicated_at) -> list:
    """[(point class, op)] of an engine's ``replicated_at`` (point class ->
    op -> count) that ``REPLICATED_OPS`` does not admit."""
    return [(cls, op) for cls, ops in replicated_at.items()
            for op in (sorted(ops) if cls is None else unlisted_replications(ops, *cls))]


def corpus_key(p: dict, role: str) -> tuple:
    """A corpus point's key: its search point, its cache and vocab sharding,
    its role (two points of one entry may share the rest) and its
    microbatch count."""
    return point_key(p) + (p["cache_shard"], p["vocab_shard"], role, p["n_microbatch"])


# corpus_key -> (the reference's kinds, its perf.useful_flops_ratio)
REFERENCE = {
    ("rwkv6-7b", "train_s", "fsdp", "single", "none", True, True, "witness", 1):
        (("A1",), 0.9439),
    ("qwen2-1.5b", "decode_s", "fsdp", "single", "none", False, True, "witness", 1):
        (("A3",), 0.4506),
    ("qwen2-1.5b", "decode_s", "fsdp", "single", "none", True, True, "control", 1): ((), 1.0005),
    ("qwen2-1.5b", "decode_s", "dp", "single", "none", False, True, "control", 1): ((), 1.0005),
    ("qwen2-1.5b", "decode_s", "dp", "multi", "none", True, True, "witness", 1):
        (("A3",), 0.5003),
    ("qwen2-1.5b", "decode_s", "dp", "single", "none", True, True, "control", 1): ((), 1.0005),
    ("qwen2-1.5b", "decode_s", "ep", "multi", "none", True, True, "control", 1): ((), 0.9521),
    ("qwen2-1.5b", "decode_s", "tp", "single", "none", True, False, "witness", 1):
        (("A3",), 0.5366),
    ("qwen2-1.5b", "decode_s", "fsdp", "single", "none", True, False, "control", 1): ((), 1.0005),
    ("qwen2-1.5b", "decode_s", "tp", "single", "none", True, True, "control", 1): ((), 0.9521),
    # the mixtral-8x7b entries: both A1 witnesses show no A1 in today's
    # reference (their committed verdicts fail there too; see REPLAY_REFERENCE)
    ("mixtral-8x7b", "train_s", "dp", "single", "none", True, True, "witness", 1): ((), 0.8652),
    ("mixtral-8x7b", "train_s", "fsdp", "single", "none", True, True, "witness", 1):
        ((), 0.8652),
    ("mixtral-8x7b", "train_s", "dp", "single", "none", True, True, "witness", 8):
        (("A1", "A2"), 0.8004),
    ("mixtral-8x7b", "train_s", "dp", "single", "none", True, True, "control", 1): ((), 0.8652),
    ("mixtral-8x7b", "train_s", "ep", "single", "none", True, True, "control", 8): ((), 0.8004),
    ("mixtral-8x7b", "long_s", "fsdp", "single", "none", True, True, "witness", 1):
        (("A3",), 0.1177),
}

# corpus_key -> (port kinds, reference kinds, counter, port value (CPU
# trace, torch 2.13), reference value (CPU compile), cause)
KIND_DIFFERENCES = {
    ("rwkv6-7b", "train_s", "fsdp", "single", "none", True, True, "witness", 1):
        (("A1", "A2"), ("A1",), "diag.collective_blowup", 9.108, 3.927,
         "the reference sits just under A2's 4.0; the trace's wire bytes are 2.3x "
         "XLA's: DTensor all-gathers the sequence-sharded activations before the "
         "time-mix products and the WKV, where XLA keeps them split"),
    ("qwen2-1.5b", "decode_s", "tp", "single", "none", True, False, "witness", 1):
        (("A1", "A3"), ("A3",), "perf.roofline_efficiency", 0.2295, 0.2740,
         "the reference sits just over A1's 0.25; the trace's bytes count every "
         "elementwise output (an eager trace has no fusion), which lowers the "
         "roofline efficiency of this memory-bound step"),
    ("mixtral-8x7b", "train_s", "dp", "single", "none", True, True, "witness", 8):
        (("A1", "A2", "A3"), ("A1", "A2"), "perf.useful_flops_ratio", 0.3022, 0.8004,
         "the entry's verdict (A2) holds; 8 microbatches of 4 rows on the 16 "
         "ranks dp shards the batch over: each microbatch's split runs "
         "replicated (see _MICRO), so the step computes 2.6x XLA's FLOPs"),
}


# The pairs file's stored counters were measured with another XLA build than
# the reference the tests run (jax 0.9.0, CPU, 32 host devices): today's
# reference, and the tree of the file's own commit run here, give other bytes
# and wire bytes, and at 35 of the file's 147 non-MoE points other kinds.
# At the points tests/test_torch_search.py measures: index -> (stored kinds,
# today's reference kinds, {counter: (stored value, today's value)}).
PAIR_STORED_DIFFERENCES = {
    13: (("A1", "A2"), (), {"perf.roofline_efficiency": (0.0064027, 0.34113),
                            "diag.collective_blowup": (6.375, 1.8209)}),
    33: (("A1",), (), {"perf.roofline_efficiency": (0.033709, 0.2522)}),
    149: (("A1",), (), {"perf.roofline_efficiency": (0.11441, 0.48987)}),
    205: (("A1",), ("A1", "A2"), {"diag.collective_blowup": (3.4801, 5.1808)}),
}

# The pairs file's index -> (port kinds, today's reference kinds, {counter:
# (port value (CPU trace, torch 2.13), today's reference value)}, cause), at
# the points tests/test_torch_search.py measures
PAIR_KIND_DIFFERENCES = {
    5: (("A1",), (), {"perf.roofline_efficiency": (0.24576, 0.37272)},
        "qwen2-1.5b-bench prefill_s under tp on the multi mesh, blocked attention: the "
        "trace's bytes count every elementwise output (an eager trace has no fusion), "
        "here the f32 scores and running sums of each KV block, which lowers the "
        "roofline efficiency just below A1's 0.25"),
    17: (("A1", "A3"), ("A3",), {"perf.roofline_efficiency": (0.22571, 0.35089)},
         "recurrentgemma-2b-bench decode_s under ep: the trace's bytes count every "
         "elementwise output (an eager trace has no fusion), which lowers the "
         "roofline efficiency of this memory-bound step below A1's 0.25"),
    205: (("A1",), ("A1", "A2"), {"diag.collective_blowup": (3.25, 5.1808)},
          "qwen2-1.5b-bench train_s under fsdp, remat none: XLA moves 1.6x the "
          "trace's wire bytes (142.7 MB in 63 collectives against 89.5 MB in 173), "
          "over A2's 4.0 where the trace stays under it; which of XLA's collectives "
          "the trace does without is not resolved"),
}

# qwen2-1.5b-bench train_s under dp on the multi mesh (the pairs file's point
# 149: remat none, sgdm, seq_shard, zero1, batch 32 on 32 ranks) by
# n_microbatch -> {counter: (port value (CPU trace, torch 2.13), today's
# reference value)}.  At 1 the FLOPs agree.  At 4 each microbatch of 8 rows
# is sharded over pod x data and replicated over model in both; XLA moves
# 2.1x the port's wire bytes resharding the split (its scan over a sharded
# dim: all-to-alls and collective-permutes).  At 16 a microbatch has 2 rows,
# which no batch axis of the rules divides: DTensor runs it replicated on all
# 32 ranks (the gradients are then replicated, and nothing is all-reduced),
# where XLA's partitioner still splits it.  _MICRO is the cause at 4 and 16.
MICROBATCH_COUNTERS = {
    1: {"perf.useful_flops_ratio": (0.92759, 0.92759),
        "diag.collective_wire_bytes": (9.3406e7, 6.5616e7)},
    4: {"perf.useful_flops_ratio": (0.23189, 0.22459),
        "diag.collective_wire_bytes": (1.3748e8, 2.8497e8)},
    16: {"perf.useful_flops_ratio": (0.028987, 0.17287),
         "diag.collective_wire_bytes": (63488.0, 4.1256e8)},
}


# qwen2-1.5b at train_4k on the 16x16 production mesh (fsdp, remat dots), the
# measure phase's full-width point: the port's own CPU trace (torch 2.13), as
# no reference value is taken at this size (XLA's compile for 256 host
# devices is not run).  The card's trace is held within the bound of it.
FULL_WIDTH_USEFUL = 0.8542


def point_key(p: dict) -> tuple:
    return (p["arch"], p["shape"], p["preset"], p["mesh"], p["remat"])


def corpus_points(path, moe: bool = False) -> list:
    """[(signature, kind, role, point)] of every live corpus entry that needs
    no MoE (``moe=True``: of those that do): its minimized witness
    ("witness") and its controls ("control")."""
    with open(path) as f:
        data = json.load(f)
    out = []
    for e in data["entries"]:
        if e.get("retired"):
            continue
        pts = [("witness", e["witness"])] + [("control", c) for c in e["controls"]]
        if any(p["arch"] in _MOE for _, p in pts) != moe:
            continue
        out += [(e["signature"], e["kind"], role, p) for role, p in pts]
    return out


# The replay's verdicts of the committed corpus in the reference today
# (tests/test_corpus_regression.py): signature -> (kind_ok, controls_ok).
# The two mixtral-8x7b A1 witnesses no longer show A1 there.
REPLAY_REFERENCE = {
    "A1": (True, True),
    "A1;preset=dp|ep|tp": (False, True),
    "A1;preset=ep|fsdp|tp": (False, True),
    "A2;preset=dp": (True, True),
    "A3": (True, True),
    "A3;cache_shard=False;preset=fsdp": (True, True),
    "A3;mesh=multi;preset=dp|fsdp": (True, True),
    "A3;preset=dp|ep|tp;vocab_shard=False": (True, True),
}

# signature -> (the port's verdict, the reference's, cause): none.
REPLAY_DIFFERENCES: dict = {}


def unlisted_replay_differences(reports) -> list:
    """The signatures of ``corpus.replay``'s reports whose verdict (kind_ok,
    controls_ok) is not the reference's today, nor a listed difference."""
    out = []
    for r in reports:
        want = REPLAY_DIFFERENCES.get(r["signature"], (None,))[0] \
            or REPLAY_REFERENCE.get(r["signature"])
        if (r["kind_ok"], r["controls_ok"]) != want:
            out.append(r["signature"])
    return out


def verdict_ok(kind: str, role: str, kinds) -> bool:
    """The replay's test: a witness shows ``kind``, a control does not."""
    return (kind in kinds) if role == "witness" else (kind not in kinds)


def expected_kinds(p: dict, role: str) -> tuple:
    """The kinds the port must report at a corpus point: the reference's,
    or the listed port kinds where they differ."""
    key = corpus_key(p, role)
    if key in KIND_DIFFERENCES:
        return KIND_DIFFERENCES[key][0]
    return REFERENCE[key][0]


def useful_ok(key: tuple, port: float, reference: float) -> bool:
    """``port``'s useful-FLOP ratio is within the bound of ``reference``'s
    (or, at a listed difference, of the listed port value); ``key`` a
    point_key or a corpus_key."""
    listed = USEFUL_RATIO_DIFFERENCES.get(key)
    want = reference if listed is None else listed[0]
    return abs(port - want) <= USEFUL_RATIO_REL_BOUND * want


def pair_points(path, moe: bool = False) -> tuple:
    """(archs, restrict, [(index, point, reference counters)]) of the pairs
    file's points that need no MoE (``moe=True``: of those that do) and
    that the reference measured; archs are the file's, less the MoE archs
    where ``moe`` is false."""
    with open(path) as f:
        data = json.load(f)
    archs = [a for a in data["archs"] if moe or a not in _MOE]
    rows = [(i, p, m) for i, (p, m) in enumerate(data["pairs"])
            if m and p["arch"] in archs and (p["arch"] in _MOE) == moe]
    return archs, {k: tuple(v) for k, v in data["restrict"].items()}, rows


def main(argv=None):
    """``python -m repro_torch.core.parity [--device cpu] [--shard i/n]
    [--cache PATH] [--reference FILE ...] [--moe]``: measure the pairs file's
    points that need no MoE (``--moe``: those that do) with the port's
    engine and print, for each, the kinds of
    the file's stored counters, of the reference run afresh where
    ``--reference`` gives its counters ({pair index: counters}, as
    ``tests/reference_counters.py --pairs`` writes them), and the port's; the
    last line is a JSON summary (how many agree, and where they differ).
    Shards of one run share a cache, so a last run without ``--shard`` serves
    every point from it."""
    import argparse
    import pathlib
    import time
    from . import anomaly
    from .benchscale import BENCH_SHAPES, bench_archs, bench_meshes
    from .engine import Engine
    from .searchspace import SearchSpace
    root = pathlib.Path(__file__).resolve().parents[3]
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", default=str(root / "benchmarks" / "results"
                                           / "bench_fidelity_pairs.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shard", default="0/1", help="measure every n-th point from the i-th")
    ap.add_argument("--cache", default=None, help="persistent cache (COLLIE_CACHE)")
    ap.add_argument("--reference", nargs="*", default=(),
                    help="JSON files of the reference's fresh counters by pair index")
    ap.add_argument("--moe", action="store_true", help="the points that need MoE")
    a = ap.parse_args(argv)
    i0, n = (int(x) for x in a.shard.split("/"))
    archs, restrict, rows = pair_points(a.pairs, a.moe)
    fresh = {}
    for path in a.reference:
        fresh.update({int(k): v for k, v in json.loads(pathlib.Path(path).read_text()).items()})
    space = SearchSpace(bench_archs(archs), BENCH_SHAPES, restrict=restrict)
    eng = Engine(space, bench_meshes(), persistent_cache=a.cache, device=a.device)
    differ, counts, t0 = [], {"stored": 0, "reference": 0, "stored_is_reference": 0}, time.time()
    for i, p, stored in rows[i0::n]:
        c = eng.measure(p)
        got = None if c is None else sorted(anomaly.kinds(c, p["remat"]))
        row = {"index": i, "point": point_key(p), "port": got,
               "stored": sorted(anomaly.kinds(stored, p["remat"]))}
        if i in fresh:
            row["reference"] = sorted(anomaly.kinds(fresh[i], p["remat"]))
            counts["reference"] += got == row["reference"]
            counts["stored_is_reference"] += row["stored"] == row["reference"]
        counts["stored"] += got == row["stored"]
        print(f"pair {i} {point_key(p)}: stored {row['stored']}, reference "
              f"{row.get('reference', 'not run')}, port {got}", flush=True)
        if got != row["stored"] or got != row.get("reference", got):
            differ.append(row)
    eng.close()
    print(json.dumps({"points": len(rows[i0::n]),
                      "with_reference": sum(i in fresh for i, _, _ in rows[i0::n]),
                      "port_equals": counts, "differ": differ, "stats": eng.stats(),
                      "errors": eng.errors, "replicated_ops": eng.replicated_ops,
                      "unlisted_replications": [[list(c or ()), op] for c, op in
                                                unlisted_at(eng.replicated_at)],
                      "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
