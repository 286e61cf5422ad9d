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

* Kinds at the frontend archs' bench points (internvl2-1b, musicgen-medium:
  train_s, prefill_s and decode_s under the four presets on both bench
  meshes) and at compressed multi-mesh train points (``grid_key``): the
  reference's today (``POINT_REFERENCE``), except
  ``POINT_KIND_DIFFERENCES``; the useful-FLOP ratio within the bound of the
  reference's.  Where the reference's XLA aborts the process
  (``REFERENCE_ABORTS``: every compressed point but int8 under dp), the
  port's own kinds (its CPU trace) stand alone.

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
# it sharded on the heads.  The corpus's mixtral-8x7b A2 witness, 8
# microbatches of 4 rows on 16 dp ranks, once ran each split replicated, at
# 0.3022 against 0.8004; the trace's split, ``xlaforms._microbatches``, keeps
# each microbatch sharded as XLA does: 0.8004.)
# A key may also be a corpus point's (``corpus_key``), where its point_key
# is shared by a point with another microbatch count.
USEFUL_RATIO_DIFFERENCES: dict = {}

# ops the trace may run replicated -> ((point class, cause), ...): the op may
# run replicated only at points of one of its classes.  A class maps "arch"
# (the bench arch's base name), "preset" (the sharding preset), "kind" (the
# shape's kind) and "microbatched" (n_microbatch > 1) to the values it admits.
REPLICATED_OPS = {
    "aten.view.default": (
        ({"arch": _MOE, "kind": ("decode",), "preset": ("dp", "fsdp", "tp", "ep")},
         "MoE's view of a decode step's tokens as groups, (16,1,D) -> (2,8,D) (16 lanes "
         "over 8 experts make 2 groups of 8): the lanes are sharded over 4 or 16 ranks, "
         "more than there are groups, and DTensor cannot split a mesh axis between "
         "the group and the token dims as XLA tiles them; the view runs replicated "
         "(the 16 lanes' activations, 8 KB, are gathered)"),
        ({"arch": ("recurrentgemma-2b",), "kind": ("train",), "preset": ("fsdp",)},
         "the backward of the RG-LRU's associative scan: DTensor places a level's "
         "gradient sharded on the sequence over the model axis (the forward shards the "
         "width there), and the view that splits the last levels' steps into pairs, "
         "fewer steps than model ranks ((B,4,W) -> (B,2,2,W) on 4 ranks at the bench, "
         "(B,16,W) -> (B,8,2,W) on 16 in production), runs replicated: a few steps of "
         "B x W f32 are gathered, where XLA reshards them")),
    "prims.rev.default": (
        ({"kind": ("train",)},
         "torch 2.11's DTensor has no rule for flip (the cumsum backward), which "
         "it decomposes to prims.rev on a one-rank mesh: nothing is gathered (a "
         "cumsum of a DTensor runs on its shards, xlaforms._Cumsum)"),),
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
# trace, torch 2.13), reference value (CPU compile), cause): none.  (The
# rwkv6-7b A1 witness once also showed A2, blowup 9.031 against 3.927: its
# token shift all-gathered the sequence, where GSPMD exchanges a halo
# (xlaforms._shift), and its chunked WKV gathered each chunk's streams
# once a chunk (xlaforms._hoisted_select, _stack); now kinds A1.  The
# qwen2-1.5b tp decode witness once also showed A1, roofline efficiency
# 0.2295 against 0.2740, when the trace's bytes were a per-op rule; over
# the fusion groups (traceanalysis.fusion_groups) 0.2690, kinds A3.  The
# mixtral-8x7b ep control at 8 microbatches showed A1 and A2, efficiency
# 0.2376 and blowup 4.209 against 0.2519 and 3.191, while the trace counted
# the MoE units' weight gradients at their true group of 4, where the
# reference's analyzer reads 2 from the list XLA writes their groups as
# (traceanalysis.xla_collectives); now 0.2904 and 3.443, no kinds.)
KIND_DIFFERENCES: dict = {}


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
    49: (("A1", "A3"), ("A3",), {"perf.roofline_efficiency": (0.040895, 0.25605)}),
}

# The pairs file's index -> (port kinds, today's reference kinds, {counter:
# (port value (CPU trace, torch 2.13), today's reference value)}, cause).
# tests/test_torch_search.py and test_torch_moe_measure.py hold the entries
# of any points they measure to a fresh reference run; the
# others are held by ``python -m repro_torch.core.parity --reference``.  A
# cause that names bytes splits the reference's by the loop XLA runs them in
# (``tests/reference_counters.py --wire``: the layer loop's forward and
# backward bodies, the microbatch loop's, and the rest) and the port's by
# phase (``traceanalysis.analyze``'s ``bytes_by_phase``).
PAIR_KIND_DIFFERENCES = {
    222: (("A1", "A2"), ("A1",), {"diag.collective_blowup": (5.4797, 3.532)},
          "mixtral-8x7b-bench train_s under tp on the single mesh, 8 microbatches, one row "
          "a rank: XLA writes the replica groups of the activations' partial sums in its "
          "layer loop out as a list too, which the reference's analyzer reads as a group "
          "of 2 (hloanalysis._GROUPS_RE); the trace counts their true group of 4 (counting "
          "them as 2 would take pair 10, whose trace lacks XLA's gathers of the 2-D "
          "sharded activations, off the reference's kinds)"),
    223: ((), ("A1",), {"perf.roofline_efficiency": (0.25639, 0.23857)},
          "mixtral-8x7b-bench train_s under ep on the single mesh, 8 microbatches, remat "
          "dots: XLA's step is memory-bound, 3 % under A1's 0.25, the trace's bound by "
          "its wire (310.0 MB against 289.5) because its bytes are 0.834x XLA's (4550.7 MB "
          "against 5454.6). XLA runs 1314.4 MB in its layer loop's forward body, 2873.9 in "
          "its backward body (the recompute in it), 966.4 in its microbatch body (the "
          "embedding, the loss and the unembedding, forward and backward) and 299.9 "
          "outside; the trace 1090.9 in the forward's loops, 2892.6 in the recompute and "
          "the backward with the loss, 567.2 outside the loops in the forward: the layer "
          "loop's forward is 0.83x XLA's, and the rest 0.84x"),
    236: (("A1", "A3"), ("A1",), {"perf.useful_flops_ratio": (0.47073, 1.2301)},
          "mixtral-8x7b-bench prefill_s under dp on the single mesh: 8 rows on the 4 data "
          "ranks; GSPMD carries the MoE groups' sharding over data and model (32 groups "
          "on 16 ranks) back through the (B, S) -> groups reshape into the sequence of the "
          "dense layers, which it computes 16 ways, where the trace computes them on the "
          "rows' 4 ways, whole on each model rank (2.6x the FLOPs)"),
}

# The pairs file's points that chip_smoke.py --measure-pair traces on the
# card, by index -> today's reference's kinds (the fresh run of
# tests/reference_counters.py --pairs [--moe]; tests/test_torch_search.py
# holds the non-MoE ones to it, tests/test_torch_moe_micro.py 215): a decode
# step against an unsharded cache under tp (19), rwkv6-7b's microbatched
# train step under dp on the multi mesh (29: 4 microbatches, remat dots),
# and mixtral-8x7b's under dp on the single mesh in 16 microbatches of 2
# rows (215: local attention's chunk view, xlaforms._chunk_view, on a
# sequence that carries the batch's ranks).  Pair 126 (8 microbatches) gave
# these kinds on the card too, in 746-912 s of the host's time beside the
# script's other phases: it is held on the CPU only
# (tests/test_torch_search.py).
SMOKE_PAIRS = {19: ("A1",), 29: ("A1", "A2", "A3"), 215: ("A1", "A2")}

# The deciding counters of the corpus's witnesses whose kinds agree: corpus_key
# -> ({counter: (port value (CPU trace, torch 2.13), reference value (CPU
# compile))}, cause).  tests/test_torch_measure.py holds both values to 4
# digits, and chip_smoke.py's measure phase the card's: each counter within
# COUNTER_BOUND of the reference's, or outside it with the cause (None: every
# counter within).  The rwkv6-7b A1 witness's wire is 148.7 MB a device
# against 171.8: all-gather 85.0 against 92.4, all-to-all 24.4 against 26.7,
# collective-permute 0.1 against 2.5 (the reference's 9 more, in its backward
# and the embedding's), and 32.8 MB of all-reduce and 6.4 of reduce-scatter
# against 50.1 of all-reduce: the trace counts the 26 reduce-scatters of the
# weights' gradients as DTensor runs them, where XLA's CPU module runs
# all-reduces of twice their wire (counting them so takes pair 49, whose
# table gradient GSPMD splits over an idle axis, off the reference's kinds).
WITNESS_COUNTERS = {
    ("rwkv6-7b", "train_s", "fsdp", "single", "none", True, True, "witness", 1): (
        {"perf.roofline_efficiency": (0.1617, 0.1477), "diag.collective_blowup": (3.398, 3.927)},
        None),
}
COUNTER_BOUND = 0.15

# qwen2-1.5b-bench train_s under dp on the multi mesh (the pairs file's point
# 149: remat none, sgdm, seq_shard, zero1, batch 32 on 32 ranks) by
# n_microbatch -> {counter: (port value (CPU trace, torch 2.13), today's
# reference value)}.  At 1 the FLOPs agree, and the wire bytes count XLA's
# f32 collectives over joint groups and the gathers of the ZeRO-1 update
# (train_step._gathered_as).  XLA tiles the (n, 32/n) reshape of
# the 32 ranks as n ranks on n and 32/n on the rows (the minor ones),
# all-gathers n before its loop, and keeps each microbatch's rows on those
# 32/n ranks, replicated on the other n (``xlaforms._microbatches``).  At 4
# each microbatch of 8 rows is sharded over 8 ranks and replicated over 4 in
# both (pod x data in the port), and XLA moves the embedding and the logits
# between its rows' ranks and the constraints' by collective-permutes
# (``xlaforms._from_batch``); the table's gradient under ZeRO-1 is split
# over the idle model axis (``xlaforms._unembed``), which moves the port's
# FLOPs under XLA's.  At 16 a microbatch has 2 rows, one a rank on the low
# half of the model axis, and XLA's loop splits the weights over data
# (the stacked layers' embedding dim, the tied table's vocab) as ZeRO-1
# leaves them: its products contract a quarter of the width, their partial
# sums all-reduced over data, each layer's weight gradients all-gathered
# over data (``xlaforms._Body``).  The trace's FLOPs are 7 % over XLA's
# (the unembedding's input gradient, made on a quarter of the table where
# XLA makes it on a sixteenth), and its wire 1.29x XLA's as the reference
# counts it: XLA writes the replica groups of its layer loop's all-reduces
# of partial activations over data out as lists, which the reference's
# analyzer reads as groups of 2 (80 MB of the 115 MB; the trace counts
# their true group of 4, as at pair 222), and the trace's backward
# reduce-scatters 28 MB of the norms' input gradients onto the split.
MICROBATCH_COUNTERS = {
    1: {"perf.useful_flops_ratio": (0.92759, 0.92759),
        "diag.collective_wire_bytes": (7.192e7, 6.5616e7)},
    4: {"perf.useful_flops_ratio": (0.25697, 0.22459),
        "diag.collective_wire_bytes": (2.0126e8, 2.8497e8)},
    16: {"perf.useful_flops_ratio": (0.16115, 0.17287),
         "diag.collective_wire_bytes": (5.2713e8, 4.1256e8)},
}

# The dp microbatch points chip_smoke.py's measure pairs phase traces on the
# card: (the pairs file's index, n_microbatch) -> today's reference's kinds
# (tests/test_torch_search.py holds them and the port's CPU trace to a
# fresh reference run).
SMOKE_MICROBATCH = {(149, 16): ("A1", "A2", "A3")}


# qwen2-1.5b at train_4k on the 16x16 production mesh (fsdp, remat dots), the
# measure phase's full-width point: the port's own CPU trace (torch 2.13), as
# no reference value is taken at this size (XLA's compile for 256 host
# devices is not run).  The card's trace is held within the bound of it.
FULL_WIDTH_USEFUL = 0.8542


# The three cells whose compiled HLO tests/fixtures/ holds (the fixture's
# name -> arch, shape, the point's factors over the space's first values),
# and the bytes a device today's reference counts there (its measure_cell,
# XLA's compile on the CPU with 32 host devices, jax 0.9.0;
# ``python tests/reference_counters.py --fixture-bytes``): the trace's
# bytes are held within FIXTURE_BYTES_BOUNDS of them.  The fixture files
# themselves were compiled by an older XLA, whose CPU backend expanded the
# embedding and label scatters into per-row loops (their bytes_hbm is 38x
# and 61x these at train and prefill).
FIXTURE_CELLS = {
    "train": ("qwen2-1.5b", "train_s", {"remat": "dots", "n_microbatch": 2, "preset": "fsdp"}),
    "prefill": ("mixtral-8x7b", "prefill_s", {"preset": "ep"}),
    "decode": ("qwen2-1.5b", "decode_s", {"preset": "tp"}),
}
FIXTURE_BYTES = {"train": 1926124770.0, "prefill": 854703374.0, "decode": 28951802.0}
FIXTURE_BYTES_BOUNDS = (0.85, 1.15)


def fixture_point(space, name) -> dict:
    """The search point of fixture cell ``name`` in ``space``."""
    arch, shape, overrides = FIXTURE_CELLS[name]
    base = {k: v[0] for k, v in space.factors.items()}
    return space.normalize({**base, "arch": arch, "shape": shape, "mesh": "single",
                            **overrides})


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


# ------------------------------------------ the frontends and compressed points

def grid_key(p: dict) -> tuple:
    """(arch, shape, preset, mesh, remat, grad_compress) of a search point."""
    return point_key(p) + (p["grad_compress"],)


_VIT_TRAIN = ("memory-bound step, the FLOPs XLA's to 4 digits: the trace's layer loop "
              "forward counts {fwd}; its backward and what is outside the loops fall "
              "short: {bwd}")
# grid_key -> (the reference's kinds, its perf.useful_flops_ratio): the
# reference's measure_cell (CPU, 32 host devices) at each frontend arch's
# bench points (baseline point: remat none) and the compressed int8 points
# under dp, the only compressed points it measures
POINT_REFERENCE = {
    ('internvl2-1b', 'train_s', 'dp', 'single', 'none', 'none'): (('A1',), 0.9331),
    ('internvl2-1b', 'train_s', 'dp', 'multi', 'none', 'none'): ((), 0.9331),
    ('internvl2-1b', 'train_s', 'fsdp', 'single', 'none', 'none'): (('A1',), 0.9331),
    ('internvl2-1b', 'train_s', 'fsdp', 'multi', 'none', 'none'): ((), 0.9331),
    ('internvl2-1b', 'train_s', 'tp', 'single', 'none', 'none'): (('A1', 'A3'), 0.4557),
    ('internvl2-1b', 'train_s', 'tp', 'multi', 'none', 'none'): (('A1', 'A3'), 0.4557),
    ('internvl2-1b', 'train_s', 'ep', 'single', 'none', 'none'): (('A1', 'A3'), 0.4557),
    ('internvl2-1b', 'train_s', 'ep', 'multi', 'none', 'none'): (('A1', 'A3'), 0.4557),
    ('internvl2-1b', 'prefill_s', 'dp', 'single', 'none', 'none'): (('A1', 'A3'), 0.2637),
    ('internvl2-1b', 'prefill_s', 'dp', 'multi', 'none', 'none'): (('A1', 'A3'), 0.2637),
    ('internvl2-1b', 'prefill_s', 'fsdp', 'single', 'none', 'none'): (('A1',), 1.0548),
    ('internvl2-1b', 'prefill_s', 'fsdp', 'multi', 'none', 'none'): (('A1',), 1.0548),
    ('internvl2-1b', 'prefill_s', 'tp', 'single', 'none', 'none'): (('A1', 'A3'), 0.3246),
    ('internvl2-1b', 'prefill_s', 'tp', 'multi', 'none', 'none'): (('A1', 'A3'), 0.3246),
    ('internvl2-1b', 'prefill_s', 'ep', 'single', 'none', 'none'): (('A1', 'A3'), 0.3246),
    ('internvl2-1b', 'prefill_s', 'ep', 'multi', 'none', 'none'): (('A1', 'A3'), 0.3246),
    ('internvl2-1b', 'decode_s', 'dp', 'single', 'none', 'none'): ((), 1.0103),
    ('internvl2-1b', 'decode_s', 'dp', 'multi', 'none', 'none'): (('A3',), 0.5051),
    ('internvl2-1b', 'decode_s', 'fsdp', 'single', 'none', 'none'): ((), 1.0103),
    ('internvl2-1b', 'decode_s', 'fsdp', 'multi', 'none', 'none'): ((), 1.0103),
    ('internvl2-1b', 'decode_s', 'tp', 'single', 'none', 'none'): (('A1',), 0.7348),
    ('internvl2-1b', 'decode_s', 'tp', 'multi', 'none', 'none'): (('A1',), 0.7348),
    ('internvl2-1b', 'decode_s', 'ep', 'single', 'none', 'none'): (('A1',), 0.7348),
    ('internvl2-1b', 'decode_s', 'ep', 'multi', 'none', 'none'): (('A1',), 0.7348),
    ('musicgen-medium', 'train_s', 'dp', 'single', 'none', 'none'): ((), 0.9450),
    ('musicgen-medium', 'train_s', 'dp', 'multi', 'none', 'none'): ((), 0.9450),
    ('musicgen-medium', 'train_s', 'fsdp', 'single', 'none', 'none'): ((), 0.9450),
    ('musicgen-medium', 'train_s', 'fsdp', 'multi', 'none', 'none'): ((), 0.9450),
    ('musicgen-medium', 'train_s', 'tp', 'single', 'none', 'none'): ((), 0.9450),
    ('musicgen-medium', 'train_s', 'tp', 'multi', 'none', 'none'): ((), 0.9450),
    ('musicgen-medium', 'train_s', 'ep', 'single', 'none', 'none'): ((), 0.9450),
    ('musicgen-medium', 'train_s', 'ep', 'multi', 'none', 'none'): ((), 0.9450),
    ('musicgen-medium', 'prefill_s', 'dp', 'single', 'none', 'none'): (('A1', 'A3'), 0.3749),
    ('musicgen-medium', 'prefill_s', 'dp', 'multi', 'none', 'none'): (('A1', 'A3'), 0.3749),
    ('musicgen-medium', 'prefill_s', 'fsdp', 'single', 'none', 'none'): (('A1',), 1.4995),
    ('musicgen-medium', 'prefill_s', 'fsdp', 'multi', 'none', 'none'): ((), 1.4995),
    ('musicgen-medium', 'prefill_s', 'tp', 'single', 'none', 'none'): (('A1',), 1.4995),
    ('musicgen-medium', 'prefill_s', 'tp', 'multi', 'none', 'none'): (('A1',), 1.4995),
    ('musicgen-medium', 'prefill_s', 'ep', 'single', 'none', 'none'): (('A1',), 1.4995),
    ('musicgen-medium', 'prefill_s', 'ep', 'multi', 'none', 'none'): (('A1',), 1.4995),
    ('musicgen-medium', 'decode_s', 'dp', 'single', 'none', 'none'): ((), 1.0004),
    ('musicgen-medium', 'decode_s', 'dp', 'multi', 'none', 'none'): (('A3',), 0.5002),
    ('musicgen-medium', 'decode_s', 'fsdp', 'single', 'none', 'none'): ((), 1.0004),
    ('musicgen-medium', 'decode_s', 'fsdp', 'multi', 'none', 'none'): ((), 1.0004),
    ('musicgen-medium', 'decode_s', 'tp', 'single', 'none', 'none'): ((), 1.0004),
    ('musicgen-medium', 'decode_s', 'tp', 'multi', 'none', 'none'): ((), 1.0004),
    ('musicgen-medium', 'decode_s', 'ep', 'single', 'none', 'none'): ((), 1.0004),
    ('musicgen-medium', 'decode_s', 'ep', 'multi', 'none', 'none'): ((), 1.0004),
    ('qwen2-1.5b', 'train_s', 'dp', 'multi', 'none', 'int8'): (('A1', 'A2'), 0.9276),
    ('internvl2-1b', 'train_s', 'dp', 'multi', 'none', 'int8'): (('A1', 'A2'), 0.9331),
    ('musicgen-medium', 'train_s', 'dp', 'multi', 'none', 'int8'): (('A1', 'A2'), 0.9450),
}

# grid_key -> (port kinds, reference kinds, counter, port value (CPU trace,
# torch 2.13), reference value (CPU compile), cause).  (internvl2-1b decode_s
# under tp and ep on the multi mesh once lacked A1, roofline efficiency
# 0.2652 against 0.2285: the reference's analyzer counts a layer's slice of
# a stacked weight or cache twice, once more for the loop index its fusion
# reads, which weighs most where wq and wo are whole on every rank (14 heads
# on 4 model ranks), and XLA's CPU module fuses a single row's product with
# its weight's convert; the trace counted each slice once and gathered a
# decode step's scores for a softmax over the whole cache.  Now
# traceanalysis._copies_for_product and xlaforms._softmax: 0.2331.)
POINT_KIND_DIFFERENCES = {
    ('internvl2-1b', 'train_s', 'dp', 'single', 'none', 'none'): ((), ('A1',), "perf.roofline_efficiency", 0.2726, 0.2342, _VIT_TRAIN.format(
        fwd="682.8 MB against 681.9 in its forward body", bwd="757.6 MB in the backward and 291.9 "
        "outside in the forward, against 814.7 in XLA's backward body and 519.9 outside the "
        "loops (0.859x XLA's 2016.6 MB)")),
    ('internvl2-1b', 'train_s', 'fsdp', 'single', 'none', 'none'): ((), ('A1',), "perf.roofline_efficiency", 0.2717, 0.24, _VIT_TRAIN.format(
        fwd="702.2 MB against 663.1 in its forward body", bwd="866.5 MB in the backward and 169.5 "
        "outside in the forward, against 802.2 in XLA's backward body and 502.7 outside the "
        "loops (0.883x XLA's 1968.0 MB)")),
}

# The compressed train points where the reference's XLA aborts the process (a
# fatal check, not an exception; one point a process, CPU, 32 host devices):
# bf16 under dp, and both modes under fsdp, tp and ep.  Only int8 under dp
# measures.  The port traces each with no failed trace.
_ABORT_COPY = "hlo_instruction.cc:1585 Invalid binary instruction opcode copy"
_ABORT_GROUPS = ("spmd_partitioner_util.cc:495 Check failed: "
                 "partition_group_list.num_replica_groups() * "
                 "partition_group_list.num_devices_per_group() == "
                 "device_groups.num_devices_per_group()")

# grid_key -> (the port's kinds (CPU trace, torch 2.13), the reference's abort)
REFERENCE_ABORTS = {
    ('qwen2-1.5b', 'train_s', 'dp', 'multi', 'none', 'bf16'): (('A1', 'A2'), _ABORT_COPY),
    ('qwen2-1.5b', 'train_s', 'fsdp', 'multi', 'none', 'int8'): ((), _ABORT_GROUPS),
    ('qwen2-1.5b', 'train_s', 'fsdp', 'multi', 'none', 'bf16'): ((), _ABORT_GROUPS),
    ('qwen2-1.5b', 'train_s', 'tp', 'multi', 'none', 'int8'): ((), _ABORT_GROUPS),
    ('qwen2-1.5b', 'train_s', 'tp', 'multi', 'none', 'bf16'): ((), _ABORT_GROUPS),
    ('qwen2-1.5b', 'train_s', 'ep', 'multi', 'none', 'int8'): ((), _ABORT_GROUPS),
    ('qwen2-1.5b', 'train_s', 'ep', 'multi', 'none', 'bf16'): ((), _ABORT_GROUPS),
    ('internvl2-1b', 'train_s', 'dp', 'multi', 'none', 'bf16'): (('A1', 'A2'), _ABORT_COPY),
    ('internvl2-1b', 'train_s', 'fsdp', 'multi', 'none', 'int8'): ((), _ABORT_GROUPS),
    ('internvl2-1b', 'train_s', 'fsdp', 'multi', 'none', 'bf16'): ((), _ABORT_GROUPS),
    ('internvl2-1b', 'train_s', 'tp', 'multi', 'none', 'int8'): (('A1', 'A3'), _ABORT_GROUPS),
    ('internvl2-1b', 'train_s', 'tp', 'multi', 'none', 'bf16'): (('A1', 'A3'), _ABORT_GROUPS),
    ('internvl2-1b', 'train_s', 'ep', 'multi', 'none', 'int8'): (('A1', 'A3'), _ABORT_GROUPS),
    ('internvl2-1b', 'train_s', 'ep', 'multi', 'none', 'bf16'): (('A1', 'A3'), _ABORT_GROUPS),
    ('musicgen-medium', 'train_s', 'dp', 'multi', 'none', 'bf16'): ((), _ABORT_COPY),
    ('musicgen-medium', 'train_s', 'fsdp', 'multi', 'none', 'int8'): ((), _ABORT_GROUPS),
    ('musicgen-medium', 'train_s', 'fsdp', 'multi', 'none', 'bf16'): ((), _ABORT_GROUPS),
    ('musicgen-medium', 'train_s', 'tp', 'multi', 'none', 'int8'): (('A1',), _ABORT_GROUPS),
    ('musicgen-medium', 'train_s', 'tp', 'multi', 'none', 'bf16'): ((), _ABORT_GROUPS),
    ('musicgen-medium', 'train_s', 'ep', 'multi', 'none', 'int8'): (('A1',), _ABORT_GROUPS),
    ('musicgen-medium', 'train_s', 'ep', 'multi', 'none', 'bf16'): ((), _ABORT_GROUPS),
    ('qwen2-1.5b', 'train_s', 'fsdp', 'multi', 'dots', 'int8'): ((), _ABORT_GROUPS),
}


def reference_abort(preset: str, grad_compress: str):
    """The reference's abort at a compressed multi-mesh train point, or None
    where it measures (int8 under dp)."""
    if grad_compress == "none" or (preset, grad_compress) == ("dp", "int8"):
        return None
    return _ABORT_COPY if preset == "dp" else _ABORT_GROUPS


def expected_point_kinds(key) -> tuple:
    """The port's kinds at a ``grid_key``: the reference's, a listed
    difference's, or at a reference abort the port's own."""
    if key in POINT_KIND_DIFFERENCES:
        return POINT_KIND_DIFFERENCES[key][0]
    if key in REFERENCE_ABORTS:
        return REFERENCE_ABORTS[key][0]
    return POINT_REFERENCE[key][0]


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
        values = "" if c is None else ", " + ", ".join(
            f"{k.split('.')[1]} {c[k]:.5g}" + ("" if i not in fresh else f" [{fresh[i][k]:.5g}]")
            for k in ("perf.useful_flops_ratio", "perf.roofline_efficiency",
                      "diag.collective_blowup"))
        print(f"pair {i} {point_key(p)}: stored {row['stored']}, reference "
              f"{row.get('reference', 'not run')}, port {got}{values}", flush=True)
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
