"""How the port's measurement is held against the reference's, and where it
differs by construction (ROADMAP queue 3).

* Kinds, at the committed corpus's witnesses and controls that need no MoE
  (``corpus_points``): the port reports exactly the reference's kinds
  (``REFERENCE``), except at the points of ``KIND_DIFFERENCES``, each with
  both kind sets, the counter that decides, both values and the cause.  So a
  witness shows its entry's kind and a control does not, and any new
  difference fails.
* ``perf.useful_flops_ratio``: within ``USEFUL_RATIO_REL_BOUND`` of the
  reference's, except at the points of ``USEFUL_RATIO_DIFFERENCES``, each
  with both values (CPU trace and CPU compile) and its cause.
* Ops the trace runs replicated (DTensor refused to place them): only those
  of ``REPLICATED_OPS``, each with its cause.

``REFERENCE`` holds the reference's measurement (its XLA compile on the CPU,
32 host devices), so that ``chip_smoke.py --measure`` can hold the port to it
on the card, where the JAX package is not run; ``tests/test_torch_measure.py``
holds these values to a fresh run of the reference.
"""
from __future__ import annotations

import json

USEFUL_RATIO_REL_BOUND = 0.10

# (arch, shape, preset, mesh, remat) -> (port, reference, cause)
_HEADS = ("DTensor cannot split the 12 query heads as 2 KV groups x 6 over the "
          "4 model ranks (the reshape (B,S,12,32) -> (B,S,2,6,32) has no even "
          "placement), so the trace runs attention replicated on the model "
          "axis; XLA tiles (KV, G) jointly")
USEFUL_RATIO_DIFFERENCES = {
    ("qwen2-1.5b", "train_s", "tp", "single", "none"): (0.5357, 0.9055, _HEADS),
    ("qwen2-1.5b", "train_s", "tp", "single", "dots"): (0.4814, 0.8643, _HEADS),
    ("qwen2-1.5b", "train_s", "tp", "single", "full"): (0.4405, 0.7709, _HEADS),
    ("qwen2-1.5b", "train_s", "ep", "single", "none"): (0.5357, 0.9055, _HEADS),
    ("qwen2-1.5b", "train_s", "ep", "single", "dots"): (0.4814, 0.8643, _HEADS),
    ("qwen2-1.5b", "train_s", "ep", "single", "full"): (0.4405, 0.7709, _HEADS),
}

# ops the trace may run replicated -> why DTensor refuses to place them
REPLICATED_OPS = {
    "aten.view.default": _HEADS + " (tp and ep points only)",
    "prims.rev.default": ("torch 2.11's DTensor has no rule for flip (the cumsum "
                          "backward), which it decomposes to prims.rev on a one-rank "
                          "mesh: nothing is gathered"),
}


def corpus_key(p: dict, role: str) -> tuple:
    """A corpus point's key: its search point, its cache and vocab sharding
    and its role (two points of one entry may share the rest)."""
    return point_key(p) + (p["cache_shard"], p["vocab_shard"], role)


# corpus_key -> (the reference's kinds, its perf.useful_flops_ratio)
REFERENCE = {
    ("rwkv6-7b", "train_s", "fsdp", "single", "none", True, True, "witness"):
        (("A1",), 0.9439),
    ("qwen2-1.5b", "decode_s", "fsdp", "single", "none", False, True, "witness"):
        (("A3",), 0.4506),
    ("qwen2-1.5b", "decode_s", "fsdp", "single", "none", True, True, "control"): ((), 1.0005),
    ("qwen2-1.5b", "decode_s", "dp", "single", "none", False, True, "control"): ((), 1.0005),
    ("qwen2-1.5b", "decode_s", "dp", "multi", "none", True, True, "witness"):
        (("A3",), 0.5003),
    ("qwen2-1.5b", "decode_s", "dp", "single", "none", True, True, "control"): ((), 1.0005),
    ("qwen2-1.5b", "decode_s", "ep", "multi", "none", True, True, "control"): ((), 0.9521),
    ("qwen2-1.5b", "decode_s", "tp", "single", "none", True, False, "witness"):
        (("A3",), 0.5366),
    ("qwen2-1.5b", "decode_s", "fsdp", "single", "none", True, False, "control"): ((), 1.0005),
    ("qwen2-1.5b", "decode_s", "tp", "single", "none", True, True, "control"): ((), 0.9521),
}

# corpus_key -> (port kinds, reference kinds, counter, port value (CPU
# trace, torch 2.13), reference value (CPU compile), cause)
KIND_DIFFERENCES = {
    ("rwkv6-7b", "train_s", "fsdp", "single", "none", True, True, "witness"):
        (("A1", "A2"), ("A1",), "diag.collective_blowup", 11.58, 3.927,
         "the reference sits just under A2's 4.0; the trace's wire bytes are 2.9x "
         "XLA's: DTensor all-gathers the sequence-sharded activations before the "
         "time-mix products and the WKV, where XLA keeps them split"),
    ("qwen2-1.5b", "decode_s", "tp", "single", "none", True, False, "witness"):
        (("A1", "A3"), ("A3",), "perf.roofline_efficiency", 0.2291, 0.2740,
         "the reference sits just over A1's 0.25; the trace's bytes count every "
         "elementwise output (an eager trace has no fusion), which lowers the "
         "roofline efficiency of this memory-bound step"),
}


# qwen2-1.5b at train_4k on the 16x16 production mesh (fsdp, remat dots), the
# measure phase's full-width point: the port's own CPU trace (torch 2.13), as
# no reference value is taken at this size (XLA's compile for 256 host
# devices is not run).  The card's trace is held within the bound of it.
FULL_WIDTH_USEFUL = 0.8542


def point_key(p: dict) -> tuple:
    return (p["arch"], p["shape"], p["preset"], p["mesh"], p["remat"])


def corpus_points(path) -> list:
    """[(signature, kind, role, point)] of every live corpus entry that needs
    no MoE: its minimized witness ("witness") and its controls ("control")."""
    with open(path) as f:
        data = json.load(f)
    out = []
    for e in data["entries"]:
        if e.get("retired"):
            continue
        pts = [("witness", e["witness"])] + [("control", c) for c in e["controls"]]
        if any(p["arch"] in ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b") for _, p in pts):
            continue
        out += [(e["signature"], e["kind"], role, p) for role, p in pts]
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
    (or, at a listed difference, of the listed port value)."""
    listed = USEFUL_RATIO_DIFFERENCES.get(key)
    want = reference if listed is None else listed[0]
    return abs(port - want) <= USEFUL_RATIO_REL_BOUND * want
