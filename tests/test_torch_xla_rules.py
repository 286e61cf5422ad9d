"""The trace's model of XLA held against XLA itself.

* The fusion rule for a producer that reads more bytes than it writes (an
  ``add`` of several tensors) read by several fusions
  (``repro_torch.launch.traceanalysis.fusion_groups``): XLA's CPU pipeline
  duplicates it into each consumer where it fuses into all of them on all
  paths (elementwise ops, a product's layout copy, a reduction over at most
  32 elements) and writes it once where one refuses it (a product that
  takes its layout, a reduction that its tree-reduction rewrite splits into
  a reduce-window).  Each case compiles a small JAX function on the CPU and
  traces its torch counterpart on fake tensors; the port's bytes are held
  within 0.85-1.15x of ``hloanalysis.analyze``'s (the bounds of the fixture
  cells), and the duplication itself is checked on the port's groups.  The
  transpose of rwkv6's five-way split (``rwkv6.split_streams`` in the
  trace's form, ``xlaforms._Streams``) read by ``_ddlerp``'s backward is one
  case: five pads written once, their sum computed again by each of the
  five consumers, as XLA does.
* The collectives of rwkv6's time-mix backward under the fsdp corpus
  witness's sharding (the single bench mesh, the sequence sharded over the
  model axis), at two layers of the bench config: XLA all-to-alls the pads
  of the three streams the WKV reads whole, 2.62 MB each a layer, as the
  trace now records them (``xlaforms._Streams``), and the step's wire of
  all-to-alls, and of all-gathers and all-to-alls together (the backward's
  re-gathers of the chunked streams and of the streams' gradients), is
  held within 0.85-1.15x of the reference's (``tests/reference_counters.py
  --wire``, in a subprocess with 32 host devices).  The all-gathers alone
  are not held: outside the layer loop the port gathers the vocab-sharded
  tables' rows where XLA gathers the tables whole (7-8 MB of wire at every
  depth).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch import hloanalysis
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.searchspace import SearchSpace
from repro_torch.launch import traceanalysis as ta
from repro_torch.launch import xlaforms
from repro_torch.launch.steps import build_cell
from repro_torch.models import rwkv6

ROOT = pathlib.Path(__file__).resolve().parents[1]
BOUNDS = (0.85, 1.15)

WITNESS = {"arch": "rwkv6-7b", "attn_impl": "auto", "cache_shard": True,
           "capacity_factor": 1.25, "grad_compress": "none", "mesh": "single",
           "n_microbatch": 1, "optimizer": "adamw", "params_f32": True, "preset": "fsdp",
           "remat": "none", "scan_layers": True, "seq_shard": True, "shape": "train_s",
           "vocab_shard": True, "zero1": True}
LAYERS = 2


def _xla_bytes(fn, shapes) -> float:
    args = [jnp.zeros(s, jnp.float32) for s in shapes]
    return hloanalysis.analyze(jax.jit(fn).lower(*args).compile().as_text())["bytes_hbm"]


def _port_groups(fn, shapes, grads=0):
    """(groups, records) of ``fn`` traced on fake f32 tensors; the last
    ``grads`` shapes are the cotangents of ``fn``'s outputs, whose vector-
    Jacobian product against the inputs ``_WRT`` the trace computes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode()
    with fake:
        args = [torch.empty(s, requires_grad=grads > 0 and i in _WRT) for i, s in enumerate(shapes)]
    rec = ta.Recorder(fake)
    arg_ids = {rec.id_of(a) for a in args}
    with fake, rec, xlaforms.XlaForms():
        if grads:
            out = torch.autograd.grad(fn(*args[:-grads]), [args[i] for i in _WRT], args[-grads:])
        else:
            out = fn(*args)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return ta.fusion_groups(rec.records, {rec.id_of(o) for o in outs}, arg_ids), rec.records


def _written_sum(groups, records) -> bool:
    """Whether a fusion of the sum's ``add`` chain alone is written (the sum
    written once), rather than the chain computed in each consumer."""
    return any(g[0] == "fuse" and all(records[k]["op"] == "aten.add.Tensor" for k in g[1])
               for g in groups)


N, M = 256, 512


def _split(x, xx, mu_x, mu, lora_A, lora_B):
    p = {"mu_x": mu_x, "mu": mu, "lora_A": lora_A, "lora_B": lora_B}
    return rwkv6.split_streams(rwkv6._ddlerp(p, x, xx))


def _ref_split_vjp(x, xx, mu_x, mu, lora_A, lora_B, *gs):
    """The transpose of the reference's five slices of ``_ddlerp``'s output
    (rwkv6.py's ``[mixed[:, :, i] for i in range(5)]``)."""
    def f(x, mu, lora_B):
        p = {"mu_x": mu_x, "mu": mu, "lora_A": lora_A, "lora_B": lora_B}
        m = ref_rwkv6._ddlerp(p, x, xx)
        return [m[:, :, i] for i in range(5)]
    return jax.vjp(f, x, mu, lora_B)[1](list(gs))


_B, _S, _D = 4, 64, 128
_WRT = (0, 3, 5)             # x, mu, lora_B: the vjp's inputs
_SPLIT = [(_B, _S, _D), (_B, _S, _D), (_D,), (5, _D), (_D, 5 * 32), (5, 32, _D)] \
    + [(_B, _S, _D)] * 5

# name -> (JAX function, torch function, shapes, the cotangents among them,
# whether XLA duplicates the sum)
CASES = {
    "elementwise": (lambda a, b, c, d, e, w: (lambda s: (jnp.tanh(s * w), jnp.exp(s * 2.0)))(
        a + b + c + d + e), lambda a, b, c, d, e, w: (lambda s: (torch.tanh(s * w), torch.exp(
            s * 2.0)))(a + b + c + d + e), [(N, M)] * 6, 0, True),
    "product": (lambda a, b, w: (lambda s: (jnp.tanh(s * 2.0), s @ w))(a + b),
                lambda a, b, w: (lambda s: (torch.tanh(s * 2.0), s @ w))(a + b),
                [(N, M), (N, M), (M, 64)], 0, False),
    "product_copy": (lambda a, b, w: (lambda s: (jnp.tanh(s * 2.0), jnp.einsum(
        "bfd,bfl->fdl", s, w)))(a + b), lambda a, b, w: (lambda s: (torch.tanh(s * 2.0), torch.einsum(
            "bfd,bfl->fdl", s, w)))(a + b), [(256, 5, 256), (256, 5, 256), (256, 5, 32)], 0, True),
    "wide_reduction": (lambda a, b: (lambda s: (s.sum(1), s.max(1)))(a + b),
                       lambda a, b: (lambda s: (s.sum(1), s.amax(1)))(a + b),
                       [(64, 64, 256)] * 2, 0, False),
    "narrow_reduction": (lambda a, b: (lambda s: (s.sum(1), s.max(1)))(a + b),
                         lambda a, b: (lambda s: (s.sum(1), s.amax(1)))(a + b),
                         [(64, 5, 256)] * 2, 0, True),
    "split_transpose": (_ref_split_vjp, _split, _SPLIT, 5, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_duplication_rule_follows_xla(name):
    jfn, tfn, shapes, grads, duplicated = CASES[name]
    want = _xla_bytes(jfn, shapes)
    groups, records = _port_groups(tfn, shapes, grads)
    got = sum(g[2] + g[3] for g in groups)
    assert BOUNDS[0] <= got / want <= BOUNDS[1], (got, want)
    assert _written_sum(groups, records) is not duplicated
    if name == "split_transpose":
        # five pads, each written by its own fusion, and five fusions that
        # compute their sum again (each reads all five)
        pads = [g for g in groups if [records[k]["op"] for k in g[1]] ==
                ["aten.constant_pad_nd.default"]]
        sums = [g for g in groups if sum(records[k]["op"].startswith("aten.add.Tensor")
                                         for k in g[1]) >= 4]
        assert len(pads) == 5 and len(sums) == 5


@pytest.fixture(scope="module")
def reference_wire(tmp_path_factory):
    """The reference's collectives at the witness's cell cut to LAYERS
    layers, run in a subprocess (started at once; the port traces
    meanwhile)."""
    spec = tmp_path_factory.mktemp("wire") / "spec.json"
    spec.write_text(json.dumps([WITNESS, LAYERS, 256, 32]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=32",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "reference_counters.py"),
                             "--wire", str(spec)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)

    def result():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        return json.loads(out.strip().splitlines()[-1])
    return result


def test_the_rwkv6_backward_collectives_follow_xla(reference_wire):
    space = SearchSpace(bench_archs(["rwkv6-7b"]), BENCH_SHAPES)
    cfg, shape, policy, mk = space.to_run(space.normalize(WITNESS))
    cell = build_cell(dataclasses.replace(cfg, n_layers=LAYERS), shape, policy,
                      bench_meshes()[mk])
    trace = cell.trace("cpu")
    port = trace.analyze()["collective_wire"]
    ref = reference_wire()
    # the backward layer body's all-to-alls of the stream pads (1 MB and
    # more at f32), a layer: the reference's loop body that runs them
    body = next(ops for mult, ops in ref["loops"] if any(k == "all-to-all" for k, _ in ops))
    want = sorted(nb for kind, nb in body if kind == "all-to-all" and nb >= 2 ** 20)
    f32 = lambda shape, dtype: ta._nbytes_of(shape, dtype) * (2 if dtype in ta._NARROW else 1)
    got = sorted(f32(*r["in"][0]) for r in trace.records
                 if r["phase"] == "G" and r.get("coll") == "all-to-all"
                 and f32(*r["in"][0]) >= 2 ** 20)
    assert got == want * LAYERS and len(want) == 3, (got, want)
    ratio = port["all-to-all"] / ref["collective_wire"]["all-to-all"]
    assert BOUNDS[0] <= ratio <= BOUNDS[1], (port, ref["collective_wire"])
    both = lambda w: w.get("all-gather", 0) + w["all-to-all"]
    ratio = both(port) / both(ref["collective_wire"])
    assert BOUNDS[0] <= ratio <= BOUNDS[1], (port, ref["collective_wire"])
