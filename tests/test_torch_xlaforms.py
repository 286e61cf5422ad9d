"""The measurement's trace forms (``repro_torch.launch.xlaforms``) and its
DTensor hooks (``launch.traceanalysis``), on real CPU tensors.

* ``dot_general`` computes ``einsum`` and its gradients, and the rewrites of
  ``XlaForms`` leave every value as torch's own ops give it;
* a rematerialised unit's recompute runs under the forward's function modes;
* the propagation hook runs an op replicated only for the listed refusals
  (an uneven split, no strategy) and lets every other error through.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.base import RunPolicy
from repro_torch.launch import traceanalysis, xlaforms
from repro_torch.models import transformer as tfm


def _t(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


@pytest.mark.parametrize("eqn,sa,sb", [
    ("ij,jk->ik", (5, 7), (7, 3)),
    ("bsd,dn->bsn", (2, 5, 7), (7, 4)),
    ("bqkgd,btkd->bkgqt", (2, 3, 2, 3, 4), (2, 5, 2, 4)),
    ("bkgqt,btkd->bqkgd", (2, 2, 3, 3, 5), (2, 5, 2, 4)),
    ("bthk,bthk->bth", (2, 3, 4, 5), (2, 3, 4, 5)),
])
def test_dot_general_matches_einsum_and_its_gradients(eqn, sa, sb):
    a, b = _t(*sa, seed=1).requires_grad_(), _t(*sb, seed=2).requires_grad_()
    a2, b2 = a.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    got = xlaforms.dot_general(a, b, eqn)
    want = torch.einsum(eqn, a2, b2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    g = _t(*want.shape, seed=3)
    got.backward(g)
    want.backward(g)
    torch.testing.assert_close(a.grad, a2.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b.grad, b2.grad, rtol=1e-5, atol=1e-5)


def test_rewrites_keep_values():
    x, w, w3 = _t(2, 5, 7, seed=1), _t(7, 4, seed=2), _t(2, 7, 4, seed=3)
    table, idx = _t(11, 6, seed=4), torch.tensor([[3, 0], [10, 3]])
    calls = lambda: [x @ w, torch.matmul(x, w3), torch.einsum("...d,dn->...n", x, w),
                     table[idx], torch.log_softmax(x, dim=-1),
                     torch.gather(x, -1, torch.zeros(2, 5, 1, dtype=torch.long)),
                     F.pad(x, (1, 2))]
    want = calls()
    with xlaforms.XlaForms():
        got = calls()
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


def test_equations_dot_general_does_not_take_run_as_einsum():
    a, b = _t(3, 3), _t(3, 4)
    assert xlaforms._as_eqn("ii,ij->j", a, b) is None        # a repeated letter
    assert xlaforms._as_eqn("ik,jl->ij", a, b) is None        # a letter summed alone
    assert xlaforms._as_eqn("ij,jk->ik", a, _t(4, 4)) is None  # sizes disagree
    assert xlaforms._as_eqn("...j,jk->...k", a, b) == "aj,jk->ak"


def test_remat_recompute_runs_under_the_forward_function_modes():
    seen = []

    class Count(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.matmul:
                seen.append(torch._C._current_graph_task_id() != -1)
            return func(*args, **(kwargs or {}))

    w = _t(4, 4, seed=1).requires_grad_()
    unit = tfm._remat_wrap(lambda x: torch.tanh(x @ w), RunPolicy(remat="full"))
    with Count():
        unit(_t(2, 4, seed=2)).sum().backward()
    assert seen == [False, True]          # the forward, then its recompute


class _Schema:
    op = torch.ops.aten.view.default


def test_propagation_hook_lets_unlisted_errors_through():
    rec = traceanalysis.Recorder(fake_mode=None)

    def refuse(exc):
        def propagate(schema):
            raise exc
        return traceanalysis._replicating(propagate, rec)

    with pytest.raises(RuntimeError, match="something else"):
        refuse(RuntimeError("something else"))(_Schema())
    with pytest.raises(AssertionError):
        refuse(AssertionError("Shard dim -1 must be normalized"))(_Schema())
    with pytest.raises(NotImplementedError, match="not yet"):
        refuse(NotImplementedError("not yet"))(_Schema())
    assert rec.replicated == {}
