"""The slice as a whole: the port's ServingEngine against the JAX package's.

Same weights (carried across with ``api.from_numpy_params``), same prompts,
temperature 0, f32: every request must produce the same tokens and the
engines the same ``stats``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.all_archs import smoke_config as ref_smoke
from repro.configs.base import RunPolicy as RefPolicy
from repro.models import api as ref_api
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import RunPolicy
from repro_torch.models import api
from repro_torch.serve import __main__ as serve_cli
from repro_torch.serve.engine import Request, ServingEngine, sample_logits


def _prompts(vocab, n=7):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(rng.choice([5, 9, 16]))).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def reference_run():
    cfg = ref_smoke("qwen2-1.5b")
    params = ref_api.init(cfg, jax.random.PRNGKey(0))
    eng = RefEngine(cfg, RefPolicy(remat="none", dtype="f32"), params,
                    n_slots=3, cache_len=32, temperature=0.0)
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        eng.add_request(RefRequest(rid=i, prompt=p, max_new_tokens=6 + i % 3))
    done = eng.run()
    return jax.tree.map(np.asarray, params), {r.rid: r.out for r in done}, eng.stats


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_matches_reference(reference_run, use_pallas):
    tree, ref_out, ref_stats = reference_run
    cfg = smoke_config("qwen2-1.5b")
    params = api.from_numpy_params(cfg, tree, "cpu")
    eng = ServingEngine(cfg, RunPolicy(remat="none", dtype="f32", use_pallas=use_pallas),
                        params, n_slots=3, cache_len=32, temperature=0.0, device="cpu")
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=6 + i % 3))
    done = eng.run()
    assert {r.rid: r.out for r in done} == ref_out
    assert eng.stats == ref_stats
    assert all(r.done for r in done)


def test_sampling_is_seeded():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    a = sample_logits(logits, torch.Generator().manual_seed(3), temperature=0.8)
    b = sample_logits(logits, torch.Generator().manual_seed(3), temperature=0.8)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert torch.equal(sample_logits(logits, None, 0.0), logits.argmax(-1).int())


def test_cuda_requested_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: asking for cuda is valid here")
    cfg = smoke_config("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="no GPU"):
        api.init(cfg, seed=0)
    params = api.init(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no GPU"):
        ServingEngine(cfg, RunPolicy(), params)


def test_serve_cli_on_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--arch", "qwen2-1.5b", "--requests", "3",
                    "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.startswith("3 requests, 9 tokens")     # 3 x (4 - the prefill's token)
    assert "3 prefills" in out
