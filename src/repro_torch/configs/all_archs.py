"""The 10 assigned architectures (public-literature configs) + reduced smokes.

Every entry is registered as a selectable ``--arch <id>`` config.  Sources are
in the docstrings; dims follow the assignment sheet exactly.
"""
from __future__ import annotations

import dataclasses

from .base import ModelConfig, register

# -- dense GQA decoders -------------------------------------------------------

QWEN2_1_5B = register(ModelConfig(
    # [arXiv:2407.10671] GQA with QKV bias, tied embeddings.
    name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_head=128, d_ff=8960, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True))

TINYLLAMA_1_1B = register(ModelConfig(
    # [arXiv:2401.02385] llama2-arch small.
    name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
    n_heads=32, n_kv_heads=4, d_head=64, d_ff=5632, vocab_size=32000,
    rope_theta=1e4))

INTERNLM2_20B = register(ModelConfig(
    # [arXiv:2403.17297] GQA.
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_head=128, d_ff=16384, vocab_size=92544,
    rope_theta=1e6))

DEEPSEEK_67B = register(ModelConfig(
    # [arXiv:2401.02954] llama-arch, GQA kv=8.
    name="deepseek-67b", family="dense", n_layers=95, d_model=8192,
    n_heads=64, n_kv_heads=8, d_head=128, d_ff=22016, vocab_size=102400,
    rope_theta=1e4))

# -- VLM (backbone only; ViT frontend stubbed per assignment) ----------------

INTERNVL2_1B = register(ModelConfig(
    # [arXiv:2404.16821] InternViT-300M + Qwen2-0.5B backbone.
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_head=64, d_ff=4864, vocab_size=151655,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    frontend="vit", n_prefix=256, d_frontend=1024))

# -- MoE ----------------------------------------------------------------------

PHI35_MOE = register(ModelConfig(
    # [hf:microsoft/Phi-3.5-MoE-instruct] 16 experts top-2, 42B total/6.6B active.
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_head=128, d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2, rope_theta=1e4))

MIXTRAL_8X7B = register(ModelConfig(
    # [arXiv:2401.04088] 8 experts top-2, sliding-window attention.
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_head=128, d_ff=14336, vocab_size=32000,
    n_experts=8, top_k=2, window=4096, rope_theta=1e6))

# -- audio (decoder-only over EnCodec tokens; codec stubbed) -----------------

MUSICGEN_MEDIUM = register(ModelConfig(
    # [arXiv:2306.05284] 4 parallel codebooks (delay pattern), MHA (kv=24).
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_head=64, d_ff=6144, vocab_size=2048,
    norm="layernorm", act="gelu", use_rope=False,
    frontend="encodec", n_codebooks=4))

# -- hybrid: RG-LRU + local attention 1:2 ------------------------------------

RECURRENTGEMMA_2B = register(ModelConfig(
    # [arXiv:2402.19427] Griffin: 2 recurrent blocks per 1 local-attn block.
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_head=256, d_ff=7680, vocab_size=256000,
    block_pattern=("rec", "rec", "attn"), rec_width=2560, window=2048,
    act="gelu", tie_embeddings=True, embed_scale=True, logit_softcap=30.0,
    rope_theta=1e4))

# -- attention-free SSM -------------------------------------------------------

RWKV6_7B = register(ModelConfig(
    # [arXiv:2404.05892] Finch: data-dependent decay, 64 heads of size 64.
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=0, d_head=64, d_ff=14336, vocab_size=65536,
    block_pattern=("rwkv",), head_size=64, norm="layernorm", use_rope=False))


# -- reduced smoke variants (same family shape, tiny dims) --------------------

def smoke_config(name: str) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests."""
    from .base import get_config
    cfg = get_config(name)
    small = dict(
        n_layers=max(2, len(cfg.block_pattern)), d_model=64, d_ff=128,
        vocab_size=256)
    if cfg.family == "moe":
        small.update(n_experts=4, top_k=2)
    if cfg.attn_free:
        small.update(n_heads=2, n_kv_heads=0, d_head=32, head_size=32)
    else:
        kv = max(1, min(cfg.n_kv_heads, 2))
        heads = max(kv, 4 if cfg.n_heads % 2 == 0 else 3)
        heads = heads - (heads % kv)
        small.update(n_heads=heads, n_kv_heads=kv, d_head=16)
    if cfg.rec_width:
        small.update(rec_width=64, n_heads=2, n_kv_heads=1, d_head=32)
    if cfg.window:
        small.update(window=16)
    if cfg.frontend == "vit":
        small.update(n_prefix=8, d_frontend=32)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
