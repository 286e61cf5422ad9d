"""Model / shape / run-policy configuration dataclasses + registry."""
from __future__ import annotations

import dataclasses

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int                      # query heads (rwkv: wkv heads)
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # attention
    qkv_bias: bool = False
    window: int | None = None         # sliding-window size
    rope_theta: float = 1e6
    use_rope: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # layer pattern; repeated to fill n_layers (tail truncates)
    block_pattern: tuple = ("attn",)
    rec_width: int = 0                # RG-LRU width
    head_size: int = 0                # rwkv head size
    norm: str = "rmsnorm"
    act: str = "silu"
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma-style sqrt(d) embedding scale
    logit_softcap: float | None = None
    frontend: str | None = None       # None | 'vit' | 'encodec'
    n_prefix: int = 0                 # vlm: # patch-embedding prefix tokens
    d_frontend: int = 0
    n_codebooks: int = 0              # audio: parallel codebooks

    @property
    def attn_free(self) -> bool:
        return "attn" not in self.block_pattern

    @property
    def subquadratic(self) -> bool:
        return self.attn_free or self.window is not None


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class RunPolicy:
    """Execution policy — these fields ARE the Collie search dimensions D1-D3."""
    sharding_preset: str = "fsdp"     # fsdp | tp | ep | dp
    rule_overrides: tuple = ()        # ((axis, ((mesh axes),...)), ...)
    remat: str = "dots"               # none | dots | full
    n_microbatch: int = 1
    scan_layers: bool = True
    attn_impl: str = "auto"           # auto | plain | blocked | local
    dtype: str = "bf16"               # bf16 | f32
    params_f32: bool = True           # keep params f32, compute bf16
    zero1: bool = True                # shard optimizer state over data axis
    optimizer: str = "adamw"          # adamw | adafactor | sgdm
    grad_compress: str = "none"       # none | bf16 | int8 (cross-pod)
    use_pallas: bool = False          # CUDA kernels (plain path on CPU)
    capacity_factor: float = 1.25

    def rules_dict(self):
        from ..launch.sharding import make_rules
        return make_rules(self.sharding_preset,
                          **{k: list(v) for k, v in self.rule_overrides})


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        from . import all_archs  # noqa: F401  (populates registry)
    return _REGISTRY[name]


def list_archs():
    if not _REGISTRY:
        from . import all_archs  # noqa: F401
    return sorted(_REGISTRY)


def default_preset(cfg: ModelConfig) -> str:
    """Paper-faithful default sharding preset per architecture family/size."""
    if cfg.n_experts:
        return "ep"
    n_params_rough = cfg.n_layers * cfg.d_model * cfg.d_model * 12
    if n_params_rough > 8e9:
        return "tp"
    return "fsdp"
