"""Config system: the port's own copy of `repro.configs.base`.

`ModelConfig` and `MoEConfig` keep the reference's fields and defaults
so a config built here describes exactly the model the JAX package
builds.  Only the architectures the port serves resolve; the rest of the
reference registry raises until its slice lands.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Fine-grained MoE settings (paper §3.2.1–3.2.2)."""

    n_experts: int                 # routed experts (fine-grained)
    top_k: int                     # experts activated per token
    expert_d_ff: int               # intermediate size of each routed expert
    n_shared_experts: int = 0      # always-on shared experts (Eq. 2)
    shared_d_ff: Optional[int] = None  # defaults to expert_d_ff * n_shared
    capacity_factor: float = 2.0   # EP-path buffer headroom (dropless path ignores)
    dispatch: str = "auto"         # per-arch dispatch preference
    balance_loss_coef: float = 0.015   # paper §3.4.1
    z_loss_coef: float = 1e-4          # paper §3.4.1
    router_warmup_steps: int = 100     # stochastic routing warmup W (Eq. 3)
    first_dense_layers: int = 0    # leading layers that use a dense FFN

    @property
    def shared_ff(self) -> int:
        if self.shared_d_ff is not None:
            return self.shared_d_ff
        return self.expert_d_ff * max(self.n_shared_experts, 1)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A composable decoder transformer description (reference fields)."""

    arch_id: str
    family: str
    source: str

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None     # defaults to d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    attn_window: Optional[int] = None
    mlp_act: str = "swiglu"            # swiglu | geglu | squared_relu | gelu
    norm_type: str = "rmsnorm"         # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    use_rope: bool = True
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    norm_head: bool = True             # paper §3.2.3 NormHead (C4)

    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0
    early_fusion_vlm: bool = False
    rwkv_head_dim: int = 64

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    @property
    def uniform_blocks(self) -> bool:
        return len(set(self.block_pattern)) == 1


# The reference registry; `PORTED` is the subset whose configs resolve here
# (h2o-danube-1.8b only as a speculative drafter's source config: its
# "swa" blocks are not built as a model).
ARCH_IDS = [
    "phi3-mini-3.8b",
    "rwkv6-3b",
    "chameleon-34b",
    "h2o-danube-1.8b",
    "deepseek-moe-16b",
    "granite-moe-3b-a800m",
    "moonshot-v1-16b-a3b",
    "whisper-tiny",
    "recurrentgemma-2b",
    "nemotron-4-15b",
    "ling-lite",
    "ling-plus",
]
PORTED = ("ling-lite", "rwkv6-3b", "h2o-danube-1.8b")

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULE_FOR)}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not yet ported to repro_torch "
            f"(ported: {list(PORTED)})")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULE_FOR[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    return _module(arch_id).smoke_config()
