"""Config system: the port's own copy of `repro.configs.base`.

`ModelConfig` and `MoEConfig` keep the reference's fields and defaults
so a config built here describes exactly the model the JAX package
builds.  Every architecture of the reference registry resolves.  The
analytic parameter counts and the assigned input shapes (`INPUT_SHAPES`,
`supported_shapes`) are the reference's too: the dry run
(`launch.dryrun`) reads them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Sequence, Tuple


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
    """A composable decoder (or encoder-decoder) transformer description
    (reference fields).  Block kinds, cycled over layers: "attn" (causal
    self attention), "swa" (sliding window of `attn_window`), "rglru"
    (RG-LRU recurrent block), "rwkv" (RWKV6 time mix)."""

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

    @property
    def sub_quadratic(self) -> bool:
        """True if no block requires O(S^2) full attention (long_500k gate)."""
        return all(k != "attn" for k in self.block_pattern)

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings included once)."""
        d, v = self.d_model, self.vocab_size
        hd = self.head_dim
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # lm head
        enc = 0
        if self.is_encoder_decoder:
            enc = self.encoder_layers * (
                (self.n_heads + 2 * self.n_kv_heads) * hd * d + self.n_heads * hd * d
                + self._mlp_params(self.d_ff) + 2 * d)
            # decoder cross attention
            n += self.n_layers * ((self.n_heads + 2 * self.n_kv_heads) * hd * d
                                  + self.n_heads * hd * d + d)
        for layer in range(self.n_layers):
            kind = self.block_kind(layer)
            if kind in ("attn", "swa"):
                n += (self.n_heads + 2 * self.n_kv_heads) * hd * d
                n += self.n_heads * hd * d
            elif kind == "rglru":
                dr = _rglru_dim(d)
                n += 2 * d * dr + dr * d + 3 * dr + 2 * dr * (dr // _RGLRU_BLOCKS)
            elif kind == "rwkv":
                nh = d // self.rwkv_head_dim
                n += 4 * d * d + d * nh * self.rwkv_head_dim  # r,k,v,o,g approx
                n += 2 * (d * 32 + 32 * d)  # lora-style decay/mix
            n += self._ffn_params(layer)
            n += 2 * d  # norms
        return n + enc

    def _mlp_params(self, ff: int) -> int:
        mult = 3 if self.mlp_act == "swiglu" else 2
        return mult * self.d_model * ff

    def _ffn_params(self, layer: int) -> int:
        if self.moe is None or layer < self.moe.first_dense_layers:
            return self._mlp_params(self.d_ff)
        m = self.moe
        n = m.n_experts * self._mlp_params(m.expert_d_ff)
        if m.n_shared_experts:
            n += self._mlp_params(m.shared_ff)
        n += self.d_model * m.n_experts  # router
        return n

    def active_param_count(self) -> int:
        """Parameters activated per token (MoE: top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full_moe_layers = self.n_layers - m.first_dense_layers
        inactive = full_moe_layers * (m.n_experts - m.top_k) * self._mlp_params(m.expert_d_ff)
        return self.param_count() - inactive


# the analytic counts' RG-LRU width: RecurrentGemma's RNN width taken as
# d_model, one gate block (the reference's count, not the model's
# N_BLOCKS-way block-diagonal gates)
_RGLRU_BLOCKS = 1


def _rglru_dim(d_model: int) -> int:
    """RecurrentGemma uses an RNN width slightly larger than d_model."""
    return d_model


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape: a train step, a prefill or a decode
    tick of `global_batch` sequences of `seq_len` positions."""
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# The reference registry; `PORTED` is the subset whose configs resolve
# here: all of it.
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
PORTED = tuple(ARCH_IDS)

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULE_FOR)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULE_FOR[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def cut_depth(cfg: ModelConfig, n_layers: Optional[int]) -> ModelConfig:
    """`cfg` at full width with only its first `n_layers` layers (None:
    all of them): the one form of the depth cut that lets a wide model
    fit one card (Ling-Plus's 80 layers need ~567 GB; 8 take ~62 GB)."""
    if n_layers is None:
        return cfg
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"{cfg.arch_id}: cannot serve {n_layers} of its "
                         f"{cfg.n_layers} layers")
    return dataclasses.replace(cfg, n_layers=n_layers)


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    return _module(arch_id).smoke_config()


def supported_shapes(cfg: ModelConfig) -> Sequence[str]:
    """long_500k only for sub-quadratic (SSM / hybrid / SWA) architectures."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic or all(k in ("swa", "rglru", "rwkv") for k in cfg.block_pattern):
        out.append("long_500k")
    return out
