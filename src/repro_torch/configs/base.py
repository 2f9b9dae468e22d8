"""Model / shape configuration registry (PyTorch port of ``repro.configs.base``).

Every field of the reference ``ModelConfig`` is kept, with the same
defaults, so a port config compares field for field with its reference;
only the two dtype fields hold ``torch`` dtypes instead of ``jnp`` ones.
``use_pallas`` is kept too and, as in the reference, nothing reads it: the
port's attention launches its CUDA kernel whenever its tensors lie on the
card (``repro_torch.kernels.flash_attention.ops``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    activation: str = "silu"
    glu: bool = True
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    pos_embed: str = "rope"      # rope | learned | none
    qk_norm: bool = False
    softmax_scale: Optional[float] = None
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    tie_embeddings: bool = True
    embed_scale: bool = False    # gemma-style sqrt(d_model) embedding scale

    # attention pattern
    local_window: int = 0        # >0: local (sliding window) attention layers
    global_every: int = 0        # 0: all global; N: every Nth layer is global
    max_position: int = 1 << 20

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 0

    # MLA
    use_mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2)
    d_state: int = 0
    ssm_headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # hybrid (recurrentgemma)
    lru_width: int = 0
    pattern_rec: int = 0
    gate_blocks: int = 0

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500

    # vlm (paligemma)
    n_prefix: int = 0

    # numerics / execution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    attn_chunk: int = 1024       # the reference's XLA scan chunk; unread here
    remat: str = "full"          # none | full | dots
    scan_layers: bool = True
    use_pallas: bool = False     # declared, never read (as in the reference)

    opt_bf16_probs: bool = False
    opt_ce_chunk: int = 0
    opt_gate_bf16: bool = False

    # metadata
    source: str = ""
    domain: str = "NLP"

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_kind(self, i: int) -> str:
        """'global' | 'local' attention for layer i (LM archs)."""
        if self.local_window <= 0:
            return "global"
        if self.global_every <= 0:
            return "local"
        return "global" if (i % self.global_every == self.global_every - 1) else "local"

    def reduced(self, **kw) -> "ModelConfig":
        """Tiny same-family variant for CPU tests and measured benches."""
        small = dict(
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 6),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=32,
            d_ff=256,
            vocab=512,
            attn_chunk=64,
            max_position=4096,
        )
        if self.n_experts:
            small.update(n_experts=4, top_k=min(self.top_k, 2), d_ff_expert=64,
                         n_shared_experts=min(self.n_shared_experts, 1),
                         first_dense_layers=min(self.first_dense_layers, 1))
        if self.use_mla:
            small.update(kv_lora=32, q_lora=48, qk_nope_dim=16, qk_rope_dim=16,
                         v_head_dim=16, head_dim=32)
        if self.d_state:
            small.update(d_state=16, ssm_headdim=16, ssm_chunk=32)
        if self.lru_width:
            small.update(lru_width=128)
        if self.local_window:
            small.update(local_window=64)
        if self.global_every:
            small.update(global_every=2)
        if self.n_enc_layers:
            small.update(n_enc_layers=2, enc_seq=32)
        if self.n_prefix:
            small.update(n_prefix=8)
        small.update(kw)
        return dataclasses.replace(self, name=self.name + "-reduced", **small)


ARCHS: Dict[str, ModelConfig] = {}

# Which archs run the long_500k cell (sub-quadratic / bounded-cache only).
LONG_CONTEXT_ARCHS = {"mamba2-2.7b", "recurrentgemma-9b", "gemma3-12b", "mixtral-8x7b"}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)} (the "
                       f"other archs come with their families, ROADMAP Queue 1)")
    return ARCHS[name]


def list_archs() -> Tuple[str, ...]:
    return tuple(sorted(ARCHS))


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason-if-not) for an (arch, shape) cell."""
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: 512k dense KV decode skipped (DESIGN.md)"
    return True, ""
