"""ModelConfig: one dataclass describing every assigned architecture.

The port's copy of the JAX package's ``configs/base.py``: the dataclass
and its analytic ``n_params`` whole, with ``torch_dtype`` in place of
``jnp_dtype``, and the reference's ten archs: each ``configs/<arch>.py``
holds the published numbers and cites its source (``lda_paper.py`` is
the paper's own DELEDA setup, not an arch). ``smoke_variant`` shrinks a
config to a 2-layer, d_model<=256 float32 version for CPU tests, with
the reference's per-family updates. The dry run's ``INPUT_SHAPES`` wait
with the dry run.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|hybrid|ssm|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # attention
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    window: Optional[int] = None          # sliding-window size (local attn)
    local_global_pattern: bool = False    # gemma2: alternate window/full
    rope_theta: float = 10000.0
    query_scale: Optional[float] = None
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    act: str = "silu"
    mlp_gated: bool = True
    post_norms: bool = False              # gemma2 pre+post sandwich norms
    pos_embed: str = "rope"               # rope | learned
    tie_embed: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0           # kimi shared expert
    dense_residual_d_ff: int = 0          # arctic parallel dense MLP
    first_dense_layers: int = 0           # kimi: leading dense layers
    moe_impl: str = "ragged"              # ragged | capacity (see moe.py)
    moe_capacity_factor: float = 1.25

    # hybrid (zamba2) / ssm (xlstm)
    ssm_state: int = 0
    attn_every: int = 0                   # zamba2: shared attn every N
    slstm_every: int = 0                  # xlstm: sLSTM at i%k == k-1
    ssm_head_dim: int = 64
    conv_kernel: int = 4
    ssd_chunk: int = 256
    xlstm_chunk: int = 0                  # 0 = quadratic mLSTM (baseline)
    attn_chunk_q: int = 0                 # 0 = dense scores (baseline)

    # enc-dec (whisper)
    n_encoder_layers: int = 0
    max_source_len: int = 0               # precomputed frames (stub frontend)

    # vlm (pixtral)
    n_image_tokens: int = 0               # stub patch embeddings per example

    # numerics / compilation
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"            # full | dots | none
    scan_layers: bool = True
    optimizer: str = "adamw"              # adamw | adafactor (1T-scale)

    # which assigned input shapes run; long_500k only if sub-quadratic
    supports_long_context: bool = False
    decode_shapes: bool = True            # False for encoder-only archs

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]

    def n_params(self) -> int:
        """Analytic total parameter count (embedding + layers)."""
        d, hd = self.d_model, self.hd
        p = self.vocab_size * d                       # embedding (tied head)
        if not self.tie_embed:
            p += self.vocab_size * d
        attn = d * (self.n_heads + 2 * self.n_kv) * hd + self.n_heads * hd * d
        mlp = 3 * d * self.d_ff if self.mlp_gated else 2 * d * self.d_ff
        moe = (self.n_experts * 3 * d * self.moe_d_ff
               + d * self.n_experts
               + 3 * d * self.shared_expert_d_ff
               + 3 * d * self.dense_residual_d_ff)
        if self.family == "moe":
            n_moe = self.n_layers - self.first_dense_layers
            p += self.n_layers * attn + self.first_dense_layers * mlp \
                + n_moe * moe
        elif self.family == "hybrid":
            d_inner = 2 * d
            mamba = (d * (2 * d_inner + 2 * self.ssm_state
                          + d_inner // self.ssm_head_dim)
                     + d_inner * d)
            n_shared = self.n_layers // max(self.attn_every, 1)
            p += self.n_layers * mamba + (attn + mlp)  # shared block once
            del n_shared
        elif self.family == "ssm":
            d_inner = 2 * d
            mlstm = d * 2 * d_inner + 3 * d_inner * d_inner + d_inner * d
            slstm = 4 * d * d + 4 * d * d // self.n_heads \
                + 3 * d * int(4 * d / 3)
            n_s = self.n_layers // max(self.slstm_every, self.n_layers)
            p += (self.n_layers - n_s) * mlstm + n_s * slstm
        elif self.family == "encdec":
            p += self.n_encoder_layers * (attn + mlp)
            p += self.n_layers * (2 * attn + mlp)     # self + cross
        else:                                          # dense / vlm
            p += self.n_layers * (attn + mlp)
        return int(p)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        all_experts = (self.n_layers - self.first_dense_layers) \
            * self.n_experts * 3 * d * self.moe_d_ff
        active = (self.n_layers - self.first_dense_layers) \
            * self.top_k * 3 * d * self.moe_d_ff
        return int(full - all_experts + active)


ARCH_IDS = [
    "kimi_k2_1t_a32b", "arctic_480b", "whisper_small", "gemma2_2b",
    "gemma2_9b", "granite_3_8b", "pixtral_12b", "zamba2_2p7b", "qwen2_72b",
    "xlstm_125m",
]

_ALIASES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "arctic-480b": "arctic_480b",
    "whisper-small": "whisper_small",
    "gemma2-2b": "gemma2_2b",
    "gemma2-9b": "gemma2_9b",
    "granite-3-8b": "granite_3_8b",
    "pixtral-12b": "pixtral_12b",
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2-72b": "qwen2_72b",
    "xlstm-125m": "xlstm_125m",
}


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; archs: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """2 layers, d_model<=512, <=4 experts — the assigned smoke recipe."""
    d = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv, max(1, n_heads // 2))
    if cfg.n_kv == cfg.n_heads:
        n_kv = n_heads
    updates = dict(
        n_layers=2, d_model=d, n_heads=n_heads, n_kv=n_kv,
        head_dim=d // n_heads,
        d_ff=min(cfg.d_ff, 4 * d) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        dtype="float32", remat=False,
    )
    if cfg.family == "moe":
        updates.update(n_experts=4, top_k=min(cfg.top_k, 2),
                       moe_d_ff=min(cfg.moe_d_ff, 2 * d),
                       shared_expert_d_ff=min(cfg.shared_expert_d_ff, d),
                       dense_residual_d_ff=min(cfg.dense_residual_d_ff, d),
                       first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.family == "hybrid":
        updates.update(attn_every=2, ssm_state=min(cfg.ssm_state, 16),
                       ssm_head_dim=32, ssd_chunk=32)
    if cfg.family == "ssm":
        updates.update(slstm_every=2)
    if cfg.family == "encdec":
        updates.update(n_encoder_layers=2, max_source_len=64)
    if cfg.family == "vlm":
        updates.update(n_image_tokens=8)
    if cfg.window:
        updates.update(window=min(cfg.window, 16))
    return dataclasses.replace(cfg, **updates)
