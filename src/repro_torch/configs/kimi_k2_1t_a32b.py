"""kimi-k2-1t-a32b [moe] — Kimi K2, trillion-param MoE [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) vocab=163840; MoE 384 experts top-8 with
expert d_ff=2048, one shared expert, first layer dense (DeepSeek-V3-style
layout). head_dim=128 (explicit, K2 card). Adafactor at this scale.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=18432,                 # the leading dense layer's FFN
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    moe_d_ff=2048,
    shared_expert_d_ff=2048,
    first_dense_layers=1,
    moe_impl="capacity",        # SPerf E1: 76x compute vs ragged_dot

    rope_theta=1_000_000.0,
    optimizer="adafactor",
    supports_long_context=False,
)
