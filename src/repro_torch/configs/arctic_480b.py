"""arctic-480b [moe] — Snowflake Arctic [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) vocab=32000; dense-MoE hybrid: every layer
has a parallel dense residual MLP (d_ff=4864) + 128-expert top-2 MoE.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual_d_ff=4864,
    moe_impl="capacity",        # SPerf E1
    attn_chunk_q=2048,          # SPerf E3: 153x memory at prefill_32k

    rope_theta=10000.0,
    optimizer="adafactor",
    supports_long_context=False,
)
