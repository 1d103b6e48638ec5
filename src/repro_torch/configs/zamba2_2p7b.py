"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242].

54 Mamba2 layers (d_model=2560, ssm_state=64) with ONE shared
attention+MLP block (32H, kv=32 MHA, d_ff=10240) applied every 6 layers
(9 applications, shared weights). long_500k runs: SSM state is O(1) in L;
the shared attention decodes as a matvec over its cache.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    supports_long_context=True,
)
