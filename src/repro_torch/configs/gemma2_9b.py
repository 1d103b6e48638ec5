"""gemma2-9b [dense] — local+global alternating, softcaps [arXiv:2408.00118].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000, head_dim=256.
Same local/global + softcap + sandwich-norm structure as gemma2-2b.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    act="gelu",
    window=4096,
    local_global_pattern=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    query_scale=256.0 ** -0.5,
    supports_long_context=True,
)
