"""gemma2-2b [dense] — local+global alternating, softcaps [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim=256.
Sliding window 4096 on even layers / global on odd; attn softcap 50,
final-logit softcap 30; pre+post sandwich RMSNorms; GeGLU.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv=4,
    head_dim=256,
    d_ff=9216,
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
