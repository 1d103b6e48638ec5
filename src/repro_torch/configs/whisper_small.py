"""whisper-small [audio] — enc-dec backbone [arXiv:2212.04356].

12L encoder + 12L decoder, d_model=768, 12H (kv=12, MHA), d_ff=3072,
vocab=51865. LayerNorm, GELU non-gated MLP, learned positions, QKV bias.
Conv/mel frontend is the allowed STUB: encoder consumes precomputed frame
embeddings [B, 1500, 768].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv=12,
    d_ff=3072,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    mlp_gated=False,
    pos_embed="learned",
    qkv_bias=True,
    max_source_len=1500,
    supports_long_context=False,
)
