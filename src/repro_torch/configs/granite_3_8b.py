"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base family].

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155. Plain pre-RMSNorm
SwiGLU decoder.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10000.0,
    supports_long_context=False,
)
