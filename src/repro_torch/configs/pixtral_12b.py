"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo [hf:mistralai/Pixtral-12B].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
The ViT + projector are the allowed STUB: the decoder consumes precomputed
patch embeddings [B, 256, 5120] prepended to the text stream.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    n_image_tokens=256,
    supports_long_context=False,
)
