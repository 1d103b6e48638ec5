"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

12 blocks, d_model=768, 4 heads, vocab=50304, d_ff=0 (blocks carry their
own projections: mLSTM expands 2x, sLSTM has a 4/3 GeGLU post-FFN).
sLSTM at every 4th block (3 of 12), mLSTM elsewhere — the xLSTM[7:1]-ish
mix. long_500k runs: decode state is O(dh^2) per head, constant in L.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=4,
    xlstm_chunk=256,            # SPerf E5: chunkwise-parallel mLSTM

    supports_long_context=True,
)
