"""LM scaffold: layers, attention, the decoder families (transformer,
moe, mamba2, xlstm), the encoder-decoder and the frontend stubs."""
