"""LM scaffold: the dense decoder (layers, attention, transformer)."""
