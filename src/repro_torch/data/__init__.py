"""Synthetic LDA corpora for the port."""
