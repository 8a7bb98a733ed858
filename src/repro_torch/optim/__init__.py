"""Optimizers of the port: AdamW over the nested param dicts."""
