"""Data of the port: the deterministic synthetic LM corpus (numpy)."""
