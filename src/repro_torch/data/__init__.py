"""Data of the port: the deterministic synthetic LM corpus (numpy) and the
entangled token-shard store with its prefetcher."""
