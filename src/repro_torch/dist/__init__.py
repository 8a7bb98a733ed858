"""Distribution of the port: the fault-tolerant gradient sync (the
single-process form; ``torch.distributed`` is not ported yet)."""
