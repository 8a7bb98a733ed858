"""Examples of the port, counterparts of the repository's ``examples/``:
``python -m repro_torch.examples.quickstart`` and ``python -m
repro_torch.examples.train_lm`` (on CUDA unless ``--device cpu``)."""
