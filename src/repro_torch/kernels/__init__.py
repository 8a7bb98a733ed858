"""Kernel layer of the port: the codec as torch ops, the hand-written
CUDA entangled GEMM with its plain version, and the dispatch in ``ops``."""
