"""Kernel layer of the port: the codec as torch ops, the hand-written
CUDA entangled GEMM (dense and grouped per-expert forms) with their plain
versions, and the dispatch in ``ops``."""
