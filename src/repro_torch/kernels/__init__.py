"""Kernel layer of the port: the codec as torch ops, the hand-written CUDA
kernels (the entangled GEMM in its dense and grouped per-expert forms, the
entangle / disentangle / checksum passes, the plain and the entangled
depthwise causal conv1d) with their plain versions, and the dispatch in
``ops``."""
