"""Kernel layer of the port: the codec as torch ops, the hand-written CUDA
kernels (the entangled GEMM in its dense and grouped per-expert forms, the
entangle / disentangle / checksum passes, the plain and the entangled
depthwise causal conv1d) with their plain versions, the oracles of
``ref``, the backend registry and dispatch in ``ops``, and the
launch-parameter autotuner of ``autotune`` with its H100 seed cache in
``pretuned/``."""
