"""PyTorch/CUDA port of :mod:`repro` — numerical entanglement (paper
arXiv:1509.03838) on an NVIDIA H100.

The package mirrors ``src/repro`` module for module and imports only
``torch`` and ``numpy``: the JAX package is its reference, never its
dependency. Ported so far (the serving slice): the entanglement codec,
the fused entangled int8 GEMM (a hand-written CUDA kernel plus its plain
PyTorch version), the protected-GEMM subsystem, the dense llama decoder
and the batched ``ServeEngine`` with its CLI (``python -m
repro_torch.launch.serve``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present they raise instead of falling
back to the CPU.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA;
    a CUDA device without an index is the current card, with its index —
    the device that tensors made on ``"cuda"`` report.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    present — an entry point never falls back to the CPU quietly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch entry points run on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:  # the current card, so that devices compare
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
