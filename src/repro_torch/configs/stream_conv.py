"""The paper's own workload: M integer streams convolved with kernel g
(port of :mod:`repro.configs.stream_conv`).

This is the configuration behind paper Fig. 2 / Sec. V (Intel IPP conv of
M in {3, 8} streams, N_in = 1e6 samples, kernel sizes 100..4500). It is not
a model, so the model registry does not list it: the fail-stop engine
(:func:`repro_torch.core.run_protected`) and ``chip_smoke.py`` read it
directly.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StreamConvConfig:
    name: str = "stream-conv"
    M: int = 3
    w: int = 32
    n_in: int = 1_000_000
    kernel_sizes: tuple[int, ...] = (100, 500, 1000, 2000, 4500)


CONFIG = StreamConvConfig()


def smoke_config() -> StreamConvConfig:
    return StreamConvConfig(name="stream-conv-smoke", n_in=4096,
                            kernel_sizes=(16, 64))
