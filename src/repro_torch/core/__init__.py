"""Entanglement core of the port: plans, the codec, the LSB op registry,
the checksum-ABFT baseline and the fail-stop engine over all recovery
families; the fixed-point bridge (:mod:`.fixed_point`) and SDC detection
(:mod:`.sdc`) are submodules."""
from repro_torch.core.plan import (EntanglePlan, checksum_output_bits,
                                   container_dtype, make_plan, plan_lk)
from repro_torch.core.entangle import (disentangle, disentangle_oracle_np,
                                       entangle, entangle_kernel_addsub,
                                       extract, reentangle_stream)
from repro_torch.core.lsb_ops import OPS, LSBOp, apply_streams, get_op
from repro_torch.core.checksum import (attach_checksum, make_checksum_stream,
                                       recover_from_checksum)
from repro_torch.core.failstop import GARBAGE, FTConfig, FTReport, run_protected
from repro_torch.core.fixed_point import dequantize, fit_scale, quantize

__all__ = ["EntanglePlan", "FTConfig", "FTReport", "GARBAGE", "LSBOp", "OPS",
           "apply_streams", "attach_checksum", "checksum_output_bits",
           "container_dtype", "dequantize", "disentangle",
           "disentangle_oracle_np", "entangle", "entangle_kernel_addsub",
           "extract", "fit_scale", "get_op", "make_checksum_stream",
           "make_plan", "plan_lk", "quantize", "recover_from_checksum",
           "reentangle_stream", "run_protected"]
