"""Entanglement core of the port: plans, the codec, the LSB op registry,
the checksum-ABFT baseline and the fail-stop engine over all recovery
families."""
from repro_torch.core.plan import EntanglePlan, make_plan, plan_lk
from repro_torch.core.entangle import (disentangle, entangle,
                                       entangle_kernel_addsub, extract,
                                       reentangle_stream)
from repro_torch.core.lsb_ops import OPS, LSBOp, apply_streams, get_op
from repro_torch.core.checksum import (attach_checksum, make_checksum_stream,
                                       recover_from_checksum)
from repro_torch.core.failstop import GARBAGE, FTConfig, FTReport, run_protected

__all__ = ["EntanglePlan", "FTConfig", "FTReport", "GARBAGE", "LSBOp", "OPS",
           "apply_streams", "attach_checksum", "disentangle", "entangle",
           "entangle_kernel_addsub", "extract", "get_op",
           "make_checksum_stream", "make_plan", "plan_lk",
           "recover_from_checksum", "reentangle_stream", "run_protected"]
