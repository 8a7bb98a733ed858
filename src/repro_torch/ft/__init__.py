"""Protected-GEMM subsystem of the port (see :mod:`repro_torch.ft.protected`)."""
from repro_torch.ft.plans import (PROTECTED_WEIGHT_KEYS, CompiledPlans,
                                  compile_plans, prepare_params)
from repro_torch.ft.protected import (SCOPES, FTContext, group_order,
                                      protected_matmul,
                                      protected_matmul_grouped)
from repro_torch.ft.quantize import (activation_budget, quantize_acts,
                                     quantize_weight, quantize_weight_stacked)
from repro_torch.ft.registry import PlanRegistry, ProtectionPlan, group_rows

__all__ = [
    "CompiledPlans", "FTContext", "PROTECTED_WEIGHT_KEYS", "PlanRegistry",
    "ProtectionPlan", "SCOPES", "activation_budget", "compile_plans",
    "group_order", "group_rows", "prepare_params", "protected_matmul",
    "protected_matmul_grouped",
    "quantize_acts", "quantize_weight", "quantize_weight_stacked",
]
