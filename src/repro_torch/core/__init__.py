"""Entanglement core of the port: plans, the codec, fail-stop poison."""
from repro_torch.core.entangle import disentangle, entangle, extract
from repro_torch.core.failstop import GARBAGE
from repro_torch.core.plan import EntanglePlan, make_plan, plan_lk

__all__ = ["EntanglePlan", "GARBAGE", "disentangle", "entangle", "extract",
           "make_plan", "plan_lk"]
