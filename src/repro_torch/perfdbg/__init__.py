"""Instrumentation and collection substrate (numpy copies, no torch)."""
from .costs import AnalyticCosts, CostProvider
from .instrument import Instrumenter
from .recorder import RegionRecorder, WindowSnapshot
from .schema import PAPER_SCHEMA, TPU_SCHEMA, get_schema

__all__ = ["AnalyticCosts", "CostProvider", "Instrumenter", "PAPER_SCHEMA", "RegionRecorder", "TPU_SCHEMA",
           "WindowSnapshot", "get_schema"]
