"""repro_torch.core — the AutoAnalyzer algorithms (numpy, no torch).

Copies of the JAX package's numpy modules, identical but for the package
name in their imports; the serving loop drives them through
``AnalysisSession`` / ``AsyncAnalysisSession`` and ``PolicyEngine``.
"""
from .analyzer import AnalysisReport, Measurements
from .external import ExternalReport
from .pipeline import AsyncAnalysisSession
from .policy import PolicyEngine, make_policies
from .regions import ROOT_ID, RegionTree
from .session import AnalysisSession, SessionReport, WindowEntry

__all__ = [
    "AnalysisReport", "AnalysisSession", "AsyncAnalysisSession",
    "ExternalReport", "Measurements", "PolicyEngine", "ROOT_ID",
    "RegionTree", "SessionReport", "WindowEntry", "make_policies",
]
