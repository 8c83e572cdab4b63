"""Reproductions of the paper's two evaluation programs as instrumented
SPMD workloads (ST: seismic tomography; NPAR1WAY: rank statistics)."""
from .st import STWorkload, run_st
from .npar1way import NPAR1WAYWorkload, run_npar1way
