"""The paper's two case studies (§5) in the port against the JAX package.

``repro_torch.perfdbg.workloads`` is a copy of ``repro.perfdbg.workloads``
(held to that by ``tests/test_torch_analysis.py``).  Both record region
costs as units x tau, with the taus calibrated on the CPU clock unless they
are given, so every comparison here runs on the fixed taus below and no
clock decides it: the same variant gives the same recorded measurements and
the same rendered report in both packages, and the port's report carries
the paper's verdicts.  The counterparts of ``examples/st_case_study.py``
and ``examples/npar1way_case_study.py`` (``repro_torch.launch``) run to
the end.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.perfdbg.workloads import npar1way as jnpar  # noqa: E402
from repro.perfdbg.workloads import st as jst  # noqa: E402
from repro_torch.launch import npar1way_case_study, st_case_study  # noqa: E402
from repro_torch.perfdbg.workloads import npar1way as tnpar  # noqa: E402
from repro_torch.perfdbg.workloads import st as tst  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
# the scale of tests/test_case_studies.py, and the fixed taus and ST's kinds
# that chip_smoke.py's phase G requires on the card too
SCALE, ST_TAUS, NPAR_TAUS, ST_KINDS = (smoke.G_SCALE, smoke.ST_TAUS, smoke.NPAR_TAUS,
                                       smoke.ST_KINDS)
MEASURED = ("cpu_time", "wall_time", "cycles", "instructions")

ST_VARIANTS = {
    "original": {},
    "balanced": dict(balance_region11=True),
    "locality_buffered_io": dict(optimize_locality=True, buffer_io=True),
    "all_fixed": dict(balance_region11=True, optimize_locality=True,
                      buffer_io=True),
}
NPAR_VARIANTS = {"original": {}, "optimized": dict(eliminate_redundancy=True)}


def _same_recording(jrec, trec):
    """Equal recorded region costs and attributes (the program wall is the
    real clock around each rank and differs run to run)."""
    jm, tm = jrec.measurements(), trec.measurements()
    for field in MEASURED:
        np.testing.assert_array_equal(getattr(tm, field), getattr(jm, field),
                                      err_msg=field)
    ja, ta = jrec.attributes(), trec.attributes()
    assert sorted(ta) == sorted(ja)
    for name in ja:
        np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)


def _cost(rec):
    return rec.measurements().wall_time.sum(axis=1).max()


@pytest.fixture(scope="module")
def st_runs():
    return {name: (jst.run_st(jst.STWorkload(scale=SCALE, taus=ST_TAUS, **kw)),
                   tst.run_st(tst.STWorkload(scale=SCALE, taus=ST_TAUS, **kw)))
            for name, kw in ST_VARIANTS.items()}


@pytest.fixture(scope="module")
def npar_runs():
    return {name: (jnpar.run_npar1way(jnpar.NPAR1WAYWorkload(
                       scale=SCALE, taus=NPAR_TAUS, **kw)),
                   tnpar.run_npar1way(tnpar.NPAR1WAYWorkload(
                       scale=SCALE, taus=NPAR_TAUS, **kw)))
            for name, kw in NPAR_VARIANTS.items()}


@pytest.mark.parametrize("variant", list(ST_VARIANTS))
def test_st_report_identical(st_runs, variant):
    (jrec, jrep, _), (trec, trep, _) = st_runs[variant]
    _same_recording(jrec, trec)
    assert trep.render(tst.st_region_tree()) == jrep.render(jst.st_region_tree())
    assert trep.external.severity == jrep.external.severity


def test_st_original_carries_the_papers_verdicts(st_runs):
    _, (_, rep, _) = st_runs["original"]
    assert rep.external.clustering.clusters == ST_KINDS
    assert rep.external.cccrs == (11,)
    assert {14, 11} <= {c.rid for c in rep.external.ccrs}
    assert set(rep.internal.cccrs) == {8, 11}
    assert 14 in rep.internal.ccrs and 14 not in rep.internal.cccrs
    assert rep.external_root_causes.core.cores == (("instructions",),)
    assert rep.internal_root_causes.core.cores == (("disk_io", "l2_miss_rate"),)


def test_st_fixes_as_the_paper(st_runs):
    _, (rec0, rep0, _) = st_runs["original"]
    _, (_, balanced, _) = st_runs["balanced"]
    assert not balanced.external.exists
    assert balanced.external.severity < 0.15 < rep0.external.severity
    _, (_, fixed, _) = st_runs["locality_buffered_io"]
    assert 8 not in fixed.internal.cccrs and 11 in fixed.internal.cccrs
    for name in ("balanced", "locality_buffered_io", "all_fixed"):
        _, (rec, _, _) = st_runs[name]
        assert _cost(rec) < _cost(rec0) * 0.95, name


@pytest.mark.parametrize("variant", list(NPAR_VARIANTS))
def test_npar1way_report_identical(npar_runs, variant):
    (jrec, jrep, _), (trec, trep, _) = npar_runs[variant]
    _same_recording(jrec, trec)
    assert trep.render(tnpar.npar1way_region_tree()) == \
        jrep.render(jnpar.npar1way_region_tree())


def test_npar1way_carries_the_papers_verdicts(npar_runs):
    _, (rec, rep, _) = npar_runs["original"]
    assert rep.external.clustering.n_clusters == 1
    assert not rep.external.exists
    assert set(rep.internal.cccrs) == {3, 12}
    assert rep.internal_root_causes.core.cores == (("instructions", "network_io"),)
    _, (rec_o, _, _) = npar_runs["optimized"]
    assert _cost(rec_o) < _cost(rec) * 0.97
    ids = list(tnpar.npar1way_region_tree().ids())
    i3, i12 = ids.index(3), ids.index(12)
    instr, instr_o = rec.measurements().instructions[0], rec_o.measurements().instructions[0]
    assert instr_o[i3] < instr[i3] * 0.75 and instr_o[i12] < instr[i12] * 0.9
    net = rec.attributes()["network_io"][0]
    assert net[i12] == net.max() == rec_o.attributes()["network_io"][0, i12]


@pytest.mark.parametrize("module", [st_case_study, npar1way_case_study],
                         ids=["st", "npar1way"])
def test_case_study_counterpart_runs(module, capsys):
    assert module.main() == 0
    out = capsys.readouterr().out
    assert "core set: {" in out
    assert "=" * 64 in out
