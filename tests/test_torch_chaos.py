"""The chaos harness in the port (``repro_torch.perfdbg.chaos``, a copy of
``repro.perfdbg.chaos`` held to that by ``tests/test_torch_analysis.py``)
against the JAX package's.

Every fault decision is a pure function of the seed, so one seed, forced
faults, journal and policies give the same fault schedule, the same exact
accounting, the same transport health and the same rendered session report
in both packages; ``check()`` holds the survival invariant, and the soak's
entry point exits 0.

The quarantine policy reads the cumulative transport health on the
analysis thread while the caller merges the next windows, so how many
proposals it logs depends on how far the caller has got, in the reference
too.  The parity runs therefore analyse each window before the next one is
merged (``_serial``), which fixes that schedule in both packages.
"""
import pytest

pytest.importorskip("torch")

from repro.core import journal as jjournal  # noqa: E402
from repro.perfdbg import chaos as jchaos  # noqa: E402
from repro_torch.core import journal as tjournal  # noqa: E402
from repro_torch.perfdbg import chaos as tchaos  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

COUNTS = ("windows", "submitted", "analyzed", "failed", "dropped",
          "no_contributors", "journal_errors", "worker_restarts",
          "fault_counts", "policy_entries")

RUNS = {
    "default_rates": dict(seed=3, windows=16, hosts=3, ranks_per_host=2),
    "heavy_rates": dict(seed=11, windows=20, hosts=2, ranks_per_host=2,
                        rates={k: min(1.0, 4 * v)
                               for k, v in jchaos.DEFAULT_RATES.items()}),
    "forced_analyzer": dict(seed=3, windows=8, hosts=2, ranks_per_host=2,
                            rates={}, force={"analyzer": [(2, 0), (5, 0)]}),
    "bitflip_quarantine": dict(seed=4, windows=8, hosts=2, ranks_per_host=2,
                               rates={}, force={"bitflip": [(w, 1) for w in range(8)]},
                               policies="quarantine"),
    "all_policies_pool": dict(seed=17, windows=12, hosts=2, ranks_per_host=3,
                              policies="all", workers=3),
    "fault_free": dict(seed=5, windows=10, hosts=2, ranks_per_host=2, rates={}),
}


@pytest.fixture
def _serial(monkeypatch):
    """Each package's chaos run waits for every submitted window to be
    analysed before it merges the next."""
    for mod in (jchaos, tchaos):
        class Serial(mod.AsyncAnalysisSession):
            def submit(self, snap, label=None):
                super().submit(snap, label=label)
                self.drain()
        monkeypatch.setattr(mod, "AsyncAnalysisSession", Serial)


def _faults(res):
    # the analyzer's decisions are asked on the analysis thread, so the
    # order in which faults fire interleaves two threads; the set is exact
    return sorted((f.kind, f.window, f.host) for f in res.faults)


@pytest.mark.parametrize("name", list(RUNS))
def test_run_chaos_identical(name, _serial):
    kw = RUNS[name]
    j = jchaos.run_chaos(**kw).check()
    t = tchaos.run_chaos(**kw).check()
    for field in COUNTS:
        assert getattr(t, field) == getattr(j, field), field
    assert _faults(t) == _faults(j)
    assert t.health.render() == j.health.render()
    assert t.report_text == j.report_text
    if name == "forced_analyzer":
        assert t.failed == 2 and "FAILED: ChaosError" in t.report_text
    if name == "bitflip_quarantine":
        assert t.health.bad(1) == 8 and t.policy_entries > 0
    if name == "fault_free":
        assert not t.faults and t.failed == t.dropped == 0


def test_journal_faults_identical(tmp_path, _serial):
    kw = dict(seed=2, windows=12, hosts=2, ranks_per_host=2,
              rates={"journal": 0.5})
    j = jchaos.run_chaos(**kw, journal_path=str(tmp_path / "j.journal")).check()
    t = tchaos.run_chaos(**kw, journal_path=str(tmp_path / "t.journal")).check()
    assert (t.journal_errors, _faults(t)) == (j.journal_errors, _faults(j))
    assert 0 < t.journal_errors < t.submitted
    assert tjournal.scan(str(tmp_path / "t.journal")) == \
        jjournal.scan(str(tmp_path / "j.journal"))


def test_mangle_classification():
    """Each transport fault lands in its designed health bucket."""
    from repro_torch.launch.collect import TransportHealth, merge_blobs
    tree = tchaos.synthetic_tree()
    blobs = tchaos.shard_blobs(tchaos.synthetic_stream(tree, 1, 4)[0], 4)
    cases = {"truncate": "corrupt", "bitflip": "corrupt",
             "skew": "skew", "drop": "missing", "delay": "missing"}
    for kind, expect in sorted(cases.items()):
        inj = tchaos.ChaosInjector(7, rates={}, force={kind: [(0, 2)]})
        mangled = [inj.mangle_blob(b, 0, h) for h, b in enumerate(blobs)]
        health = TransportHealth()
        merged = merge_blobs(mangled, tree=tree, total_ranks=4, strict=False,
                             health=health)
        assert health.last_statuses[2] == expect, kind
        assert merged.gap_mask[2]


def test_soak_entry_point_exits_zero(capsys):
    assert tchaos.main(["--seed", "3", "--windows", "12", "--policies", "all"]) == 0
    out = capsys.readouterr().out
    assert "[chaos] accounting exact" in out
    assert "transport health: 12 windows" in out
