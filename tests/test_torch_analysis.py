"""The port's analysis half against the JAX package's.

``repro_torch.core`` and ``repro_torch.perfdbg`` are copies of the numpy
modules of ``repro.core`` / ``repro.perfdbg`` in which only the package
name of the imports differs: the source test holds them to that, and the
behaviour tests feed the same seeded windows (an injected slow region on
one rank, then a data-skew straggler) through both and require the same
rendered session report, byte-identical PDWS wire snapshots and equal
policy decisions, inline and through the async pipeline.
"""
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.perfdbg as jperfdbg  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.perfdbg as tperfdbg  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
COPIED = [f"core/{m}.py" for m in (
    "regions", "vectors", "optics", "kmeans", "_reference", "roughset",
    "external", "internal", "analyzer", "diagnosis", "session", "pipeline",
    "policy", "journal")] + [f"perfdbg/{m}.py" for m in (
        "schema", "recorder", "instrument", "straggler", "costs")] + [
    "models/config.py", "data/pipeline.py"]
IMPORT = re.compile(r"^(\s*from )repro\.", re.M)

M, WINDOWS = 8, 5
IO_ATTR = {"paper": "disk_io", "tpu": "host_io_bytes"}


@pytest.mark.parametrize("rel", COPIED)
def test_copy_differs_only_in_package_imports(rel):
    want = IMPORT.sub(r"\1repro_torch.", (SRC / "repro" / rel).read_text())
    assert (SRC / "repro_torch" / rel).read_text() == want


def _tree(core):
    t = core.RegionTree("app")
    t.add("data")
    step = t.add("step")
    t.add("fwd", parent=step)
    t.add("bwd", parent=step)
    t.add("ckpt")
    return t


def _window_values(seed, w, schema):
    """Per (rank, region) observations of window ``w``: rank 5's ``bwd``
    is slow from window 1 on; rank 2 gets twice the data work from window
    3 on (a data-skew straggler the policies should act on)."""
    rng = np.random.default_rng(seed + w)
    rows = []
    for r in range(M):
        for name, base in (("data", 0.5), ("fwd", 1.0), ("bwd", 2.0), ("ckpt", 0.2)):
            f = 1.0 + 0.02 * rng.standard_normal()
            work = 1.0
            if name == "bwd" and r == 5 and w >= 1:
                f *= 3.0
            if name == "data" and r == 2 and w >= 3:
                f *= 2.0
                work = 2.0
            t = base * f
            rows.append((r, name, t, base * 1e9 * work,
                         {IO_ATTR[schema]: 1e6 * base * work}))
    return rows


def _fill(rec, tree, rows):
    ids = {tree.name(i): i for i in tree.ids()}
    walls = {}
    for r, name, t, instr, attrs in rows:
        rec.add(r, ids[name], cpu_time=t, wall_time=t, cycles=2e9 * t,
                instructions=instr, **attrs)
        walls[r] = walls.get(r, 0.0) + t
    for r, wall in walls.items():
        rec.add_program_wall(r, wall)


def _decisions(log):
    # every field but wall-clock ones (Decision carries none today)
    return [(d.window, d.policy, d.kind, d.target, d.reason, d.streak,
             d.evidence) for d in log.decisions]


def _run_inline(core, perfdbg, schema, seed):
    tree = _tree(core)
    rec = perfdbg.RegionRecorder(tree, M, schema=schema)
    session = core.AnalysisSession(tree)
    engine = core.PolicyEngine(core.make_policies("all"), k=2)
    wire, fired = [], []
    for w in range(WINDOWS):
        _fill(rec, tree, _window_values(seed, w, schema))
        snap = rec.reset_window(label=f"w{w}")
        wire.append(snap.to_bytes())
        fired += [a.render() for a in engine.observe(
            session.ingest_snapshot(snap), session)]
    return session.report().render(tree), wire, _decisions(engine.log), fired


def _run_async(core, perfdbg, schema, seed):
    tree = _tree(core)
    rec = perfdbg.RegionRecorder(tree, M, schema=schema)
    engine = core.PolicyEngine(core.make_policies("all"), k=2)
    pipe = core.AsyncAnalysisSession(tree, max_queue=4, policy_engine=engine)
    for w in range(WINDOWS):
        _fill(rec, tree, _window_values(seed, w, schema))
        pipe.submit_recorder(rec, label=f"round {w}")
    report = pipe.close(timeout=60)
    return report.render(tree), _decisions(engine.log), \
        [a.render() for a in pipe.take_actions()]


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("schema", ["paper", "tpu"])
def test_inline_session_identical(schema, seed):
    j_render, j_wire, j_dec, j_fired = _run_inline(jcore, jperfdbg, schema, seed)
    t_render, t_wire, t_dec, t_fired = _run_inline(tcore, tperfdbg, schema, seed)
    assert t_render == j_render
    assert t_wire == j_wire
    assert t_dec == j_dec
    assert t_fired == j_fired
    # the windows are not trivial: the slow region is found, policies speak
    assert "bwd" in t_render and t_dec


@pytest.mark.parametrize("schema", ["paper", "tpu"])
def test_async_pipeline_identical(schema):
    j = _run_async(jcore, jperfdbg, schema, 5)
    t = _run_async(tcore, tperfdbg, schema, 5)
    assert t == j
    assert "5 window(s)" in t[0]


def test_wire_snapshot_crosses_packages():
    """A window packed by the port decodes in the reference, and back."""
    jt, tt = _tree(jcore), _tree(tcore)
    trec = tperfdbg.RegionRecorder(tt, M, schema="tpu")
    _fill(trec, tt, _window_values(3, 2, "tpu"))
    blob = trec.reset_window(label="x").to_bytes()
    back = jperfdbg.WindowSnapshot.from_bytes(blob, jt)
    assert back.to_bytes() == blob
    assert tperfdbg.WindowSnapshot.from_bytes(back.to_bytes(), tt).to_bytes() == blob
