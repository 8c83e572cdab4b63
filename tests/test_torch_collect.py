"""Pod transport in the port (``repro_torch.launch.collect``) against the
JAX package's (``repro.launch.collect``).

``TransportHealth``, ``merge_blobs`` and every method of
``SnapshotCollector`` but the three that reached jax keep the reference's
source text; the rest is rewritten on ``torch.distributed``.  The lenient
merge classifies clean, truncated, bit-flipped, version-skewed,
index-disagreeing and missing blobs as the reference does, with the same
merged wire bytes and health counters; the collector's retry, timeout and
pileup guard and a collector faked to two processes behave as the
reference's tests require; and two real processes in one gloo group gather
seeded windows into the snapshot the reference's ``merge_blobs`` makes of
the same blobs.
"""
import ast
import os
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.launch import collect as jcollect  # noqa: E402
from repro.perfdbg import chaos as jchaos  # noqa: E402
from repro.perfdbg.recorder import WindowSnapshot as JSnapshot  # noqa: E402
from repro_torch.core import RegionTree  # noqa: E402
from repro_torch.launch import collect as tcollect  # noqa: E402
from repro_torch.perfdbg import RegionRecorder  # noqa: E402
from repro_torch.perfdbg import chaos as tchaos  # noqa: E402
from _torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
COPIED = ("TransportHealth", "merge_blobs")
COPIED_METHODS = ("__init__", "gather", "gather_timed", "_produce")


def _top(path: Path):
    text = path.read_text()
    return text, {n.name: n for n in ast.parse(text).body
                  if isinstance(n, (ast.ClassDef, ast.FunctionDef))}


def test_copied_definitions_keep_the_references_text():
    jtext, jdefs = _top(SRC / "repro" / "launch" / "collect.py")
    ttext, tdefs = _top(SRC / "repro_torch" / "launch" / "collect.py")
    assert set(tdefs) == set(jdefs)
    for name in COPIED:
        assert ast.get_source_segment(ttext, tdefs[name]) == \
            ast.get_source_segment(jtext, jdefs[name]), name
    jcls, tcls = jdefs["SnapshotCollector"], tdefs["SnapshotCollector"]
    assert ast.get_docstring(tcls) == ast.get_docstring(jcls)
    jm = {n.name: n for n in jcls.body if isinstance(n, ast.FunctionDef)}
    tm = {n.name: n for n in tcls.body if isinstance(n, ast.FunctionDef)}
    assert set(tm) == set(jm)
    for name in COPIED_METHODS:
        assert ast.get_source_segment(ttext, tm[name]) == \
            ast.get_source_segment(jtext, jm[name]), name


# -- merge_blobs parity -----------------------------------------------------

def _blobs(chaos, hosts=4, windows=2):
    tree = chaos.synthetic_tree()
    stream = chaos.synthetic_stream(tree, windows, 2 * hosts)
    return tree, [chaos.shard_blobs(s, hosts) for s in stream]


def _damage(blobs, case):
    """Host 2's blob of window 0 as the fault ``case`` leaves it (``index``:
    host 2 ships window 1's shard, well formed but out of step)."""
    out = list(blobs[0])
    b = out[2]
    if case == "truncated":
        out[2] = b[:len(b) // 3]
    elif case == "bitflip":
        flipped = bytearray(b)
        flipped[len(b) // 2] ^= 0x10
        out[2] = bytes(flipped)
    elif case == "skewed":
        patched = bytearray(b)
        struct.pack_into("<H", patched, 4, 9999)
        out[2] = bytes(patched)
    elif case == "missing":
        out[2] = None
    elif case == "empty":
        out[2] = b""
    elif case == "index":
        out[2] = blobs[1][2]
    return out


CASES = {"clean": "ok", "truncated": "corrupt", "bitflip": "corrupt",
         "skewed": "skew", "missing": "missing", "empty": "missing",
         "index": "skew"}


@pytest.mark.parametrize("case", list(CASES))
def test_lenient_merge_identical(case):
    jtree, jb = _blobs(jchaos)
    ttree, tb = _blobs(tchaos)
    assert jb == tb
    jh, th = jcollect.TransportHealth(), tcollect.TransportHealth()
    jm = jcollect.merge_blobs(_damage(jb, case), tree=jtree, total_ranks=8,
                              strict=False, health=jh)
    tm = tcollect.merge_blobs(_damage(tb, case), tree=ttree, total_ranks=8,
                              strict=False, health=th)
    assert tm.to_bytes() == jm.to_bytes()
    assert th.last_statuses == jh.last_statuses
    assert th.last_statuses[2] == CASES[case]
    assert th.render() == jh.render()
    assert [th.bad(h) for h in range(4)] == [jh.bad(h) for h in range(4)]
    assert bool(tm.gap_mask[4:6].all()) == (case != "clean")


@pytest.mark.parametrize("case", ["truncated", "skewed"])
def test_strict_merge_raises_as_the_reference(case):
    jtree, jb = _blobs(jchaos)
    ttree, tb = _blobs(tchaos)
    with pytest.raises(Exception) as jerr:
        jcollect.merge_blobs(_damage(jb, case), tree=jtree)
    with pytest.raises(Exception) as terr:
        tcollect.merge_blobs(_damage(tb, case), tree=ttree)
    assert type(terr.value).__name__ == type(jerr.value).__name__


def test_no_contributor_raises_value_error():
    for collect in (jcollect, tcollect):
        with pytest.raises(ValueError):
            collect.merge_blobs([None, b""], strict=False)


# -- the collector's hardening (as tests/test_chaos.py holds the reference's)

def _snap():
    tree = tchaos.synthetic_tree()
    return tchaos.synthetic_stream(tree, 1, 2)[0]


def test_collector_is_one_process_without_a_group():
    col = tcollect.SnapshotCollector()
    assert (col.process_index, col.process_count) == (0, 1)
    merged = col.gather(_snap(), total_ranks=2)
    assert not merged.gap_mask.any()
    with pytest.raises(ValueError):
        col.gather(None, total_ranks=2)


def test_retry_then_success():
    health = tcollect.TransportHealth()
    col = tcollect.SnapshotCollector(rank_offset=0, retries=2, backoff=0.0,
                                     health=health)
    snap, calls = _snap(), []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return snap

    merged = col.gather_timed(flaky, total_ranks=2)
    assert len(calls) == 3
    assert health.retries == 2 and health.local_failures == 0
    assert not merged.gap_mask.any()


def test_retries_exhausted_ships_none():
    health = tcollect.TransportHealth()
    col = tcollect.SnapshotCollector(rank_offset=0, retries=1, backoff=0.0,
                                     health=health)

    def always_fails():
        raise RuntimeError("broken recorder")

    with pytest.raises(ValueError):
        col.gather_timed(always_fails, total_ranks=2)
    assert health.local_failures == 1 and health.retries == 1


def test_timeout_abandons_and_pileup_guard_refuses_respawn():
    health = tcollect.TransportHealth()
    col = tcollect.SnapshotCollector(rank_offset=0, timeout=0.05, health=health)
    release = threading.Event()
    snap = _snap()

    def wedged():
        release.wait(5.0)
        return snap

    with pytest.raises(ValueError):
        col.gather_timed(wedged, total_ranks=2)
    assert col._producer is not None and col._producer.is_alive()
    t0 = time.monotonic()
    with pytest.raises(ValueError):
        col.gather_timed(wedged, total_ranks=2)
    assert time.monotonic() - t0 < 0.05
    assert health.abandoned == 1
    release.set()
    col._producer.join(5.0)
    assert not col._producer.is_alive()
    merged = col.gather_timed(lambda: snap, total_ranks=2)
    assert not merged.gap_mask.any()


def test_legacy_fast_path_unchanged():
    col = tcollect.SnapshotCollector(rank_offset=0)
    merged = col.gather_timed(_snap, total_ranks=2)
    assert not merged.gap_mask.any()
    assert col._producer is None


# -- a collector faked to two processes (as tests/test_policy.py fakes one)

def _small_tree():
    t = RegionTree()
    for i in range(1, 4):
        t.add(f"r{i}", rid=i)
    return t


def _shard(tree, off):
    rec = RegionRecorder(tree, 2, rank_offset=off)
    for r in range(2):
        for rid in (1, 2, 3):
            rec.add(r, rid, cpu_time=1.0, wall_time=1.0, cycles=2e9,
                    instructions=1e9)
        rec.add_program_wall(r, 3.0)
    return rec.snapshot()


class FakePodCollector(tcollect.SnapshotCollector):
    """Two-host transport without a group: the other host's blob is
    injected, ours goes through the real empty-payload path."""
    process_count = 2
    process_index = 0

    def __init__(self, other_blob, **kw):
        super().__init__(**kw)
        self._other = other_blob

    def _allgather(self, blob):
        return [blob if blob else None, self._other]


def test_fake_pod_timed_out_host_ships_gap_not_block():
    t = _small_tree()
    col = FakePodCollector(_shard(t, 2).to_bytes(), timeout=0.05)
    release = threading.Event()

    def slow_snapshot():
        release.wait(10.0)
        return _shard(t, 0)

    t0 = time.perf_counter()
    pod = col.gather_timed(slow_snapshot, total_ranks=4)
    release.set()
    assert time.perf_counter() - t0 < 5.0
    assert list(np.flatnonzero(pod.gap_mask)) == [0, 1]
    assert pod.measurements().cpu_time[2, 0] == 1.0


def test_fake_pod_fast_host_ships_normally():
    t = _small_tree()
    col = FakePodCollector(_shard(t, 2).to_bytes(), timeout=5.0)
    pod = col.gather_timed(lambda: _shard(t, 0), total_ranks=4)
    assert not pod.gap_mask.any() and pod.n_ranks == 4
    # the reference's merge of the same two blobs gives the same bytes
    ours = _shard(t, 0).to_bytes(rank_offset=0, checksum=True)
    ref = jcollect.merge_blobs([ours, _shard(t, 2).to_bytes()], total_ranks=4,
                               strict=True)
    assert pod.to_bytes() == ref.to_bytes()


# -- two real processes in one gloo group -----------------------------------

WORKER = r"""
import sys
import numpy as np
import torch.distributed as dist
from repro_torch.core import RegionTree
from repro_torch.launch.collect import SnapshotCollector
from repro_torch.perfdbg import RegionRecorder

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
try:
    tree = RegionTree("pod")
    for name in ("load", "compute", "allreduce"):
        tree.add(name)
    rng = np.random.default_rng(100 + rank)
    rec = RegionRecorder(tree, 2)
    for w in range(2):
        for r in range(2):
            for rid in tree.ids():
                t = float(rng.uniform(0.5, 2.0))
                rec.add(r, rid, cpu_time=t, wall_time=t, cycles=2e9 * t,
                        instructions=1e9 * (1 + rank))
            rec.add_program_wall(r, 3.0 + rank)
        snap = rec.reset_window(f"w{w}")
        col = SnapshotCollector(strict=False)
        assert (col.process_index, col.process_count) == (rank, world)
        merged = col.gather(snap, total_ranks=2 * world)
        open(f"{out}.blob{rank}.w{w}", "wb").write(
            snap.to_bytes(rank_offset=rank * 2, checksum=True))
        open(f"{out}.merged{rank}.w{w}", "wb").write(merged.to_bytes())
finally:
    dist.destroy_process_group()
"""


def test_two_process_gloo_gather_equals_reference_merge(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), **ONE_THREAD_ENV)
    init, out = str(tmp_path / "init"), str(tmp_path / "out")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), "2", init, out],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
    for w in range(2):
        blobs = [Path(f"{out}.blob{r}.w{w}").read_bytes() for r in range(2)]
        ref = jcollect.merge_blobs(blobs, total_ranks=4, strict=False).to_bytes()
        for r in range(2):
            assert Path(f"{out}.merged{r}.w{w}").read_bytes() == ref
        snap = JSnapshot.from_bytes(ref)
        assert snap.n_ranks == 4 and not snap.gap_mask.any()
        assert snap.label == f"w{w}"


def test_allgather_in_a_one_process_gloo_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}",
                            rank=0, world_size=1)
    try:
        col = tcollect.SnapshotCollector()
        assert (col.process_index, col.process_count) == (0, 1)
        blob = _snap().to_bytes(checksum=True)
        assert col._allgather(blob) == [blob]
        assert col._allgather(b"") == [None]
    finally:
        dist.destroy_process_group()


def test_allgather_refuses_other_backends(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "mpi")
    with pytest.raises(RuntimeError, match="not over the 'mpi' backend"):
        tcollect.SnapshotCollector()._allgather(b"x")
