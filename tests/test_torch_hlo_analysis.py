"""The port's step-cost counter (``repro_torch.launch.hlo_analysis``) and
measured cost provider, against the JAX package's compiled-HLO analyzer.

Probes, the counterparts of ``tests/test_hlo_analysis.py`` and
``tests/test_costs.py``'s provider cases: one matmul (exact flops and
bytes), a loop of four (four times one), a slice read at its own size, an
``all_reduce`` under a fake process group, a ``DTensor`` counted on its
local shard, the entry equal to ``stats()`` and to the sum of its disjoint
scopes, ``HloCosts`` fed by the counter.  ``Stats`` and
``COLLECTIVE_KINDS`` keep the reference's text.

Parity on the reduced yi-34b (2 layers, d_model 128, batch 2, seq 32), the
reference's compiled train step built in-process as
``tests/test_train_integration.py`` builds it: the port's matmul flops
equal the reference's ``dot`` flops (trip-aware, through fusions) within
1 % once both compute the same heads; at the config's own ``pad_heads``
(64, which the reference pads the 2 heads to for its mesh and the port
does not) the gap is exactly the padded heads' attention dots.  The total
flops are held within 10 % of the reference's once the instructions that
have no op in eager execution are taken out of its count (XLA counts one
flop per element of every HLO instruction: fusion parameters, tuples and
their elements, broadcasts), and at seq 1024, where those are a small
share, within 10 % of its whole count.  The HBM bytes are printed beside
the reference's (XLA fuses what eager execution writes op by op) and held
to at least the parameters, gradients and AdamW state read once.

Every architecture the trainer takes counts on the ``meta`` device, and
the trainer takes ``--schema tpu`` (``--costs hlo`` by default there) and
prints the reference's ``[costs]``, coverage and ``[report]`` lines.
"""
import ast
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402

from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.launch import hlo_analysis as jha  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh as jhost_mesh  # noqa: E402
from repro.models.model import input_specs  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.launch import hlo_analysis as ha  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.perfdbg import AnalyticCosts  # noqa: E402
from _torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
SMALL = ["--device", "cpu", "--batch", "2", "--seq", "32", "--d-model", "128"]
B, S = 2, 32


@pytest.fixture
def fake_world():
    """A default process group of the ``fake`` backend (no peers, no
    traffic), torn down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


# -- probes ------------------------------------------------------------------

def test_stats_and_kinds_keep_the_references_text():
    def top(path):
        text = path.read_text()
        return text, {n.name if isinstance(n, ast.ClassDef) else n.targets[0].id: n
                      for n in ast.parse(text).body
                      if isinstance(n, ast.ClassDef)
                      or (isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name))}
    jtext, jdefs = top(SRC / "repro" / "launch" / "hlo_analysis.py")
    ttext, tdefs = top(SRC / "repro_torch" / "launch" / "hlo_analysis.py")
    for name in ("COLLECTIVE_KINDS", "Stats"):
        assert ast.get_source_segment(ttext, tdefs[name]) == \
            ast.get_source_segment(jtext, jdefs[name]), name


def test_plain_matmul_flops_and_bytes():
    M, N, K = 128, 192, 64
    a, b = torch.randn(M, K), torch.randn(K, N)
    st = ha.Analyzer(torch.matmul, a, b).stats()
    assert st.flops == 2 * M * N * K
    assert st.bytes == 4 * (M * K + K * N + M * N)
    assert st.total_collective_bytes == 0


def test_loop_of_matmuls_counts_every_trip():
    M = 64
    x, w = torch.randn(M, M, device="meta"), torch.randn(M, M, device="meta")

    def loop(x, w):
        for _ in range(4):
            x = x @ w
        return x

    one = ha.Analyzer(torch.matmul, x, w).stats()
    four = ha.Analyzer(loop, x, w).stats()
    assert four.flops == 4 * one.flops == 4 * 2 * M ** 3
    assert four.bytes == 4 * one.bytes


def test_slice_is_read_at_its_own_size():
    buf = torch.randn(8, 16, 16)
    st = ha.Analyzer(lambda t: t[3] * 2.0, buf).stats()
    assert st.bytes == 4 * (16 * 16) * 2          # the slice read, the result written
    assert st.flops == 16 * 16 + 16 * 16          # the view's elements, the product's


def test_all_reduce_counts_collective_bytes(fake_world):
    fake_world(2)
    t = torch.ones(8, 4)
    st = ha.Analyzer(dist.all_reduce, t).stats()
    assert st.collective_bytes["all-reduce"] == t.numel() * 4
    assert st.collective_counts["all-reduce"] == 1
    assert st.total_collective_bytes == t.numel() * 4
    out = torch.empty(16, 4)
    st = ha.Analyzer(dist.all_gather_into_tensor, out, t).stats()
    assert st.collective_bytes["all-gather"] == out.numel() * 4


def test_dtensor_is_counted_on_its_local_shard(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    fake_world(4)
    mesh = init_device_mesh("cpu", (4,))
    x = distribute_tensor(torch.randn(64, 32, device="meta"), mesh, [Shard(0)])
    w = distribute_tensor(torch.randn(32, 16, device="meta"), mesh, [Replicate()])
    a = ha.Analyzer(torch.matmul, x, w)
    assert a.matmul_total() == 2 * (64 // 4) * 16 * 32
    assert a.stats().bytes < 4 * (64 * 32 + 32 * 16 + 64 * 16)
    # a redistribution is the collective that moves the shards
    st = ha.Analyzer(lambda t: t.redistribute(mesh, [Replicate()]), x).stats()
    assert st.collective_bytes["all-gather"] == 4 * 64 * 32
    assert st.collective_counts["all-gather"] == 1 and st.total_collective_bytes == 4 * 64 * 32


@pytest.fixture(scope="module")
def yi_cfg():
    return train.build_config(train.parse_args(SMALL))


@pytest.fixture(scope="module")
def counted(yi_cfg):
    return steps.count_train_step(yi_cfg, adamw.AdamWConfig(), B, S)


def test_entry_equals_stats_and_the_sum_of_its_scopes(counted, yi_cfg):
    by = counted.stats_by_computation()
    assert counted.entry == "train_step"
    assert by[counted.entry] is counted.stats()
    assert set(by) == {"train_step", "embed", "final_norm", "loss", "optimizer",
                       "other"} | {f"layers.{i}" for i in range(yi_cfg.n_layers)}
    total = ha.Stats()
    for name, st in by.items():
        if name != counted.entry:
            total.add(st)
    assert total.flops == pytest.approx(counted.stats().flops, rel=1e-12)
    assert total.bytes == pytest.approx(counted.stats().bytes, rel=1e-12)
    # the layers are alike; the matmuls lie in the layers and the loss
    assert by["layers.0"].flops == by["layers.1"].flops > 0
    assert set(counted.matmul_flops) == {"layers.0", "layers.1", "loss"}
    assert by["optimizer"].bytes > 0 and counted.matmul_flops.get("optimizer") is None


def test_hlo_costs_anchor_carries_the_step(counted):
    base = AnalyticCosts({"data": {"host_io_bytes": 99.0}})
    prov = steps.hlo_cost_provider(counted, ("data", "step", "checkpoint"),
                                   anchor="step", base=base)
    st = counted.stats()
    step = prov.region_costs("step")
    assert step["hlo_flops"] == st.flops and step["hbm_bytes"] == st.bytes
    assert step["collective_bytes"] == 0.0
    assert 0.0 <= step["hbm_boundedness"] <= 1.0
    cov = prov.coverage()["step"]
    assert cov.coverage == 0.0 and cov.matched == ()
    assert cov.residual_flops == st.flops
    assert prov.region_costs("data") == {"host_io_bytes": 99.0}
    assert prov.region_costs("checkpoint") == {}
    assert "step: flops=" in prov.render_coverage()


def test_hlo_costs_attribute_scopes_to_regions_named_after_them(counted):
    by = counted.stats_by_computation()
    prov = steps.hlo_cost_provider(counted, ("step", "layers", "loss"))
    layers = by["layers.0"].flops + by["layers.1"].flops
    assert prov.region_costs("layers")["hlo_flops"] == pytest.approx(layers)
    assert prov.region_costs("loss")["hlo_flops"] == by["loss"].flops
    cov = prov.coverage()["step"]
    assert sorted(cov.matched) == [("layers.0", "layers"), ("layers.1", "layers"),
                                   ("loss", "loss")]
    assert cov.residual_flops == pytest.approx(
        counted.stats().flops - layers - by["loss"].flops)


@pytest.mark.parametrize("arch", [a for a in list_archs() if a != "whisper-large-v3"])
def test_every_trained_architecture_counts_on_meta(arch):
    cfg = train.build_config(train.parse_args(SMALL + ["--arch", arch]))
    a = steps.count_train_step(cfg, adamw.AdamWConfig(), B, S)
    st = a.stats()
    # at least the forward and backward matmuls of every active parameter
    # but the embedding (6 N T), which the remat recompute only adds to
    n_mm = cfg.active_params() - cfg.vocab_size * cfg.d_model
    assert a.matmul_total() >= 6 * n_mm * B * S * 0.9
    assert st.flops > a.matmul_total() and st.bytes > 0
    assert st.total_collective_bytes == 0
    by = a.stats_by_computation()
    assert all(st.flops >= 0 for st in by.values())
    # every part of the step lies in its scope, every matmul in a part
    parts = {"embed", "final_norm", "loss", "optimizer"} | {
        f"layers.{i}" for i in range(cfg.n_layers)}
    assert parts <= set(by) and all(by[p].flops > 0 for p in parts)
    assert set(a.matmul_flops) <= parts


# -- parity with the reference's compiled step ---------------------------------

def _reference_step(cfg, seq=S):
    opt = jadamw.AdamWConfig(lr=3e-4, warmup_steps=5, decay_steps=10)
    mesh = jhost_mesh()
    bshapes = input_specs(cfg, B, seq, "train")
    with mesh:
        jitted, (st_shapes, _, _) = jsteps.jit_train_step(cfg, opt, mesh, bshapes)
        return jha.Analyzer(jsteps.compiled_hlo(jitted, st_shapes, bshapes))


def _dot_flops(a, name):
    """The ``dot`` flops of computation ``name``: while bodies times their
    trip counts, fusions and calls descended into."""
    total = 0.0
    for op in a.comps[name].ops:
        if op.opcode == "while":
            cond = jha._called(op.line, "condition")
            trips = jha._trip_count(a.comps[cond]) if cond in a.comps else 1
            total += max(trips, 1) * _dot_flops(a, jha._called(op.line, "body"))
        elif op.opcode in ("fusion", "call", "custom-call"):
            callee = jha._called(op.line, "calls") or jha._called(op.line, "to_apply")
            if callee in a.comps:
                total += _dot_flops(a, callee)
        elif op.opcode == "dot":
            total += jha._dot_flops(op, a.comps[name])
    return total


def _opcode_flops(a, name, out):
    """Add the reference's non-dot flops of computation ``name`` to
    ``out`` by opcode, as its ``Analyzer`` counts them (one per result
    element, fused computations' parameters included)."""
    for op in a.comps[name].ops:
        if op.opcode == "while":
            cond = jha._called(op.line, "condition")
            trips = jha._trip_count(a.comps[cond]) if cond in a.comps else 1
            for _ in range(max(trips, 1)):
                _opcode_flops(a, jha._called(op.line, "body"), out)
        elif op.opcode in ("fusion", "call", "custom-call"):
            callee = jha._called(op.line, "calls") or jha._called(op.line, "to_apply")
            if callee in a.comps:
                _opcode_flops(a, callee, out)
        elif op.opcode not in ("dot", "convolution") and not op.opcode.endswith("-done"):
            out[op.opcode] = out.get(op.opcode, 0.0) + jha._type_numel(op.type_str)
    return out


# HLO instructions with no op of their own in eager execution: a fused
# computation's parameters, tuples and their elements (XLA's plumbing), and
# broadcasts (an eager elementwise op reads a broadcast operand in place)
NO_EAGER_OP = ("parameter", "tuple", "get-tuple-element", "broadcast")


def _configs(pad_heads):
    d = 128
    over = dict(d_model=d, n_heads=d // 64, n_kv_heads=max(d // 128, 1), d_ff=3 * d,
                vocab_size=2048)
    jcfg = jreduced_config("yi-34b", **over)
    tcfg = train.build_config(train.parse_args(SMALL))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return (dataclasses.replace(jcfg, pad_heads=pad_heads),
            dataclasses.replace(tcfg, pad_heads=pad_heads))


@pytest.mark.parametrize("seq", [S, 1024])
def test_matmul_flops_match_the_references_dots(seq):
    """At seq 32 the loss is one chunk and each layer's attention one
    q-chunk; at 1024 both are checkpointed chunks (two each), recomputed in
    the backward, and the recompute is counted in its layer's and the
    loss's scopes."""
    jcfg, tcfg = _configs(pad_heads=0)
    ref = _reference_step(jcfg, seq)
    port = steps.count_train_step(tcfg, adamw.AdamWConfig(), B, seq)
    ref_dots, ref_st, st = _dot_flops(ref, ref.entry), ref.stats(), port.stats()
    by_op = _opcode_flops(ref, ref.entry, {})
    no_eager = sum(by_op.get(k, 0.0) for k in NO_EAGER_OP)
    n = tcfg.total_params()
    print(f"\n[parity] reduced yi-34b, heads unpadded, {B} x {seq}: matmul port "
          f"{port.matmul_total():.4e} "
          f"reference dots {ref_dots:.4e} (ratio {port.matmul_total() / ref_dots:.4f}); "
          f"total flops port {st.flops:.4e} reference {ref_st.flops:.4e} "
          f"(ratio {st.flops / ref_st.flops:.4f}; without {'/'.join(NO_EAGER_OP)} "
          f"{no_eager:.4e}: ratio {st.flops / (ref_st.flops - no_eager):.4f}); "
          f"hbm bytes port {st.bytes:.4e} reference "
          f"{ref_st.bytes:.4e} (ratio {st.bytes / ref_st.bytes:.4f})")
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    print("[parity] the reference's largest non-dot flops by opcode: "
          + ", ".join(f"{k} {v:.4e}" for k, v in top))
    # the breakdown is the reference's whole count
    assert ref_dots + sum(by_op.values()) == pytest.approx(ref_st.flops, rel=1e-9)
    assert port.matmul_total() == pytest.approx(ref_dots, rel=0.01)
    assert set(port.matmul_flops) == {"layers.0", "layers.1", "loss"}
    assert st.flops == pytest.approx(ref_st.flops - no_eager, rel=0.10)
    if seq >= 1024:
        assert st.flops == pytest.approx(ref_st.flops, rel=0.10)
    # parameters, gradients and both AdamW moments, fp32, each read once
    assert st.bytes >= 4 * 4 * n


def test_padded_heads_are_the_whole_matmul_gap():
    """At the config's pad_heads (the reference pads 2 heads to 64 so that
    the head dim divides its model axis; the port computes the 2): the
    reference's extra dots are its padded heads' QK^T and PV, forward,
    recomputed and backward (8 per layer, 2 B S^2 dh flops per head)."""
    jcfg, tcfg = _configs(pad_heads=64)
    ref = _reference_step(jcfg)
    port = steps.count_train_step(tcfg, adamw.AdamWConfig(), B, S)
    ref_dots = _dot_flops(ref, ref.entry)
    padded = 8 * jcfg.n_layers * 2 * B * S * S * jcfg.d_head * (64 - jcfg.n_heads)
    print(f"\n[parity] reduced yi-34b, pad_heads 64: reference dots {ref_dots:.4e}, port "
          f"{port.matmul_total():.4e}, padded heads' dots {padded:.4e}; total flops "
          f"reference {ref.stats().flops:.4e}, port {port.stats().flops:.4e}")
    assert port.matmul_total() + padded == pytest.approx(ref_dots, rel=0.01)


# -- the trainer ------------------------------------------------------------------

def _val(out, tag, key):
    m = re.search(rf"\[{tag}\][^\n]*\b{key}=([\d.e+-]+)", out)
    assert m, f"no {key} on the [{tag}] line:\n{out}"
    return float(m.group(1))


def test_trainer_schema_tpu_counts_the_step():
    env = dict(os.environ, PYTHONPATH=str(SRC), **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *SMALL,
                          "--steps", "4", "--analyze-every", "2", "--schema", "tpu"],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    text = out.stdout
    assert re.search(r"\[costs\] coverage: step: flops=[\d.e+]+ matched=0 comps "
                     r"\(0\.0%\) residual=[\d.e+]+ unmatched=\d+", text)
    assert "[costs] hlo step:" in text
    assert _val(text, "costs", "hlo_flops") > 0
    assert _val(text, "costs", "hbm_bytes") > 0
    assert _val(text, "costs", "collective_bytes") == 0
    assert "[report] step-region attrs (last window, hlo)" in text
    # two steps' recorded flops: the counted step's, twice
    assert _val(text, "report", "hlo_flops") == pytest.approx(
        2 * _val(text, "costs", "hlo_flops"), rel=1e-3)
    assert _val(text, "report", "hbm_boundedness") > 0
