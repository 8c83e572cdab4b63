"""The port's dry-run (``repro_torch.launch.dryrun``), its shape registry,
``input_specs`` and the sharded steps of ``launch.steps``, against the
JAX package's.

The registry (``Shape``, ``SHAPES``, ``TRAIN_MICROBATCHES``,
``cell_status``, ``all_cells``) keeps the reference's text and gives the
same 40 cells with the same skip reasons; ``input_specs`` gives the
reference's shapes and dtypes.

Parity with the reference's compiled sharded steps: the reference runs in
a process of its own on 8 host devices (``tests/_reference_steps.py``),
the port on a fake process group of 8 with the same (2, 4) ("data",
"model") mesh, both on the reduced yi-34b (2 layers, d_model 128, 2 heads
of 64 on 1 KV head) at batch 4 x 32.  Per device:

* the port's matmul flops equal the reference's ``dot`` flops within 1 %
  where both shard alike (heads padded to 8: 2 per device; decode).  Two
  causes of a gap are named and held exactly: (1) XLA keeps the
  ``jax.checkpoint`` recompute of the one loss chunk's logits product on
  8 devices (on one it merges it with the forward, as PR 22's parity
  found), one product of 2 (B/mb/2) S d (V/4) flops per microbatch more
  than the port's; (2) with the 2 heads unpadded, neither program can
  split heads over the 4-way model axis: the port computes its local
  batch rows' attention whole on every device (QK^T and PV, forward,
  recomputed and backward: 2 B_l H S^2 dh flops each), where XLA splits
  some of those products over the model axis (its batched dots, printed);
  every other product is the same;
* the argument bytes (the local shards of the inputs: state or
  parameters, batch, cache) equal the reference's ``memory_analysis``
  exactly for a train, a prefill and a decode step: tokens and labels are
  int32 in both, so no leaf differs;
* collective bytes by kind are printed beside the reference's; both are
  > 0 on the (2, 4) mesh and 0 on a (1, 1) mesh.

Outside a sharding context nothing changes: prefill and decode logits and
a train step's loss and gradients are bit for bit those of the commit
before the sharded steps (hashes below).  ``run_cell`` on the production
meshes (a fake world of 256 and 512) with the reduced config gives an
``ok`` record per mode and the reference's skip for ``long_500k`` on a
full-attention arch; the CLI refuses ``--save-hlo`` and ``--all`` walks
the 40 cells per mesh.
"""
import ast
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.transformer import cache_shapes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.hlo_analysis import Analyzer  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.model import init_params, input_specs  # noqa: E402
from repro_torch.models.transformer import KERNELS, PLAIN  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from _torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
TESTS = REPO / "tests"
sys.path.insert(0, str(TESTS))
from _reference_steps import B, OVERRIDES, S  # noqa: E402

MESH = (2, 4)
# (mode, pad_heads, microbatches)
CASES = [("train", 8, 2), ("prefill", 8, 1), ("decode", 0, 1),
         ("train", 0, 1), ("prefill", 0, 1)]
ONE = [("train", 0, 1), ("decode", 0, 1)]       # on a (1, 1) mesh


@pytest.fixture
def fake_world():
    """A default process group of the ``fake`` backend standing for a
    world of ``n`` processes; torn down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


# -- the registry ------------------------------------------------------------------

def _defs(path):
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            target = node.targets[0] if isinstance(node, ast.Assign) else node.target
            if isinstance(target, ast.Name):
                out[target.id] = ast.get_source_segment(text, node)
    return out


def test_registry_keeps_the_references_text_and_cells():
    ref = _defs(SRC / "repro" / "configs" / "__init__.py")
    port = _defs(SRC / "repro_torch" / "configs" / "__init__.py")
    for name in ("Shape", "SHAPES", "TRAIN_MICROBATCHES", "cell_status", "all_cells"):
        assert port[name] == ref[name], name
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.TRAIN_MICROBATCHES == jconfigs.TRAIN_MICROBATCHES
    cells = [(a, s.name, r) for a, s, r in configs.all_cells()]
    assert cells == [(a, s.name, r) for a, s, r in jconfigs.all_cells()]
    assert len(cells) == 40 and sum(r is not None for *_, r in cells) == 6


@pytest.mark.parametrize("arch", ["yi-34b", "pixtral-12b", "whisper-large-v3",
                                  "recurrentgemma-9b", "rwkv6-3b"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_input_specs_are_the_references(arch, mode):
    jcfg = jconfigs.reduced_config(arch)
    port = input_specs(configs.reduced_config(arch), 4, 24, mode)
    ref = jmodel.input_specs(jcfg, 4, 24, mode)

    def same(t, s):
        assert tuple(t.shape) == tuple(s.shape)
        assert str(t.dtype).split(".")[-1] == str(s.dtype)
        assert t.device.type == "meta"

    assert set(port) == set(ref)
    for key, t in port.items():
        if key != "cache":
            same(t, ref[key])
    if mode == "decode":
        # the reference stacks each group's repetitions of a unit position
        from repro.models.transformer import group_meta
        want = []
        for (unit, n), group in zip(group_meta(jcfg), cache_shapes(jcfg, 4, 24)["groups"]):
            for r in range(n):
                want += [{k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
                          for k, v in group[f"pos{i}"].items()} for i in range(len(unit))]
        assert len(port["cache"]) == len(want) == jcfg.n_layers
        for got, layer in zip(port["cache"], want):
            assert set(got) == set(layer)
            for k in got:
                same(got[k], layer[k])


# -- parity with the reference's compiled sharded steps -----------------------------

@pytest.fixture(scope="module")
def reference():
    cases = [dict(mode=m, pad_heads=p, microbatches=mb, mesh=list(MESH)) for m, p, mb in CASES]
    cases += [dict(mode=m, pad_heads=p, microbatches=mb, mesh=[1, 1]) for m, p, mb in ONE]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(TESTS)]),
               JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=8",
               **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, str(TESTS / "_reference_steps.py"), json.dumps(cases)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    return {(r["mode"], r["pad_heads"], r["microbatches"], tuple(r["mesh"])): r for r in rows}


def _port(fake_world, mode, pad_heads, microbatches, mesh=MESH, cfg=None, batch=B, seq=S):
    """(Analyzer of one sharded step, its argument bytes) on a fake world,
    of the reduced yi-34b of ``OVERRIDES`` unless ``cfg`` is given."""
    fake_world(mesh[0] * mesh[1])
    dm = make_host_mesh(model_parallel=mesh[1])
    cfg = dataclasses.replace(cfg or configs.reduced_config("yi-34b", **OVERRIDES),
                              pad_heads=pad_heads)
    batch = input_specs(cfg, batch, seq, mode)
    if mode == "train":
        step, args = steps.sharded_train_step(cfg, adamw.AdamWConfig(), dm, batch,
                                              microbatches=microbatches)
    elif mode == "prefill":
        step, args = steps.sharded_prefill_step(cfg, dm, batch)
    else:
        step, args = steps.sharded_serve_step(cfg, dm, batch)
    return Analyzer(step, *args), dryrun.local_bytes(args), cfg


def _attention(cfg, mode, microbatches):
    """The port's attention products per device on the (2, 4) mesh with
    unpadded heads (replicated over the model axis): QK^T and PV of its
    batch rows, 2 B_l H S^2 dh flops each; in training each forward,
    recomputed, and twice in the backward."""
    per_product = 2 * (B // MESH[0]) * cfg.n_heads * S * S * cfg.d_head
    products = {"train": 8, "prefill": 2}[mode]
    return cfg.n_layers * products * per_product


@pytest.mark.parametrize("mode,pad_heads,microbatches", CASES)
def test_matmul_flops_match_the_references_dots(reference, fake_world, mode, pad_heads,
                                                microbatches):
    ref = reference[(mode, pad_heads, microbatches, MESH)]
    counted, _, cfg = _port(fake_world, mode, pad_heads, microbatches)
    port = counted.matmul_total()
    # (1) the loss chunk's logits product XLA recomputes: one per microbatch
    loss = 0.0
    if mode == "train":
        loss = microbatches * 2 * (B // microbatches // MESH[0]) * S * cfg.d_model \
            * (cfg.vocab_size // MESH[1])
    # (2) unpadded heads: the attention products are the gap's other part
    attention = _attention(cfg, mode, microbatches) if (pad_heads == 0 and mode != "decode") else 0
    print(f"\n[parity] {mode}, pad_heads {pad_heads}, {microbatches} microbatch(es), mesh "
          f"{MESH}: port matmul {port:.6e}, reference dots {ref['dots']:.6e} (ratio "
          f"{port / ref['dots']:.4f}); the reference's loss recompute {loss:.6e}; the "
          f"reference's batched dots {ref['batched_dots']:.6e}"
          + (f", the port's attention products {attention:.6e} (closed form)" if attention else ""))
    if attention:
        assert port - attention == pytest.approx(
            ref["dots"] - ref["batched_dots"] - loss, rel=1e-12)
    else:
        assert port + loss == pytest.approx(ref["dots"], rel=1e-12)


@pytest.mark.parametrize("mode,pad_heads,microbatches", CASES[:3])
def test_argument_bytes_equal_the_references(reference, fake_world, mode, pad_heads,
                                             microbatches):
    ref = reference[(mode, pad_heads, microbatches, MESH)]
    _, arg_bytes, _ = _port(fake_world, mode, pad_heads, microbatches)
    assert arg_bytes == ref["argument_bytes"]


@pytest.mark.parametrize("mode,pad_heads,microbatches", CASES[:3])
def test_collective_bytes_beside_the_references(reference, fake_world, mode, pad_heads,
                                                microbatches):
    ref = reference[(mode, pad_heads, microbatches, MESH)]
    counted, _, _ = _port(fake_world, mode, pad_heads, microbatches)
    port = counted.stats().collective_bytes
    print(f"\n[collectives] {mode}, pad_heads {pad_heads}, mesh {MESH}: " + ", ".join(
        f"{k} port {port[k]:.4e} reference {ref['collective_bytes'][k]:.4e}" for k in port)
        + f"; total ratio {sum(port.values()) / sum(ref['collective_bytes'].values()):.3f}")
    assert sum(ref["collective_bytes"].values()) > 0 and sum(port.values()) > 0


@pytest.mark.parametrize("mode,pad_heads,microbatches", ONE)
def test_one_device_mesh_moves_nothing(reference, fake_world, mode, pad_heads, microbatches):
    ref = reference[(mode, pad_heads, microbatches, (1, 1))]
    counted, arg_bytes, _ = _port(fake_world, mode, pad_heads, microbatches, mesh=(1, 1))
    assert counted.stats().total_collective_bytes == 0
    assert sum(ref["collective_bytes"].values()) == 0
    assert arg_bytes == ref["argument_bytes"]
    assert counted.matmul_total() == pytest.approx(ref["dots"], rel=1e-12)


# -- the windowed KV band -------------------------------------------------------------

# the reduced mixtral (window 16) at a sequence of two q-chunks of 512: each
# chunk scores the band of 16 + 512 keys, in both packages
WINDOWED = dict(arch="mixtral-8x7b", batch=2, seq=1024)


@pytest.fixture(scope="module")
def windowed_reference():
    cases = [dict(mode=m, pad_heads=0, microbatches=1, mesh=[1, 1], **WINDOWED)
             for m in ("prefill", "train")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(TESTS)]),
               JAX_PLATFORMS="cpu", **ONE_THREAD_ENV)
    env.pop("REPRO_NO_KV_SLICE", None)
    out = subprocess.run([sys.executable, str(TESTS / "_reference_steps.py"), json.dumps(cases)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {r["mode"]: r for r in json.loads(out.stdout.strip().splitlines()[-1])}


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_windowed_band_counts_the_references_dots(windowed_reference, fake_world, mode):
    """The counted matmul flops of a windowed arch past one q-chunk equal
    the reference's compiled dots, whose attention scores only the band;
    with all 1024 keys scored per chunk the port would count the products
    of the other 496 keys of every query row on top."""
    ref = windowed_reference[mode]
    cfg = configs.reduced_config(WINDOWED["arch"])
    counted, _, _ = _port(fake_world, mode, 0, 1, mesh=(1, 1), cfg=cfg,
                          batch=WINDOWED["batch"], seq=WINDOWED["seq"])
    port = counted.matmul_total()
    S, band = WINDOWED["seq"], cfg.window + 512
    products = {"prefill": 2, "train": 8}[mode]     # as _attention counts them
    outside = cfg.n_layers * products * 2 * WINDOWED["batch"] * cfg.n_heads * S \
        * (S - band) * cfg.d_head
    print(f"\n[band] {mode}, {WINDOWED}: port matmul {port:.6e}, reference dots "
          f"{ref['dots']:.6e} (ratio {port / ref['dots']:.6f}); keys outside the band "
          f"would add {outside:.6e}")
    assert cfg.window == 16 and S > 512 + cfg.window and S % 512 == 0
    assert port == pytest.approx(ref["dots"], rel=1e-12)


# -- outside a sharding context ------------------------------------------------------

# sha256 (first 12 hex digits) of the fp32 bytes of: prefill logits through
# PLAIN and KERNELS, the decode step's logits after each, and (decoder-only
# archs) a train step's loss and its gradients concatenated, on the reduced
# configs from seed 0, one CPU thread; taken at the commit before the
# sharded steps, whose model code had no sharding-context branches
BEFORE = {
    "recurrentgemma-9b": "c7be023004f9 a4d05a5c948f 4cad5ac6854a e2898acb582a c2b9c92e1e29 5a1d27e292e6",
    "mixtral-8x7b": "317181fc78f5 7a5fcb475900 1f9bbfc1d559 75e10c5a24e5 317544806069 dbf9475f2c41",
    "moonshot-v1-16b-a3b": "861fed1f31d0 a8d301da2eae 5c725fc6393c 64500ec4cb69 e88de9edf01c 1e01158401cb",
    "qwen1.5-110b": "17843f108dfc 90cdb033cc13 92d3d55be83f 687f4c90c55c 6ccfa68f59a8 337d1d4fc812",
    "gemma2-27b": "4431c232f384 22ce07d8b023 ff1927f58244 a534be7cf638 190808ebddb3 50310627a72d",
    "nemotron-4-15b": "ce856d0900e9 d0b742af9c60 d2cb358ae8b5 c51dafa9dec2 75814e355830 88225f834c7f",
    "yi-34b": "aeeba6fd5788 40a0d07353f6 c3386529e318 410b5db40fab 051b1b6d8899 59e89d12acc4",
    "rwkv6-3b": "58746d412187 d8c151c698f0 58746d412187 d8c151c698f0 97c1284d20de 89433327538f",
    "pixtral-12b": "17843f108dfc 90cdb033cc13 92d3d55be83f 687f4c90c55c 6ccfa68f59a8 6c6f0a55d056",
    "whisper-large-v3": "a0fdb52f7304 d23d43f5cf97 04591975d22d f1a66786130b",
}


def _digest(t):
    return hashlib.sha256(t.detach().float().reshape(-1).numpy().tobytes()).hexdigest()[:12]


@pytest.mark.parametrize("arch", sorted(BEFORE))
def test_outside_a_context_nothing_changes(arch):
    cfg = configs.reduced_config(arch)
    model = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 33)))
    frames = (torch.from_numpy(rng.standard_normal((2, cfg.encoder_seq, cfg.d_model))
                               .astype(np.float32)) if cfg.is_encdec else None)
    got = []
    for kernels in (PLAIN, KERNELS):
        logits, cache = model.prefill(tok[:, :32], 34, kernels, frames=frames)
        got.append(_digest(logits))
        logits, _ = model.decode_step(tok[:, 32:], 32, cache, kernels)
        got.append(_digest(logits))
    if not cfg.is_encdec:
        loss, grads = steps.value_and_grad(model, {"tokens": tok[:, :32], "labels": tok[:, 1:]})
        got += [_digest(loss), _digest(torch.cat([g.float().flatten() for g in grads.values()]))]
    assert " ".join(got) == BEFORE[arch]


# -- run_cell and the CLI -------------------------------------------------------------

@pytest.fixture
def reduced(monkeypatch):
    small = {arch: configs.reduced_config(arch) for arch in configs.list_archs()}
    monkeypatch.setattr(configs, "get_config", small.__getitem__)


@pytest.mark.parametrize("shape,mesh", [("train_4k", "single"), ("prefill_32k", "multi"),
                                        ("decode_32k", "single"), ("long_500k", "multi")])
def test_run_cell_on_the_production_meshes(reduced, shape, mesh):
    arch = "recurrentgemma-9b" if shape == "long_500k" else "yi-34b"
    rec = dryrun.run_cell(arch, shape, mesh)
    assert not dist.is_initialized()
    assert rec["ok"] and not rec.get("error"), rec.get("error")
    assert rec["mesh_shape"] == ([2, 16, 16] if mesh == "multi" else [16, 16])
    assert rec["count_s"] >= 0 and rec["cost"]["matmul flops"] > 0
    assert rec["hlo_stats"]["flops"] == rec["cost"]["flops"] > rec["cost"]["matmul flops"]
    assert rec["hlo_stats"]["total_collective_bytes"] > 0
    assert rec["collectives"]["bytes"] == rec["hlo_stats"]["collective_bytes"]
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["output_size_in_bytes"] > 0
    assert "while_trip_counts" not in rec and "temp_size_in_bytes" not in rec["memory"]
    assert rec.get("microbatches") == (configs.TRAIN_MICROBATCHES[(arch, shape)]
                                       if shape == "train_4k" else None)


def test_one_pod_is_the_unsharded_step_split_256_ways(reduced, monkeypatch):
    """``chip_smoke.py`` phase I's check at reduced width (and 128 x 1024,
    still 4 microbatches and q- and loss-chunks): yi-34b's train matmul
    flops per device x 256 are the unsharded step's plus its padded heads'
    share of the attention (the batched products), and two pods' per
    device half one pod's."""
    shape = configs.Shape("train_4k", 1024, 128, "train")
    monkeypatch.setitem(configs.SHAPES, "train_4k", shape)
    cfg = configs.get_config("yi-34b")
    one = dryrun.run_cell("yi-34b", "train_4k", "single")["cost"]["matmul flops"]
    two = dryrun.run_cell("yi-34b", "train_4k", "multi")["cost"]["matmul flops"]
    micro = configs.TRAIN_MICROBATCHES[("yi-34b", "train_4k")]
    whole = steps.count_train_step(cfg, adamw.AdamWConfig(), shape.global_batch,
                                   shape.seq_len, microbatches=micro)
    pad = whole.matmul_by_op["aten.bmm"] * (cfg.pad_heads - cfg.n_heads) / cfg.n_heads
    assert 256 * one == pytest.approx(whole.matmul_total() + pad, rel=1e-12)
    assert two == pytest.approx(one / 2, rel=1e-12)


def test_run_cell_skips_long_context_on_full_attention(reduced):
    rec = dryrun.run_cell("yi-34b", "long_500k", "single")
    assert rec["ok"] and rec["skipped"] == jconfigs.cell_status(
        jconfigs.get_config("yi-34b"), jconfigs.SHAPES["long_500k"])
    assert not dist.is_initialized()


def test_cli_refuses_save_hlo(capsys, tmp_path):
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "yi-34b", "--shape", "train_4k", "--save-hlo",
                     "--out", str(tmp_path)])
    assert exc.value.code == 2
    assert "--save-hlo has no counterpart" in capsys.readouterr().err


def test_cli_all_walks_every_cell_per_mesh(monkeypatch, tmp_path, capsys):
    runs = []
    monkeypatch.setattr(dryrun.subprocess, "run",
                        lambda cmd: runs.append(cmd) or subprocess.CompletedProcess(cmd, 0))
    cached = dryrun.cell_path(tmp_path, "yi-34b", "train_4k", "single")
    cached.write_text("{}")
    assert dryrun.main(["--all", "--mesh", "both", "--out", str(tmp_path)]) == 0
    assert len(runs) == 2 * 40 - 1
    assert "[cached] yi-34b__train_4k__single.json" in capsys.readouterr().out
    assert all(cmd[1:3] == ["-m", "repro_torch.launch.dryrun"] for cmd in runs)
    assert dryrun.RESULTS_DIR == REPO / "dryrun_out" / "dryrun"


# -- every architecture ---------------------------------------------------------------

def _counts(fake_world, cfg, mode, sharded):
    """(matmul flops, collective bytes) of one step of ``mode`` at B x S:
    per device on the (2, 4) fake mesh, or whole on ``meta``."""
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import DRYRUN
    batch = input_specs(cfg, B, S, mode)
    if sharded:
        fake_world(MESH[0] * MESH[1])
        dm = make_host_mesh(model_parallel=MESH[1])
        if mode == "train":
            step, args = steps.sharded_train_step(cfg, adamw.AdamWConfig(), dm, batch)
        elif mode == "prefill":
            step, args = steps.sharded_prefill_step(cfg, dm, batch)
        else:
            step, args = steps.sharded_serve_step(cfg, dm, batch)
    elif mode == "train":
        step, args = steps.make_train_step(cfg, adamw.AdamWConfig()), (
            steps.state_for(Model(cfg, "meta"), adamw.AdamWConfig()), batch)
    elif mode == "prefill":
        step, args = steps.make_prefill_step(cfg, kernels=DRYRUN), (Model(cfg, "meta"), batch)
    else:
        step, args = steps.make_serve_step(cfg, DRYRUN), (Model(cfg, "meta"), batch)
    counted = Analyzer(step, *args)
    return counted.matmul_total(), counted.stats().total_collective_bytes


@pytest.mark.parametrize("arch", configs.list_archs())
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_every_architecture_serves_sharded(fake_world, arch, mode):
    """Each block kind's serving step counts on the (2, 4) mesh: its
    matmuls split over the devices (less per device than whole), its
    collectives counted."""
    cfg = configs.reduced_config(arch)
    whole, none = _counts(fake_world, cfg, mode, sharded=False)
    mine, moved = _counts(fake_world, cfg, mode, sharded=True)
    assert none == 0 and moved > 0
    assert whole / MESH[0] / MESH[1] <= mine < whole


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-9b", "rwkv6-3b"])
def test_every_block_kind_trains_sharded(fake_world, arch):
    """The MoE, RG-LRU and RWKV6 blocks' train steps (their dispatch,
    gates and recurrence on each device's shards) count on the (2, 4)
    mesh, their gradients reduced onto the parameters' placements."""
    cfg = dataclasses.replace(configs.reduced_config(arch), param_dtype="float32")
    whole, _ = _counts(fake_world, cfg, "train", sharded=False)
    mine, moved = _counts(fake_world, cfg, "train", sharded=True)
    assert moved > 0 and whole / MESH[0] / MESH[1] <= mine < whole
