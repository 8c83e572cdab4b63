"""Multi-pod dry-run of the port: count one step of every (arch x shape)
cell on the production meshes and record its per-device costs.

  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both      # subprocess per cell

Counterpart of ``repro/launch/dryrun.py``.  The dry-run touches no device,
by design, as the reference's does: the reference lowers and compiles each
cell for 512 fake XLA host devices; here the one process stands for the
production world through a default process group of backend ``"fake"``
(``FakeStore``: no peers, no traffic) of world size 256 (one pod, the
(data 16, model 16) mesh) or 512 (two pods, (pod 2, data 16, model 16)),
and every tensor lives on the ``meta`` device.  The step is one of
``launch.steps``' sharded builders, its inputs ``DTensor``s placed by
``launch.sharding``; ``launch.hlo_analysis.Analyzer`` runs it once and
counts the ops on each ``DTensor``'s local shard, so the costs are per
device, and its redistributions as collectives.

The record keeps the reference's keys (``arch``, ``shape``, ``mesh``,
``mode``, ``seq_len``, ``global_batch``, ``active_params``,
``total_params``, ``mesh_shape``, ``microbatches``, ``ok``, ``skipped``,
``error``), with:

  count_s      host seconds of the count, in place of ``lower_s`` and
               ``compile_s``;
  collectives  ``{"bytes", "counts"}`` per collective kind, from the count;
  cost         per-device ``flops`` and ``bytes accessed``, and ``matmul
               flops`` (the matmul family alone);
  hlo_stats    ``hlo_analysis.Stats.as_dict()``, the keys
               ``launch/roofline.py`` reads;
  memory       ``argument_size_in_bytes`` and ``output_size_in_bytes``: the
               bytes of the local shards of the step's inputs and of its
               outputs.  No temp size: execution on ``meta`` has no
               allocator.

There is no ``while_trip_counts``: the count runs every trip of every loop
(layers, microbatches, loss chunks, q-chunks) as it runs, where the
reference's HLO holds a loop body once.  ``--save-hlo`` has no counterpart,
since there is no HLO, and is refused.  Records are JSON files
``<arch>__<shape>__<mesh>.json`` under ``--out`` (default
``dryrun_out/dryrun`` at the repo root, which ``.gitignore`` lists), which
``launch/roofline.py`` reads.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import traceback
from typing import Dict

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "dryrun_out" / "dryrun"


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree`` (nested dicts,
    lists and tuples; a module counts its parameters)."""
    import torch
    from torch import nn
    if isinstance(tree, nn.Module):
        return sum(local_bytes(p) for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    return 0


def _step(cfg, shape, microbatches: int, mesh):
    """(step, its inputs) of the cell's mode, from ``launch.steps``."""
    from ..models.model import input_specs
    from ..optim import adamw
    from . import steps
    batch = input_specs(cfg, shape.global_batch, shape.seq_len, shape.mode)
    if shape.mode == "train":
        return steps.sharded_train_step(cfg, adamw.AdamWConfig(), mesh, batch,
                                        microbatches=microbatches)
    if shape.mode == "prefill":
        return steps.sharded_prefill_step(cfg, mesh, batch)
    return steps.sharded_serve_step(cfg, mesh, batch)


def run_cell(arch: str, shape_name: str, mesh_kind: str) -> Dict:
    """The record of one cell (see the module docstring); a failure is
    recorded (``ok`` False, ``error``), not raised.  Initializes the
    default process group of the ``fake`` backend and destroys it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from .. import configs
    from .hlo_analysis import Analyzer
    from .mesh import make_production_mesh

    cfg = configs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "mode": shape.mode, "seq_len": shape.seq_len,
                 "global_batch": shape.global_batch,
                 "active_params": cfg.active_params(),
                 "total_params": cfg.total_params()}
    skip = configs.cell_status(cfg, shape)
    if skip:
        rec.update(ok=True, skipped=skip)
        return rec

    multi = mesh_kind == "multi"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi)
        rec["mesh_shape"] = list(mesh.shape)
        micro = 1
        if shape.mode == "train":
            micro = configs.TRAIN_MICROBATCHES.get((arch, shape_name), 1)
            rec["microbatches"] = micro
        t0 = time.time()
        try:
            step, args = _step(cfg, shape, micro, mesh)
            counted = Analyzer(step, *args)
            rec["count_s"] = round(time.time() - t0, 2)
            st = counted.stats()
            rec["collectives"] = {"bytes": dict(st.collective_bytes),
                                  "counts": dict(st.collective_counts)}
            rec["memory"] = {"argument_size_in_bytes": local_bytes(args),
                             "output_size_in_bytes": local_bytes(counted.result)}
            rec["cost"] = {"flops": st.flops, "bytes accessed": st.bytes,
                           "matmul flops": counted.matmul_total()}
            rec["hlo_stats"] = st.as_dict()
            rec["ok"] = True
        except Exception as e:      # recorded, as the reference records it
            traceback.print_exc()
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    finally:
        dist.destroy_process_group()
    return rec


def cell_path(out_dir: pathlib.Path, arch: str, shape: str, mesh: str) -> pathlib.Path:
    return out_dir / f"{arch}__{shape}__{mesh}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: the port compiles no HLO")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo has no counterpart in the port: there is no HLO "
                 "(the step's ops are counted on the meta device)")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        from ..configs import ARCH_MODULES, SHAPES  # light import
        failures = 0
        for arch in ARCH_MODULES:
            for shape in SHAPES:
                for mesh in meshes:
                    p = cell_path(out_dir, arch, shape, mesh)
                    if p.exists() and not args.force:
                        print(f"[cached] {p.name}")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape, "--mesh", mesh,
                           "--out", str(out_dir)]
                    print(f"[run] {arch} x {shape} x {mesh}", flush=True)
                    r = subprocess.run(cmd)
                    if r.returncode:
                        failures += 1
        return 1 if failures else 0

    rec = run_cell(args.arch, args.shape, args.mesh if args.mesh != "both" else "single")
    p = cell_path(out_dir, args.arch, args.shape, rec["mesh"])
    p.write_text(json.dumps(rec, indent=2))
    status = "SKIP" if rec.get("skipped") else ("OK" if rec.get("ok") else "FAIL")
    print(f"[{status}] {args.arch} x {args.shape} x {rec['mesh']}  "
          f"count={rec.get('count_s')}s (host clock, meta device)")
    if rec.get("error"):
        print("  error:", rec["error"][:500])
    if rec.get("memory"):
        print("  memory per device:", {k: f"{v / 2 ** 30:.2f}GiB"
                                       for k, v in rec["memory"].items()})
    if rec.get("cost"):
        c = rec["cost"]
        print(f"  per-device flops={c['flops']:.3e} (matmul {c['matmul flops']:.3e}) "
              f"bytes={c['bytes accessed']:.3e}")
    if rec.get("collectives"):
        print("  collectives:", rec["collectives"]["bytes"])
    return 0 if rec.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
