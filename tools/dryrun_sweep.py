#!/usr/bin/env python3
"""Every architecture's sharded train, prefill and serve steps at reduced
width on a small mesh of a fake process group, counted on the meta device.

    PYTHONPATH=src python tools/dryrun_sweep.py [--mesh 2,4 | 2,2,2] [--arch A ...]

A two-entry mesh is ("data", "model"), a three-entry one ("pod", "data",
"model").  Prints one line per (arch, mode): OK with the per-device matmul
flops, collective bytes by kind and the count's host seconds, or FAIL with
the error and the last frames of the port and of DTensor; exits 1 if any
failed.  The dry-run's steps meet DTensor's sharding propagation, which
differs between torch versions, so run this where the dry-run will run
(the card's machine has its own torch) before the full-width cells.
"""
import argparse
import math
import sys
import time
import traceback


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2,4")
    ap.add_argument("--arch", nargs="*")
    ap.add_argument("--modes", default="train,prefill,decode")
    args = ap.parse_args()
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import list_archs, reduced_config
    from repro_torch.launch import hlo_analysis, steps
    from repro_torch.models.model import input_specs
    from repro_torch.optim import adamw

    shape = tuple(int(n) for n in args.mesh.split(","))
    names = ("pod", "data", "model")[-len(shape):]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    failed = 0
    try:
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=names)
        batch = 2 * math.prod(shape[:-1])
        for arch in args.arch or list_archs():
            cfg = reduced_config(arch)
            for mode in args.modes.split(","):
                t0 = time.perf_counter()
                try:
                    specs = input_specs(cfg, batch, 32, mode)
                    if mode == "train":
                        step, inputs = steps.sharded_train_step(cfg, adamw.AdamWConfig(),
                                                                mesh, specs)
                    elif mode == "prefill":
                        step, inputs = steps.sharded_prefill_step(cfg, mesh, specs)
                    else:
                        step, inputs = steps.sharded_serve_step(cfg, mesh, specs)
                    counted = hlo_analysis.Analyzer(step, *inputs)
                    coll = {k: v for k, v in counted.stats().collective_bytes.items() if v}
                    print(f"OK {arch} {mode} mesh {shape}: matmul {counted.matmul_total():.4e} "
                          f"collectives {coll} in {time.perf_counter() - t0:.1f} s", flush=True)
                except Exception as e:  # reported per cell, the sweep goes on
                    failed += 1
                    frames = [line for line in traceback.format_exc().splitlines()
                              if "repro_torch" in line or "distributed/tensor" in line]
                    print(f"FAIL {arch} {mode} mesh {shape}: {type(e).__name__}: "
                          f"{str(e)[:400]}\n  " + "\n  ".join(frames[-10:]), flush=True)
    finally:
        dist.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
