"""The JAX package's compiled sharded steps on host devices, measured as
``tests/test_torch_dryrun.py`` compares them with the port's.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_reference_steps.py '<json list of cases>'

Each case is ``{"mode": "train" | "prefill" | "decode", "pad_heads": int,
"microbatches": int, "mesh": [data, model]}``, run on the reduced yi-34b of
``OVERRIDES`` at batch ``B`` and sequence ``S`` (or, given ``"arch"``,
``"batch"`` and ``"seq"``, that arch's ``reduced_config`` at that shape)
through ``jit_train_step``
/ ``jit_prefill_step`` / ``jit_serve_step`` on ``input_specs``, on a mesh
over the first data x model host devices.  The mesh is built as
``launch.mesh.make_host_mesh`` builds it, with ``Auto`` axes, which the
reference's sharding constraints need (``jax.make_mesh`` gives
``Explicit`` axes by default since jax 0.7).  Prints one JSON list: per
case the compiled module's ``dot`` flops (trip-aware, as
``tests/test_torch_hlo_analysis.py`` counts them) and, apart, those of its
batched dots (the attention products), its ``memory_analysis`` argument
and output sizes, and its collective bytes by kind
(``launch.hlo_analysis``).  The device count is fixed when jax first
starts, hence a process of its own.
"""
import dataclasses
import json
import sys

import jax
import numpy as np
from jax.sharding import Mesh

from repro.configs import reduced_config
from repro.launch import hlo_analysis as jha
from repro.launch import steps
from repro.models.model import input_specs
from repro.optim import adamw
from test_torch_hlo_analysis import _dot_flops

OVERRIDES = dict(d_model=128, n_heads=2, n_kv_heads=1, d_ff=384, vocab_size=2048)
B, S = 4, 32


def _batched_dot_flops(a, name):
    """The flops of the dots with batch dimensions (``lhs_batch_dims``),
    trip-aware as ``_dot_flops``."""
    total = 0.0
    for op in a.comps[name].ops:
        if op.opcode == "while":
            cond = jha._called(op.line, "condition")
            trips = jha._trip_count(a.comps[cond]) if cond in a.comps else 1
            total += max(trips, 1) * _batched_dot_flops(a, jha._called(op.line, "body"))
        elif op.opcode in ("fusion", "call", "custom-call"):
            callee = jha._called(op.line, "calls") or jha._called(op.line, "to_apply")
            if callee in a.comps:
                total += _batched_dot_flops(a, callee)
        elif op.opcode == "dot" and "lhs_batch_dims" in op.line:
            total += jha._dot_flops(op, a.comps[name])
    return total


def measure(mode: str, pad_heads: int, microbatches: int, mesh, arch: str = "yi-34b",
            batch: int = B, seq: int = S) -> dict:
    overrides = OVERRIDES if arch == "yi-34b" else {}
    cfg = dataclasses.replace(reduced_config(arch, **overrides), pad_heads=pad_heads)
    n = mesh[0] * mesh[1]
    jmesh = Mesh(np.asarray(jax.devices()[:n]).reshape(mesh), ("data", "model"))
    specs = input_specs(cfg, batch, seq, mode)
    with jmesh:
        if mode == "train":
            jitted, (shapes, _, _) = steps.jit_train_step(
                cfg, adamw.AdamWConfig(), jmesh, specs, microbatches=microbatches)
        elif mode == "prefill":
            jitted, (shapes, _, _) = steps.jit_prefill_step(cfg, jmesh, specs)
        else:
            jitted, (shapes, _, _) = steps.jit_serve_step(cfg, None, jmesh, specs)
        compiled = jitted.lower(shapes, specs).compile()
    a = jha.Analyzer(compiled.as_text())
    mem = compiled.memory_analysis()
    return {"mode": mode, "pad_heads": pad_heads, "microbatches": microbatches,
            "mesh": list(mesh), "arch": arch, "batch": batch, "seq": seq,
            "dots": _dot_flops(a, a.entry),
            "batched_dots": _batched_dot_flops(a, a.entry),
            "argument_bytes": int(mem.argument_size_in_bytes),
            "output_bytes": int(mem.output_size_in_bytes),
            "collective_bytes": dict(a.stats().collective_bytes)}


if __name__ == "__main__":
    print(json.dumps([measure(**case) for case in json.loads(sys.argv[1])]))
