"""Training driver of the port: instrumented, fault-tolerant,
streaming-analyzed, policy-actuated.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 6 --analyze-every 3 --policies all
    python -m repro_torch.launch.train --arch yi-34b --full-width --layers 4 \
        --batch 2 --seq 2048 --steps 6 --analyze-every 3 --policies all

Counterpart of ``repro/launch/train.py``, with its flags, names and printed
lines (but ``--reduced``, which could not be turned off there:
``--full-width`` asks for the published widths).  It runs on the card unless ``--device cpu`` asks for the host (no
fallback: without a Hopper card the default raises).  The model is the
reduced config of ``--arch`` (``--d-model`` wide) unless ``--full-width``
asks for the published widths; ``--layers`` cuts the depth.  Each step has
three instrumented regions: ``data`` (the next synthetic batch, converted
to device tensors), ``step`` (forward and chunked loss under autograd,
gradients, the hand-written AdamW; it ends on a device synchronize, so it
measures the card's time) and ``checkpoint``.  Every ``--analyze-every``
steps the recorder's window is frozen and analyzed (off the step loop by
default), diffed against the previous window, and handed to the policy
engine; fired rebalance/reshard actions act on the simulated pod
(``--sim-ranks``) or the live partitioned pipeline (``--data-hosts``).
Training runs the plain forms the reference trains with; none of the
port's kernels (which have no backward) is launched.

The analysis side takes the reference's flags as the reference wires them:
``--pod-gather`` all-gathers every host's window shard into one m-rank
snapshot before analysis (``launch/collect.SnapshotCollector`` over the
default ``torch.distributed`` group; one process without a group, same
path, one shard); ``--chaos-seed`` shards each window into
``--chaos-hosts`` per-host blobs, injects seeded transport faults plus a
forced analyzer fault at window 1 and a truncated host-1 blob at window 2
(``perfdbg/chaos``), merges leniently (quarantining damaged hosts into the
gap mask) and analyzes under supervision; ``--diagnosis learned`` attaches
the softmax classifier fit on a generated corpus (``perfdbg/corpus``).

The schema's cost attributes come from ``--costs``: closed-form estimates
(``analytic``, the default under ``--schema paper``) or, under ``hlo`` (the
default under ``--schema tpu``), the flops, HBM bytes and collective bytes
of one train step counted once before the first step, on copies of the
state and batch on the ``meta`` device (``steps.count_train_step``,
``launch/hlo_analysis``), over the analytic estimates for the host-side
regions.  A count that fails raises; the run never carries on with the
estimates.

whisper-large-v3 is refused before the first step: the data pipeline gives
token batches only, and an encoder-decoder needs frame embeddings beside
them (the reference's trainer fails for want of them as well).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.core import (AnalysisSession, AsyncAnalysisSession,
                              PolicyEngine, RegionTree, SessionReport,
                              WindowJournal, make_policies)
from repro_torch.core.policy import CollectorQuarantinePolicy
from repro_torch.core.roughset import ROLE_IO
from repro_torch.data.pipeline import Partition, SyntheticTokens
from repro_torch.device import device_label, resolve_device, synchronize
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.collect import (SnapshotCollector, TransportHealth,
                                        merge_blobs)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.perfdbg import AnalyticCosts, Instrumenter, RegionRecorder
from repro_torch.perfdbg import chaos as chaos_mod
from repro_torch.perfdbg.instrument import CPU_CLOCK, NOMINAL_HZ
from repro_torch.perfdbg.schema import SUM

@dataclasses.dataclass
class TrainResult:
    cfg: ModelConfig
    state: dict                   # {"params": Model, "opt": AdamW state}
    tree: RegionTree
    report: SessionReport
    losses: List[float]           # per step run
    grad_norms: List[float]
    step_ms: List[float]          # per step: CUDA events on the card, host clock on the CPU
    adamw_ms: List[float]         # the optimizer's part of step_ms
    tokens_per_step: int
    peak_bytes: int               # torch.cuda.max_memory_allocated (0 on the CPU)
    start_step: int
    final_ckpt: Optional[str]
    health: Optional[TransportHealth]   # per-host transport counters under
                                        # --chaos-seed or --pod-gather
    step_costs: Dict[str, float]  # the cost provider's values for one step
    step_attrs: Dict[str, float]  # the step region's recorded attributes,
                                  # last window (the [report] line)


def build_config(args) -> ModelConfig:
    if args.full_width:
        cfg = get_config(args.arch)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        return cfg
    overrides = dict(d_model=args.d_model,
                     n_heads=max(args.d_model // 64, 1),
                     n_kv_heads=max(args.d_model // 128, 1),
                     d_ff=args.d_model * 3, vocab_size=2048)
    if args.layers:
        overrides["n_layers"] = args.layers
    return reduced_config(args.arch, **overrides)


class _StepTimer:
    """Per-step marks: start, gradients done, optimizer done.  CUDA events
    on the card (read after the run), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[list] = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self):
        self.marks.append([self._mark()])

    def mark(self):
        self.marks[-1].append(self._mark())

    def times(self):
        """(step ms, optimizer ms) per step."""
        def ms(a, b):
            return a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return ([ms(m[0], m[2]) for m in self.marks],
                [ms(m[1], m[2]) for m in self.marks])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-34b", choices=list_archs())
    ap.add_argument("--full-width", action="store_true",
                    help="the architecture's published widths instead of "
                         "the reduced config (--d-model is then ignored)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (needs a Hopper card; no fallback) or cpu")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--analyze-every", type=int, default=10,
                    help="window length in steps for the streaming analyzer")
    ap.add_argument("--schema", default="paper", choices=("paper", "tpu"),
                    help="attribute schema for the recorder")
    ap.add_argument("--costs", default=None, choices=("analytic", "hlo"),
                    help="cost provider for schema attributes: closed-form "
                         "estimates ('analytic') or counted from one step "
                         "on the meta device ('hlo'); default hlo under "
                         "--schema tpu, analytic otherwise")
    ap.add_argument("--sync-analysis", action="store_true",
                    help="analyze windows inline on the step loop instead of "
                         "on the async worker thread")
    ap.add_argument("--analysis-queue", type=int, default=4,
                    help="max windows pending in the async analysis queue")
    ap.add_argument("--analysis-workers", type=int,
                    default=int(os.environ.get("PERFDBG_ANALYSIS_WORKERS",
                                               "1")),
                    help="analysis worker pool size (windows are assembled "
                         "in submission order, so reports and policy "
                         "decisions are identical for any value; env "
                         "default PERFDBG_ANALYSIS_WORKERS)")
    ap.add_argument("--analysis-executor", default="thread",
                    choices=("thread", "process"),
                    help="where analysis workers run: 'thread' shares the "
                         "session across pool threads, 'process' ships each "
                         "window's wire blob to a spawn-pool session replica "
                         "(past the GIL; reports and policy decisions stay "
                         "identical)")
    ap.add_argument("--analysis-backpressure", default="block",
                    choices=("block", "drop-oldest"),
                    help="queue-full policy: stall the step loop vs evict "
                         "the oldest pending window")
    ap.add_argument("--pod-gather", action="store_true",
                    help="allgather window shards across hosts before "
                         "analysis (no-op transport on one process)")
    ap.add_argument("--inject-bottleneck-at", type=int, default=0,
                    help="if >0, burn CPU in the data region from this step "
                         "(synthetic mid-run bottleneck); with --sim-ranks "
                         "> 1 it instead slows the last simulated rank")
    ap.add_argument("--inject-ms", type=float, default=30.0)
    ap.add_argument("--diagnosis", default="rough",
                    choices=("rough", "threshold", "learned"),
                    help="diagnosis strategy for the window stream: the "
                         "paper's rough-set path (default), calibrated "
                         "per-role thresholds, or the small learned "
                         "classifier trained on a generated corpus")
    ap.add_argument("--policies", default="",
                    help="comma list of window-adaptive policies to attach "
                         "(rebalance,reshard,quarantine or 'all'); empty = "
                         "detection only")
    ap.add_argument("--policy-window-k", type=int, default=2,
                    help="debounce: consecutive confirming windows before "
                         "a policy fires")
    ap.add_argument("--sim-ranks", type=int, default=1,
                    help="simulate an M-rank pod from rank-0 measurements "
                         "(per-rank shard sizes; enables the closed-loop "
                         "rebalance/reshard demos)")
    ap.add_argument("--sim-shard-skew", type=float, default=1.0,
                    help="with --sim-ranks > 1: rank 0's initial shard is "
                         "this factor of the uniform size (a skewed data "
                         "partition — the reshard demo's injected fault; a "
                         "fired ReshardPolicy repartitions back to uniform)")
    ap.add_argument("--inject-factor", type=float, default=4.0,
                    help="slowdown of the last simulated rank under "
                         "--sim-ranks + --inject-bottleneck-at (or of the "
                         "last data host under --data-hosts)")
    ap.add_argument("--data-hosts", type=int, default=1,
                    help="partition the real input pipeline across this "
                         "many hosts (per-host batch slices from the live "
                         "Partition; fired rebalance/reshard actions "
                         "repartition it)")
    ap.add_argument("--data-skew", type=float, default=1.0,
                    help="with --data-hosts > 1: host 0's initial partition "
                         "weight is this factor of uniform (the injected "
                         "fault the reshard demo repairs); ignored on "
                         "--resume when a checkpointed partition exists")
    ap.add_argument("--supervised", action="store_true",
                    help="contain analysis failures: a window whose "
                         "analysis raises is tombstoned as a FAILED entry "
                         "and the run continues (implied by --chaos-seed)")
    ap.add_argument("--escalate-after", type=int, default=3,
                    help="under --supervised: consecutive failed windows "
                         "before the crash is considered real and re-raised")
    ap.add_argument("--journal", default="", metavar="FILE",
                    help="append every submitted window blob to this "
                         "crash-safe journal (core.journal.replay rebuilds "
                         "the byte-identical report after a crash)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="chaos demo: shard each window into per-host "
                         "blobs, inject seeded transport faults plus a "
                         "forced analyzer exception, merge leniently "
                         "(quarantining corrupt hosts), and analyze under "
                         "supervision")
    ap.add_argument("--chaos-hosts", type=int, default=2,
                    help="hosts to shard each window across under "
                         "--chaos-seed (must be <= the pod rank count)")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    if args.data_hosts > 1 and args.sim_ranks > 1:
        ap.error("--data-hosts and --sim-ranks are mutually exclusive: the "
                 "real partitioned pipeline and the simulated pod disagree "
                 "about what a rank is")
    if args.data_hosts > 1 and args.batch < args.data_hosts:
        ap.error(f"--data-hosts {args.data_hosts} needs --batch >= "
                 f"{args.data_hosts} (every host gets at least one row)")
    if get_config(args.arch).is_encdec:
        ap.error(f"--arch {args.arch}: an encoder-decoder trains on frame "
                 "embeddings beside its tokens, and the synthetic data "
                 "pipeline gives tokens only (the reference's trainer fails "
                 "for want of frames too)")
    return args


def run(argv=None) -> TrainResult:
    """Parse ``argv`` as the command line and train; ``main`` is this,
    returning 0."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = build_config(args)
    print(f"[train] {cfg.name}: ~{cfg.total_params()/1e6:.1f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model}", flush=True)
    print(f"[train] device: {device_label(dev)}", flush=True)

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=5,
                                decay_steps=max(args.steps, 10))
    timer = _StepTimer(dev)
    train_step = steps_lib.make_train_step(cfg, opt_cfg, microbatches=1,
                                           on_grads=timer.mark)
    H = max(args.data_hosts, 1)
    data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq)
    if H > 1:
        w = np.ones(H)
        w[0] = args.data_skew
        data.set_partition(Partition(w))
    state = steps_lib.init_state(cfg, opt_cfg, seed=0, device=dev)
    start_step = 0

    saver = None
    if args.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
        last = ckpt.latest_step(args.ckpt_dir)
        if args.resume and last is not None:
            # model/opt state rides the array tree; the pipeline's state
            # (step, bytes, partition weights) rides the manifest — an
            # actuated partition therefore survives the restart and
            # overrides the flag-built one above
            restored, manifest = ckpt.restore(
                args.ckpt_dir, {"state": steps_lib.state_tree(state)})
            steps_lib.load_state_tree(state, restored["state"])
            data.load_state_dict(manifest["data"])
            start_step = int(manifest["step"])
            print(f"[train] restored step {start_step} from {args.ckpt_dir}",
                  flush=True)
            if data.partition is not None:
                print(f"[train] data partition restored: "
                      f"{np.round(data.partition.weights, 3).tolist()}",
                      flush=True)
    if data.partition is not None and data.partition.n_hosts != H:
        raise SystemExit(
            f"[train] restored partition has {data.partition.n_hosts} hosts "
            f"but --data-hosts is {H}; rerun with --data-hosts "
            f"{data.partition.n_hosts}")

    # cost provider: where the schema's attribute fields come from.  The
    # analytic base (the estimates this driver used to inline) always
    # covers the host-side regions; --costs hlo overlays per-region flops /
    # HBM bytes / collective bytes counted from one step on the meta device.
    tokens_per_step = args.batch * args.seq
    region_names = ("data", "step", "checkpoint")
    costs_mode = args.costs or ("hlo" if args.schema == "tpu" else "analytic")
    provider = AnalyticCosts.for_train_step(
        active_params=cfg.active_params(), total_params=cfg.total_params(),
        d_model=cfg.d_model, n_layers=cfg.n_layers,
        tokens_per_step=tokens_per_step,
        checkpoint_io_bytes=0.0 if not args.ckpt_dir else 1.0)
    if costs_mode == "hlo":
        t0 = time.perf_counter()
        counted = steps_lib.count_train_step(cfg, opt_cfg, args.batch, args.seq)
        provider = steps_lib.hlo_cost_provider(
            counted, region_names, anchor="step", base=provider)
        print(f"[costs] counted one step on the meta device in "
              f"{time.perf_counter() - t0:.2f} s (host clock)", flush=True)
        print("[costs] coverage: " + provider.render_coverage(), flush=True)
    step_costs = provider.region_costs("step")
    flops_per_step = step_costs.get("hlo_flops", 0.0)
    print(f"[costs] {costs_mode} step: "
          f"hlo_flops={step_costs.get('hlo_flops', 0.0):.3e} "
          f"hbm_bytes={step_costs.get('hbm_bytes', 0.0):.3e} "
          f"collective_bytes={step_costs.get('collective_bytes', 0.0):.3e} "
          f"hbm_boundedness={step_costs.get('hbm_boundedness', 0.0):.3f}",
          flush=True)

    # region tree for the instrumented step.  Three rank layouts:
    #   M = H = 1: the real single shard of this container.
    #   M > 1: a simulated pod — rank 0's measured times are scaled by
    #     per-rank shard sizes (and the injected slow factor for the last
    #     rank), so external/straggler analysis and the closed
    #     rebalance/reshard loops run for real on synthetic-but-live data.
    #   H > 1: the REAL partitioned pipeline — every global batch is sliced
    #     per host by the live Partition; each host's recorded io attribute
    #     is its slice's actual bytes, and its times are the measured
    #     globals attributed by real byte share (concurrent-host model:
    #     hosts read/compute their slices in parallel at equal throughput,
    #     so host h's wall is the global wall x its share).
    M = max(args.sim_ranks, 1)
    R = M if M > 1 else H
    tree = RegionTree("train")
    for nm in region_names:
        tree.add(nm)
    rec = RegionRecorder(tree, n_ranks=R, schema=args.schema,
                         cost_provider=provider if R == 1 else None)
    ins = Instrumenter(rec, rank=0)
    rids = {tree.name(r): r for r in tree.ids()}
    # per-rank data-shard sizes (tokens per step).  Uniform unless
    # --sim-shard-skew injects a skewed partition; a fired rebalance or
    # reshard action rewrites this vector — the sim's actuation surface.
    shard_tokens = np.full(M, tokens_per_step / M)
    if M > 1 and args.sim_shard_skew != 1.0:
        shard_tokens[0] *= args.sim_shard_skew
        shard_tokens *= tokens_per_step / shard_tokens.sum()
    shares = shard_tokens / shard_tokens.sum()   # fraction of work per rank
    sim = {"slow": 1.0}                   # last rank's current slow factor
    if M > 1:
        print(f"[train] simulated pod: {M} ranks, shards "
              f"{np.round(shard_tokens).astype(int).tolist()} tok/step",
              flush=True)
    # H > 1 bookkeeping: this step's real per-host slice bytes/shares (set
    # inside the data region, right after the split), the schema fields
    # that carry the io role (they record REAL slice bytes, not
    # provider-scaled estimates), and per-host wall attribution for the
    # program clock.
    step_bytes = np.zeros(H)
    step_shares = np.full(H, 1.0 / H)
    host_wall = np.zeros(H)
    region_wall = {"sum": 0.0}
    io_fields = tuple(f.name for f in rec.schema.fields if f.role == ROLE_IO)
    if H > 1:
        rows = data.partition.counts(args.batch)
        print(f"[train] partitioned pipeline: {H} hosts, weights "
              f"{np.round(data.partition.weights, 3).tolist()}, rows "
              f"{rows.tolist()}/batch", flush=True)
    # rank 0's per-execution provider costs per region; rank r's shard is
    # f times rank 0's, so its SUM counters (bytes, flops) scale with f
    # while WMEAN ratios (boundedness) describe the kernel, not the size
    pvals = {nm: rec.schema.values_from_provider(provider.region_costs(nm))
             for nm in region_names}
    sum_fields = {f.name for f in rec.schema.fields if f.reduction == SUM}

    @contextlib.contextmanager
    def region(name, *, instructions=0.0, nominal_cpi=None):
        """Instrument one region for the whole (real, simulated, or
        partitioned) pod."""
        if M == 1 and H == 1:
            with ins.region(name, instructions=instructions,
                            nominal_cpi=nominal_cpi):
                yield
            return
        w0, c0 = time.perf_counter(), CPU_CLOCK()
        try:
            yield
        finally:
            wall, cpu = time.perf_counter() - w0, CPU_CLOCK() - c0
            cycles = cpu * NOMINAL_HZ
            instr = instructions
            if nominal_cpi is not None and not instr:
                instr = cycles / nominal_cpi
            if M > 1:
                for r in range(M):
                    f = shares[r] / max(shares[0], 1e-12)
                    s = sim["slow"] if r == M - 1 else 1.0
                    attrs = {k: (v * f if k in sum_fields else v)
                             for k, v in pvals[name].items()}
                    # a sick host does the same work (instructions and byte
                    # counters scale with its shard only), just slower
                    # (times scale with s too)
                    rec.add(r, rids[name], cpu_time=cpu * f * s,
                            wall_time=wall * f * s, cycles=cycles * f * s,
                            instructions=instr * f, **attrs)
                return
            # H > 1: attribute the measured globals by each host's REAL
            # byte share of this step's split.  data/step work scales with
            # the host's slice; checkpoint is the host-local shard write
            # (1/H of the global each).  The io-role attribute of the data
            # region carries the slice's actual bytes.
            region_wall["sum"] += wall
            for h in range(H):
                f = (1.0 / H) if name == "checkpoint" else \
                    float(step_shares[h])
                s = sim["slow"] if h == H - 1 else 1.0
                attrs = {k: (v * f if k in sum_fields else v)
                         for k, v in pvals[name].items()}
                if name == "data":
                    for fld in io_fields:
                        attrs[fld] = float(step_bytes[h])
                rec.add(h, rids[name], cpu_time=cpu * f * s,
                        wall_time=wall * f * s, cycles=cycles * f * s,
                        instructions=instr * f, **attrs)
                host_wall[h] += wall * f * s

    @contextlib.contextmanager
    def program():
        if M == 1 and H == 1:
            with ins.program():
                yield
            return
        t0 = time.perf_counter()
        if H > 1:
            host_wall[:] = 0.0
            region_wall["sum"] = 0.0
        try:
            yield
        finally:
            pw = time.perf_counter() - t0
            if M > 1:
                for r in range(M):
                    f = shares[r] / max(shares[0], 1e-12)
                    s = sim["slow"] if r == M - 1 else 1.0
                    rec.add_program_wall(r, pw * f * s)
            else:
                # each host's program wall = its attributed region walls
                # plus an equal share of the untracked step overhead
                over = max(pw - region_wall["sum"], 0.0) / H
                for h in range(H):
                    rec.add_program_wall(h, host_wall[h] + over)

    engine = None
    if args.policies:
        engine = PolicyEngine(make_policies(args.policies),
                              k=args.policy_window_k)

    win_tokens = {}   # window label -> tokens it covered (for the rate line)
    pod_rates = {}    # window index -> pod rate (tok/s)
    fire_windows = []  # windows whose fired action repartitioned the pipeline

    def on_window(entry):
        verdict = entry.straggler_verdict()
        line = (f"[window {entry.index}] {entry.title()} internal: "
                f"{[tree.name(r) for r in entry.report.internal.cccrs]}")
        if entry.diff.appeared:
            line += (" | appeared: "
                     f"{[tree.name(r) for r in entry.diff.appeared]}")
        if entry.diff.disappeared:
            line += (" | disappeared: "
                     f"{[tree.name(r) for r in entry.diff.disappeared]}")
        toks = win_tokens.pop(entry.label, None)
        if toks and entry.rank_cpu:
            present = [c for r, c in enumerate(entry.rank_cpu)
                       if r not in entry.gap_ranks]
            rate = toks / max(max(present), 1e-9)
            pod_rates[entry.index] = rate
            line += f" | pod rate {rate:,.0f} tok/s"
        if entry.diagnosis is not None:
            line += f" | diag {entry.diagnosis.kind}"
        print(line + f" | {verdict.render().splitlines()[0]}", flush=True)
        if engine is not None:
            for d in engine.log.for_window(entry.index):
                print(f"[policy] {d.render()}", flush=True)

    def actuate_partition(act, part):
        """Repartition the LIVE pipeline and leave the audit line that ties
        the actuation to its PolicyLog entry (policy/kind/window/evidence
        match ``Decision.render``)."""
        before = np.round(data.partition.weights, 3).tolist()
        fire_windows.append(act.window)
        data.set_partition(part)
        after = np.round(data.partition.weights, 3).tolist()
        rows = data.partition.counts(args.batch).tolist()
        print(f"[actuate] {act.policy}/{act.kind} @w{act.window} "
              f"evidence={list(act.evidence)}: pipeline partition "
              f"{before} -> {after} (rows {rows}/batch)", flush=True)

    def apply_actions(actions):
        nonlocal shares, shard_tokens
        for act in actions:
            if act.kind == "rebalance" and \
                    act.rebalance_weights is not None:
                w = np.asarray(act.rebalance_weights, dtype=np.float64)
                if w.sum() <= 0:
                    continue
                if H > 1:
                    # actuate for real: the fired weight vector becomes the
                    # live pipeline's partition — slow hosts read less of
                    # every following global batch
                    actuate_partition(act, w)
                    continue
                shares = w / w.sum()
                shard_tokens = shares * tokens_per_step
                print(f"[policy] applied rebalance from window {act.window}: "
                      f"shares -> {np.round(shares, 3).tolist()}", flush=True)
            elif act.kind == "reshard":
                if H > 1:
                    # actuate for real: a work-imbalance core means the
                    # partition itself is skewed — repartition the live
                    # pipeline back to uniform
                    actuate_partition(act, Partition.uniform(H))
                elif M > 1:
                    # actuate: repartition the simulated shards to uniform —
                    # the fix for a skewed partition (work imbalance), as
                    # opposed to rebalance's speed-weighted shares
                    shard_tokens = np.full(M, tokens_per_step / M)
                    shares = shard_tokens / shard_tokens.sum()
                    print(f"[policy] applied reshard from window "
                          f"{act.window} (work attr {act.target!r}): "
                          f"shards -> uniform "
                          f"{np.round(shard_tokens).astype(int).tolist()} "
                          f"tok/step", flush=True)
                else:
                    print(f"[policy] reshard fired (window {act.window}, "
                          f"core names {act.target!r}): repartition the "
                          f"data pipeline", flush=True)
            elif act.kind == "quarantine":
                if act.params.get("host") is not None:
                    print(f"[policy] quarantine fired: host "
                          f"{act.params['host']} shipped "
                          f"{act.params.get('bad_windows', 0)} bad window(s) "
                          f"(corrupt {act.params.get('corrupt', 0)}, skew "
                          f"{act.params.get('skew', 0)}) — stop routing to "
                          f"it", flush=True)
                else:
                    print(f"[policy] quarantine fired: rank {act.target} "
                          f"missing since window {act.evidence[0]}",
                          flush=True)

    # diagnosis strategy for the window stream.  rough (the default) is
    # what AnalysisSession builds on its own — passing None keeps the
    # reuse fingerprint identical to a strategy-less run.
    strategy = None
    if args.diagnosis == "threshold":
        from repro_torch.core.diagnosis import ThresholdStrategy
        strategy = ThresholdStrategy()
    elif args.diagnosis == "learned":
        from repro_torch.perfdbg.corpus import default_learned_strategy
        strategy = default_learned_strategy()
    if strategy is not None:
        print(f"[train] diagnosis strategy: {strategy.name}", flush=True)

    # fault containment surfaces: the chaos injector (seeded transport +
    # analyzer faults, forced analyzer fault at window 1 and a truncated
    # host-1 blob at window 2 so the demo's audit lines are deterministic),
    # the transport health record quarantine policies consume, the
    # crash-safe journal, and supervised analysis.
    chaos = None
    health = None
    if args.chaos_seed is not None:
        if args.chaos_hosts < 1 or args.chaos_hosts > R:
            print(f"error: --chaos-hosts must be in [1, {R}] "
                  f"(the pod has {R} ranks)", file=sys.stderr)
            raise SystemExit(2)
        chaos = chaos_mod.ChaosInjector(
            args.chaos_seed, rates=chaos_mod.DEFAULT_RATES,
            force={"analyzer": [(1, 0)],
                   "truncate": [(2, min(1, args.chaos_hosts - 1))]})
        print(f"[chaos] injector armed: seed {args.chaos_seed}, "
              f"{args.chaos_hosts} host shard(s) per window", flush=True)
    supervised = args.supervised or chaos is not None
    if chaos is not None or args.pod_gather:
        health = TransportHealth()
    if engine is not None and health is not None:
        for p in engine.policies:
            if isinstance(p, CollectorQuarantinePolicy):
                p.health = health
                if chaos is not None:
                    # short demo runs: one bad window is already suspicious
                    p.corrupt_windows = 1
    journal = WindowJournal(args.journal) if args.journal else None

    def on_failure(entry):
        print(f"[analysis] window {entry.title()} FAILED: {entry.error}",
              flush=True)

    collector = None
    if args.pod_gather:
        collector = SnapshotCollector(strict=False, health=health)
    if chaos is not None:
        base_session = chaos_mod.ChaosSession(tree, chaos, strategy=strategy)
    else:
        base_session = AnalysisSession(tree, strategy=strategy)
    if args.sync_analysis:
        session = base_session
        pipeline = None
    else:
        session = None
        pipeline = AsyncAnalysisSession(
            tree, max_queue=args.analysis_queue,
            backpressure=args.analysis_backpressure.replace("-", "_"),
            workers=args.analysis_workers,
            executor=args.analysis_executor, session=base_session,
            supervised=supervised, escalate_after=args.escalate_after,
            journal=journal, on_failure=on_failure,
            on_window=on_window, policy_engine=engine)

    def burn(ms: float) -> None:
        t_end = time.perf_counter() + ms / 1e3
        while time.perf_counter() < t_end:
            np.dot(np.ones(256), np.ones(256))

    sync_seq = [0]   # journal sequence for the sync-analysis path

    def flush_window(last_step: int, win_start: int):
        assert rec.within_paper_budget()
        label = f"steps {win_start + 1}-{last_step + 1}"
        snap = rec.reset_window(label)
        # keyed by label, not index: under drop_oldest the session's entry
        # indices fall behind the recorder's snapshot indices
        win_tokens[label] = (last_step - win_start + 1) * tokens_per_step
        try:
            if chaos is not None:
                # shard the pod snapshot into per-host blobs as a real
                # collector would, run each through the fault injector,
                # and merge leniently — damaged hosts quarantine into the
                # gap mask instead of crashing the step loop
                blobs = chaos_mod.shard_blobs(snap, args.chaos_hosts)
                mangled = [chaos.mangle_blob(b, snap.index, h)
                           for h, b in enumerate(blobs)]
                snap = merge_blobs(mangled, tree=tree,
                                   total_ranks=snap.n_ranks,
                                   strict=False, health=health)
                for h in sorted(health.last_statuses):
                    status = health.last_statuses[h]
                    if status != "ok":
                        print(f"[transport] window w{snap.index} host {h}: "
                              f"{status}", flush=True)
            elif collector is not None:
                snap = collector.gather(snap)
        except ValueError:
            # every shard was lost or quarantined: there is no window to
            # analyze, but the run must keep training
            win_tokens.pop(label, None)
            print(f"[analysis] window w{snap.index} dropped: "
                  f"no contributors", flush=True)
            return
        if pipeline is not None:           # off-critical-path: enqueue only
            pipeline.submit(snap, label=label)
        else:
            if journal is not None:
                try:
                    journal.append(sync_seq[0], snap.to_bytes(), label=label)
                except Exception as e:
                    print(f"[journal] append failed (contained): {e}",
                          flush=True)
                sync_seq[0] += 1
            try:
                entry = session.ingest_snapshot(snap, label=label)
            except Exception as e:
                if not supervised:
                    raise
                entry = session.ingest_failure(
                    label=label, error=f"{type(e).__name__}: {e}")
                on_failure(entry)
                return
            fired = engine.observe(entry, session) if engine else []
            on_window(entry)
            apply_actions(fired)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    data.start_prefetch()
    losses, grad_norms = [], []
    win_start = start_step
    for step in range(start_step, args.steps):
        injecting = args.inject_bottleneck_at and \
            step + 1 >= args.inject_bottleneck_at
        sim["slow"] = args.inject_factor \
            if ((M > 1 or H > 1) and injecting) else 1.0
        with program():
            # attribute fields come from the attached cost provider
            # (M > 1: pulled and shard-scaled by the sim's region();
            # H > 1: scaled by each host's real slice-byte share)
            with region("data", nominal_cpi=1.0):
                if injecting and M == 1 and H == 1:
                    burn(args.inject_ms)
                batch = data.next_prefetched()
                if H > 1:
                    # the real actuation surface: slice the global
                    # batch by the LIVE partition; this step's
                    # per-host attribution follows the actual bytes
                    host_batches = data.split(batch)
                    step_bytes[:] = [
                        sum(int(v.nbytes) for v in hb.values())
                        for hb in host_batches]
                    step_shares[:] = step_bytes / step_bytes.sum()
                batch = {k: torch.from_numpy(v).to(dev, torch.long)
                         for k, v in batch.items()}
            with region("step", instructions=flops_per_step):
                timer.start()
                state, metrics = train_step(state, batch)
                timer.mark()
                synchronize(dev)
                loss = float(metrics["loss"])
            with region("checkpoint", nominal_cpi=1.0):
                if saver and (step + 1) % args.ckpt_every == 0:
                    saver.save(step + 1, {"state": steps_lib.state_tree(state)},
                               extra={"data": data.state_dict()})
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        if pipeline is not None:
            # poll every step (one lock acquire): a fire lands in the
            # shares before the *next* step, not a whole window later
            apply_actions(pipeline.take_actions())
        if (step + 1) % max(args.analyze_every, 1) == 0:
            flush_window(step, win_start)
            win_start = step + 1
            print(f"[step {step+1}] loss={loss:.4f} "
                  f"gnorm={grad_norms[-1]:.3f}", flush=True)
        elif (step + 1) % 5 == 0:
            print(f"[step {step+1}] loss={loss:.4f}", flush=True)
    if win_start < args.steps:   # trailing partial window
        flush_window(args.steps - 1, win_start)

    data.stop_prefetch()
    report = session.report() if pipeline is None else pipeline.close()
    if journal is not None and pipeline is None:
        journal.close()
    if pipeline is not None:
        apply_actions(pipeline.take_actions())   # anything fired post-loop
        if pipeline.dropped:
            print(f"[train] analysis dropped {pipeline.dropped} window(s) "
                  f"under backpressure", flush=True)
        if supervised and (pipeline.failed or pipeline.worker_restarts):
            print(f"[train] supervised analysis contained "
                  f"{pipeline.failed} failed window(s) "
                  f"({pipeline.worker_restarts} worker restart(s))",
                  flush=True)
        if pipeline.journal_errors:
            print(f"[journal] {pipeline.journal_errors} append(s) failed "
                  f"(contained)", flush=True)
    if health is not None and health.windows:
        print(health.render(), flush=True)
    if journal is not None:
        print(f"[journal] {journal.appended} window(s) journaled to "
              f"{journal.path}", flush=True)
    print(report.render(tree), flush=True)
    wins = rec.windows()
    vals = {}
    if wins:
        # recorded (not provider-advertised) attribute totals of the step
        # region, last window — the end-to-end check that schema fields
        # really carry the provider's numbers
        col = list(tree.ids()).index(rids["step"])
        wm = {f.export_name for f in wins[-1].schema.wmean_fields}
        vals = {k: float(v[:, col].mean() if k in wm else v[:, col].sum())
                for k, v in wins[-1].attributes().items()}
        print(f"[report] step-region attrs (last window, {costs_mode}): "
              + " ".join(f"{k}={v:.3e}" for k, v in sorted(vals.items())),
              flush=True)
    if engine is not None:
        print(f"[train] policy log ({len(engine.log)} decision(s), "
              f"{len(engine.log.fired())} fired):", flush=True)
        print(engine.log.render(10), flush=True)
    if H > 1 and fire_windows and pod_rates:
        # before/after pod-rate verdict for the actuation demo: "pre" is
        # the firing window (its steps ran under the old partition — the
        # repartition lands between windows), "post" the best of the final
        # two windows
        fw = fire_windows[0]
        pre_idx = max((i for i in pod_rates if i <= fw),
                      default=min(pod_rates))
        post = max(v for i, v in pod_rates.items()
                   if i >= max(pod_rates) - 1)
        verdict = "improved" if post > pod_rates[pre_idx] else "regressed"
        print(f"[train] pod rate pre-fire {pod_rates[pre_idx]:,.0f} tok/s "
              f"(window {pre_idx}) -> post {post:,.0f} tok/s: {verdict}",
              flush=True)
    final_ckpt = None
    if saver:
        saver.save(args.steps, {"state": steps_lib.state_tree(state)},
                   extra={"data": data.state_dict()})
        saver.wait()                 # re-raises if the background write failed
        final_ckpt = str(saver.last_path)
        print(f"[train] final checkpoint at {saver.last_path}", flush=True)
    if not losses:
        raise SystemExit(f"[train] nothing to do: the run is already at "
                         f"step {start_step} of --steps {args.steps}")
    ok = len(losses) >= 2 and losses[-1] < losses[0] and np.isfinite(losses[-1])
    print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'improved' if ok else 'check convergence'})", flush=True)
    step_ms, adamw_ms = timer.times()
    return TrainResult(
        cfg=cfg, state=state, tree=tree, report=report, losses=losses,
        grad_norms=grad_norms, step_ms=step_ms, adamw_ms=adamw_ms,
        tokens_per_step=tokens_per_step,
        peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
        start_step=start_step, final_ckpt=final_ckpt, health=health,
        step_costs=dict(step_costs), step_attrs=vals)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
