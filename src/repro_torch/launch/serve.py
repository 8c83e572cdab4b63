"""Batched serving on the port: prefill + decode rounds with streaming
analysis and window-adaptive policies.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        [--arch mixtral-8x7b|gemma2-27b|yi-34b|whisper-large-v3|...] \
        [--tokens 8] [--rounds 3] [--schema paper|tpu] [--policies all] \
        [--device cuda|cpu] [--full-width] [--n-layers N]

Counterpart of ``examples/serve.py``.  It prefills a batch of prompts
(on the card: attention through the Hopper flash-attention kernel, the
RWKV-6 and RG-LRU recurrences through their Hopper kernels, which also
carry the recurrent state of every decode step; MoE experts, norms and
projections in plain PyTorch, as the reference computes them with jnp),
then decodes ``--tokens`` tokens per request per round.  Each round is one
collection window: the recorder is frozen and handed to an
``AsyncAnalysisSession`` (``--sync-analysis`` analyzes inline), and the
report shows the per-window timeline of the regions prefill / decode /
detokenize.  Every timed region ends on a device synchronize inside the
region, so on the card it measures device time, not launch time.

The model is the reduced config of ``--arch`` unless ``--full-width``
asks for the published widths; ``--n-layers`` cuts the depth.  Weights and
prompts are random, drawn from a fixed seed.  An encoder-decoder
(whisper-large-v3) also draws its audio stub's frame embeddings, (batch,
encoder_seq, d_model) in the compute dtype, from the prompts' generator;
its prefill runs the encoder and the decoder's cross-attention (through
the flash-attention kernel on the card), and its decode steps attend to
the cross cache the prefill kept.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.core import (AnalysisSession, AsyncAnalysisSession,
                              PolicyEngine, RegionTree, SessionReport,
                              make_policies)
from repro_torch.device import device_label, resolve_device, synchronize
from repro_torch.models import Model, ModelConfig, init_params
from repro_torch.models.layers import torch_dtype
from repro_torch.perfdbg import Instrumenter, RegionRecorder


@dataclasses.dataclass
class ServeResult:
    model: Model
    prompts: torch.Tensor         # (batch, prompt_len) int64
    frames: Optional[torch.Tensor]  # (batch, encoder_seq, d_model), encoder-decoders only
    prefill_logits: torch.Tensor  # (batch, 1, vocab) fp32, last prompt position
    tokens: np.ndarray            # (batch, 1 + rounds * tokens) greedy tokens
    tree: RegionTree
    report: SessionReport
    prefill_s: float              # host clock around prefill + synchronize
    decode_s: float               # host clock around the decode loops
    decode_tokens: int

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / max(self.decode_s, 1e-9)


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
          tokens: int = 8, rounds: int = 3, schema: str = "paper",
          policies: str = "", policy_window_k: int = 2,
          analysis_workers: int = 1, analysis_executor: str = "thread",
          sync_analysis: bool = False, device: str = "cuda") -> ServeResult:
    """Serve ``rounds`` decode rounds of ``tokens`` tokens for ``batch``
    random prompts of ``prompt_len`` tokens; one analysis window per round.
    Weights are drawn from seed 0, as the reference's are, prompts (and an
    encoder-decoder's frames) from seed 1."""
    if rounds < 1 or tokens < 1:
        raise ValueError("rounds and tokens must be >= 1")
    dev = resolve_device(device)
    model = init_params(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    frames = None
    if cfg.is_encdec:
        frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                             device=dev).to(torch_dtype(cfg.compute_dtype))
    s_buf = prompt_len + rounds * tokens

    tree = RegionTree("serve")
    for nm in ("prefill", "decode", "detokenize"):
        tree.add(nm)
    rec = RegionRecorder(tree, 1, schema=schema)
    ins = Instrumenter(rec, 0)

    engine = None
    if policies:
        engine = PolicyEngine(make_policies(policies), k=policy_window_k)

    def on_window(entry):
        cccrs = [tree.name(r) for r in entry.report.internal.cccrs]
        print(f"[{entry.title()}] internal bottlenecks: {cccrs or ['(none)']}")
        if engine is not None:   # the decide half of the closed loop, live
            print(f"[{entry.title()}] policy log tail:")
            for line in engine.log.render(3).splitlines():
                print(f"  {line}")

    if sync_analysis:
        session, pipe = AnalysisSession(tree), None
    else:
        session, pipe = None, AsyncAnalysisSession(tree, max_queue=4,
                                                   workers=analysis_workers,
                                                   executor=analysis_executor,
                                                   on_window=on_window,
                                                   policy_engine=engine)
    io_kw = "host_io_bytes" if schema == "tpu" else "disk_io"

    out_tokens: List[torch.Tensor] = []
    cache = None
    prefill_logits = None
    prefill_s = decode_s = 0.0
    sync_actions = []
    try:
        for rnd in range(rounds):
            with ins.program():
                if rnd == 0:
                    w0 = time.perf_counter()
                    with ins.region("prefill", instructions=2 * cfg.active_params()
                                    * prompts.numel()):
                        prefill_logits, cache = model.prefill(prompts, s_buf,
                                                              frames=frames)
                        synchronize(dev)
                    prefill_s = time.perf_counter() - w0
                    out_tokens.append(prefill_logits[:, -1:].argmax(-1))
                w0 = time.perf_counter()
                with ins.region("decode", instructions=2 * cfg.active_params()
                                * batch * tokens):
                    for i in range(tokens):
                        pos = prompt_len + rnd * tokens + i
                        logits, cache = model.decode_step(out_tokens[-1], pos,
                                                          cache)
                        out_tokens.append(logits.argmax(-1))
                    synchronize(dev)
                decode_s += time.perf_counter() - w0
                with ins.region("detokenize", nominal_cpi=1.0,
                                **{io_kw: 4.0 * batch * tokens}):
                    # only this round's tokens: each window must measure one
                    # round's work, not everything accumulated since round 0
                    _ = np.concatenate(
                        [t.cpu().numpy() for t in out_tokens[-tokens:]], axis=1)
            if not rec.within_paper_budget():
                raise RuntimeError("recorder exceeded the paper's memory budget")
            print(f"[round {rnd}] decoded {tokens}/req")
            if pipe is not None:
                pipe.submit_recorder(rec, label=f"round {rnd}")
            else:
                entry = session.ingest_recorder(rec, label=f"round {rnd}")
                if engine is not None:
                    sync_actions += engine.observe(entry, session)
                on_window(entry)
    finally:
        report = session.report() if pipe is None else pipe.close()

    if engine is not None:
        actions = pipe.take_actions() if pipe is not None else sync_actions
        print(f"[serve] policy decisions: {len(engine.log)} "
              f"({len(engine.log.fired())} fired, "
              f"{len(actions)} action(s) collected)")
    seqs = np.concatenate([t.cpu().numpy() for t in out_tokens], axis=1)
    result = ServeResult(model=model, prompts=prompts, frames=frames,
                         prefill_logits=prefill_logits, tokens=seqs, tree=tree,
                         report=report, prefill_s=prefill_s, decode_s=decode_s,
                         decode_tokens=batch * rounds * tokens)
    print(f"\n[serve] {cfg.name} (d_model={cfg.d_model}, n_layers={cfg.n_layers}, "
          f"schema={schema}): batch={batch} prompt={prompt_len} "
          f"decoded={rounds * tokens}")
    for b in range(min(batch, 2)):
        print(f"  request {b}: {seqs[b].tolist()}")
    print("\n" + report.render(tree))
    print(f"\nprefill: {result.prefill_s * 1e3:.3f} ms; decode throughput: "
          f"{result.decode_tok_s:.1f} tok/s ({device_label(dev)})")
    return result


def build_config(arch: str, full_width: bool,
                 n_layers: Optional[int]) -> ModelConfig:
    cfg = get_config(arch) if full_width else reduced_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=8,
                    help="tokens decoded per request per round")
    ap.add_argument("--rounds", type=int, default=3,
                    help="decode rounds == analysis windows")
    ap.add_argument("--schema", default="paper", choices=("paper", "tpu"))
    ap.add_argument("--analysis-workers", type=int,
                    default=int(os.environ.get("PERFDBG_ANALYSIS_WORKERS",
                                               "1")),
                    help="analysis worker pool size (reports and policy "
                         "decisions are identical for any value; env "
                         "default PERFDBG_ANALYSIS_WORKERS)")
    ap.add_argument("--analysis-executor", default="thread",
                    choices=("thread", "process"),
                    help="thread (shared session) or process (spawn-pool "
                         "session replicas, past the GIL); reports are "
                         "identical either way")
    ap.add_argument("--sync-analysis", action="store_true",
                    help="analyze each round inline instead of on the "
                         "async worker thread")
    ap.add_argument("--policies", default="",
                    help="comma list of window-adaptive policies "
                         "(rebalance,reshard,quarantine or 'all')")
    ap.add_argument("--policy-window-k", type=int, default=2,
                    help="debounce: consecutive confirming windows before "
                         "a policy fires")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (needs a Hopper card; no fallback) or cpu")
    ap.add_argument("--full-width", action="store_true",
                    help="the architecture's published widths instead of "
                         "the reduced config")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    args = ap.parse_args(argv)
    if args.rounds < 1 or args.tokens < 1:
        ap.error("--rounds and --tokens must be >= 1")
    cfg = build_config(args.arch, args.full_width, args.n_layers)
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
          tokens=args.tokens, rounds=args.rounds, schema=args.schema,
          policies=args.policies, policy_window_k=args.policy_window_k,
          analysis_workers=args.analysis_workers,
          analysis_executor=args.analysis_executor,
          sync_analysis=args.sync_analysis, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
