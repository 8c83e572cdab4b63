"""Window-adaptive policy engine — the detect -> optimize loop (core layer).

The paper's point is that bottleneck *detection* exists to drive
*optimization* (its two case-study codes gain 20-170% from acting on the
analysis).  Everything upstream of this module detects: the streaming
``AnalysisSession`` emits one :class:`~repro.core.session.WindowEntry` per
collection window, each carrying clustering verdicts, rough-set cores, gap
masks and per-rank CPU totals.  This module *acts* on that stream.

Three pieces:

* A :class:`Policy` observes each analyzed window and proposes
  :class:`Action`\\ s (``observe(entry, session) -> list[Action]``).
  Proposals are *intents* — the engine decides whether they fire.
* The :class:`PolicyEngine` composes policies and applies the two guards
  production actuation needs: **debounce** (a proposal fires only after
  ``k`` consecutive windows re-proposing the same action key — one noisy
  window must not reshard a pod) and a **rate limit** (after a fire, the
  same key is suppressed for ``cooldown`` further windows, so the system
  observes the action's effect before re-acting).
* Every decision — fired or suppressed — lands in the :class:`PolicyLog`
  with the evidence window indices, so "why did the pod reshard at 03:12"
  is answerable from the log alone.

Invariants:

* The engine is deterministic: the same ``WindowEntry`` stream produces the
  same decisions, so the sync ``AnalysisSession`` driver and the async
  ``core.pipeline`` worker agree decision-for-decision (pinned by
  ``tests/test_policy.py``).
* The engine must see every window exactly once, in order (both drivers
  guarantee this); a key not re-proposed in a window loses its streak.
* Policies never mutate the session; actuation is the caller's job (e.g.
  ``launch/train.py`` repartitions the live input pipeline — a fired
  action's ``rebalance_weights`` become the ``data.pipeline.Partition``
  slicing the next global batch, and the new partition rides the
  checkpoint manifest across restarts).
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, Hashable, List, Mapping, Optional, Sequence, Tuple)

import numpy as np

from .diagnosis import KIND_DATA_SKEW, work_imbalance_attrs
from .roughset import ROLE_WORK
from .session import AnalysisSession, WindowEntry

#: Decision reasons recorded in the :class:`PolicyLog`.
FIRED = "fired"                  # action emitted to the caller
DEBOUNCE = "debounce"            # streak still below k confirming windows
RATE_LIMITED = "rate_limited"    # k reached, but inside the cooldown


@dataclasses.dataclass(frozen=True)
class Action:
    """One proposed (or fired) actuation.

    ``(policy, kind, target)`` is the action's *key*: the debounce streak
    and the rate limit both track keys, so a policy that proposes per-rank
    actions (``target=rank``) gets independent per-rank streaks while a
    global action (``target=None``) gets one.  ``window`` / ``evidence``
    are stamped by the engine: the firing window and the consecutive
    confirming windows."""

    kind: str                              # rebalance | reshard | quarantine | ...
    target: Hashable = None                # rank id, attribute name, or None
    params: Mapping[str, object] = dataclasses.field(default_factory=dict)
    policy: str = ""                       # stamped by the engine
    window: int = -1                       # stamped by the engine
    evidence: Tuple[int, ...] = ()         # stamped by the engine on fire

    def key(self) -> Tuple[str, str, Hashable]:
        return (self.policy, self.kind, self.target)

    @property
    def rebalance_weights(self) -> Optional[Tuple[float, ...]]:
        """The full new per-rank work-weight vector a fired ``rebalance``
        action carries (``params["weights"]``), or ``None`` when the action
        has none.  This is the vector a driver feeds straight into its
        actuation surface — e.g. ``launch/train.py`` repartitions the live
        ``data.pipeline`` with it (``SyntheticTokens.set_partition``)."""
        w = self.params.get("weights")
        if w is None:
            return None
        return tuple(float(x) for x in w)

    def render(self) -> str:
        tgt = "" if self.target is None else f" target={self.target}"
        return (f"{self.policy}/{self.kind}{tgt} @w{self.window} "
                f"evidence={list(self.evidence)}")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One engine verdict about one proposal in one window — the audit unit."""

    window: int
    policy: str
    kind: str
    target: Hashable
    reason: str                    # FIRED | DEBOUNCE | RATE_LIMITED
    streak: int                    # confirming windows accumulated so far
    evidence: Tuple[int, ...]      # the confirming window indices
    action: Optional[Action] = None   # set only when reason == FIRED

    @property
    def fired(self) -> bool:
        return self.reason == FIRED

    def render(self) -> str:
        tgt = "" if self.target is None else f" target={self.target}"
        return (f"[w{self.window}] {self.policy}/{self.kind}{tgt}: "
                f"{self.reason} (streak {self.streak}, "
                f"evidence {list(self.evidence)})")


class PolicyLog:
    """Append-only audit trail of every engine decision.

    ``max_entries`` bounds memory for long sessions (oldest decisions are
    dropped; this is a display/audit buffer, not engine state — debounce
    streaks live in the engine and are never affected by log truncation)."""

    def __init__(self, max_entries: Optional[int] = None):
        self.max_entries = max_entries
        self._decisions: List[Decision] = []

    def append(self, decision: Decision) -> None:
        self._decisions.append(decision)
        if self.max_entries is not None and \
                len(self._decisions) > self.max_entries:
            del self._decisions[:len(self._decisions) - self.max_entries]

    def __len__(self) -> int:
        return len(self._decisions)

    @property
    def decisions(self) -> Tuple[Decision, ...]:
        return tuple(self._decisions)

    def fired(self) -> Tuple[Decision, ...]:
        return tuple(d for d in self._decisions if d.fired)

    def for_window(self, index: int) -> Tuple[Decision, ...]:
        return tuple(d for d in self._decisions if d.window == index)

    def tail(self, n: int = 5) -> Tuple[Decision, ...]:
        return tuple(self._decisions[-n:])

    def render(self, n: Optional[int] = None) -> str:
        ds = self._decisions if n is None else self._decisions[-n:]
        if not ds:
            return "(no policy decisions)"
        return "\n".join(d.render() for d in ds)


class Policy:
    """Protocol for window-adaptive policies.

    Subclasses set ``name`` and implement ``observe``; returning an empty
    list means "nothing to propose this window" (which resets this policy's
    debounce streaks in the engine).  ``observe`` runs on whichever thread
    drives the session — it must not block and must not mutate the session."""

    name = "policy"

    def observe(self, entry: WindowEntry,
                session: AnalysisSession) -> List[Action]:
        raise NotImplementedError


class RebalancePolicy(Policy):
    """Straggler mitigation: the paper's ST fix (static -> dynamic dispatch).

    Proposes one ``rebalance`` action per straggling rank (per-rank keys,
    so the engine's k-consecutive-window debounce reproduces
    ``perfdbg.straggler.persistent_stragglers`` exactly).  A fired action
    carries the full new weight vector from
    ``rebalance_weights(entry.rank_cpu, gap_ranks)`` — slow ranks get
    proportionally less of the next window's work; missing ranks get none.

    Below the paper's alert threshold the verdict is log-only
    (``verdict.action == "alert"``), and this policy stays quiet unless
    ``act_on_alert=True``."""

    name = "rebalance"

    def __init__(self, act_on_alert: bool = False):
        self.act_on_alert = act_on_alert

    def observe(self, entry: WindowEntry,
                session: AnalysisSession) -> List[Action]:
        from repro_torch.perfdbg.straggler import rebalance_weights   # lazy: cycle
        verdict = entry.straggler_verdict()
        if not verdict.stragglers:
            return []
        if verdict.action == "alert" and not self.act_on_alert:
            return []
        weights = rebalance_weights(np.asarray(entry.rank_cpu),
                                    gap_ranks=entry.gap_ranks)
        return [Action(kind="rebalance", target=int(r),
                       params={"weights": tuple(float(w) for w in weights),
                               "severity": verdict.severity,
                               "causes": verdict.causes.get(int(r), ())})
                for r in verdict.stragglers]


class ReshardPolicy(Policy):
    """Data re-shard on a persistent *work-imbalance* root cause.

    The paper's rough-set reading: when a minimal core of the *external*
    decision table names the work attribute (``instructions`` under the
    paper schema, ``hlo_flops`` under ``tpu``), processes differ in *how
    much work they were handed*, not how fast they run it — the fix is
    repartitioning the data, not replacing hardware (the ST case study's
    static -> dynamic dispatch).  The attribute is matched by its
    schema-declared semantic role (:data:`~repro.core.roughset.ROLE_WORK`),
    so a schema can rename or add cost fields without touching this policy;
    streams that declare no roles fall back to the paper's attribute name
    (``fallback_attr``).  Any minimal-core *alternative* naming the work
    attribute counts: work imbalance alone then suffices to discern the
    bottleneck, even when a co-varying attribute (e.g. the I/O bytes of the
    same oversized shard) ties with it.  ``scopes`` defaults to external
    only: an *internal* core naming work merely says a region is
    compute-heavy, which is not an imbalance signal.

    When the entry carries a :class:`~repro.core.diagnosis.Diagnosis` and
    this policy runs at its default configuration, the strategy's verdict
    *is* the trigger: the policy proposes exactly when ``diagnosis.kind``
    is ``data_skew``.  The default :class:`~repro.core.diagnosis.
    RoughSetStrategy` computes that kind with the shared
    :func:`~repro.core.diagnosis.work_imbalance_attrs` test — the same
    test the legacy path below runs — so decisions are identical with the
    consumption on or off.  A non-default configuration (custom role,
    scopes, or fallback) keeps reading the cores directly: the diagnosis
    vocabulary does not cover arbitrary role/scope pairings."""

    name = "reshard"

    def __init__(self, role: str = ROLE_WORK,
                 scopes: Tuple[str, ...] = ("external",),
                 fallback_attr: str = "instructions"):
        self.role = role
        self.scopes = tuple(scopes)
        self.fallback_attr = fallback_attr
        self._kind_gated = (role == ROLE_WORK
                            and self.scopes == ("external",)
                            and fallback_attr == "instructions")

    def _work_attrs(self, entry: WindowEntry, which: str) -> Tuple[str, ...]:
        return work_imbalance_attrs(entry, which, role=self.role,
                                    fallback_attr=self.fallback_attr)

    def observe(self, entry: WindowEntry,
                session: AnalysisSession) -> List[Action]:
        diag = getattr(entry, "diagnosis", None)
        if diag is not None and self._kind_gated:
            if diag.kind != KIND_DATA_SKEW:
                return []
            attrs = tuple(a for a, _ in diag.evidence) or (self.fallback_attr,)
            return [Action(kind="reshard", target=attrs[0],
                           params={"scopes": ("external",), "role": self.role,
                                   "external_core": entry.core_attributes("external"),
                                   "internal_core": entry.core_attributes("internal")})]
        hits = {w: self._work_attrs(entry, w) for w in self.scopes}
        scopes = tuple(w for w in self.scopes if hits[w])
        if not scopes:
            return []
        target = hits[scopes[0]][0]
        return [Action(kind="reshard", target=target,
                       params={"scopes": scopes, "role": self.role,
                               "external_core": entry.core_attributes("external"),
                               "internal_core": entry.core_attributes("internal")})]


class CollectorQuarantinePolicy(Policy):
    """Flag chronically missing *or chronically corrupt* hosts (the
    collector-resilience half).

    ``SnapshotCollector`` ships ``None`` for hosts that time out; the merge
    zero-fills their ranks under ``gap_mask``, which ``ingest_snapshot``
    surfaces as ``entry.gap_ranks``.  One proposal per missing rank: a rank
    absent ``k`` windows in a row is a dead or wedged host, and the fired
    ``quarantine`` action tells the serving layer to stop routing to it and
    page for a replacement.

    ``health`` (a ``launch.collect.TransportHealth``) adds the corruption
    channel: a host whose *cumulative* corrupt + skew count reaches
    ``corrupt_windows`` is proposed as ``"host:<h>"`` every window from
    then on.  Gap streaks alone miss this host — one that alternates good
    and corrupt windows resets its per-rank gap streak every other window,
    but its health counters only ever grow, so the proposal repeats, the
    engine's debounce streak builds, and the quarantine fires."""

    name = "quarantine"

    def __init__(self, health=None, corrupt_windows: int = 3):
        self.health = health
        self.corrupt_windows = int(corrupt_windows)

    def observe(self, entry: WindowEntry,
                session: AnalysisSession) -> List[Action]:
        out = [Action(kind="quarantine", target=int(r),
                      params={"rank": int(r)})
               for r in entry.gap_ranks]
        if self.health is not None:
            for h in self.health.hosts():
                bad = self.health.bad(h)
                if bad >= self.corrupt_windows:
                    out.append(Action(
                        kind="quarantine", target=f"host:{int(h)}",
                        params={"host": int(h), "bad_windows": int(bad),
                                "corrupt": int(self.health.corrupt[h]),
                                "skew": int(self.health.skew[h])}))
        return out


BUILTIN_POLICIES = {
    "rebalance": RebalancePolicy,
    "reshard": ReshardPolicy,
    "quarantine": CollectorQuarantinePolicy,
}


def make_policies(spec: str) -> List[Policy]:
    """Build policies from a comma-separated spec (``"all"`` for every
    built-in) — the parser behind the drivers' ``--policies`` flag."""
    names = [s.strip() for s in spec.split(",") if s.strip()]
    if names == ["all"]:
        names = list(BUILTIN_POLICIES)
    unknown = [n for n in names if n not in BUILTIN_POLICIES]
    if unknown:
        raise ValueError(f"unknown policy {unknown} "
                         f"(known: {sorted(BUILTIN_POLICIES)})")
    return [BUILTIN_POLICIES[n]() for n in names]


class PolicyEngine:
    """Composes policies over a window stream and guards their actuation.

    ``k``: a key must be re-proposed in ``k`` consecutive windows before it
    fires (debounce; ``k=1`` fires immediately).  ``cooldown``: after a
    fire, the same key is suppressed (logged ``rate_limited``) until
    ``cooldown`` further windows have passed; defaults to ``k`` so the
    engine always sees k fresh post-action windows before re-firing.  A
    fire also resets the key's streak — re-firing needs k *new* confirming
    windows either way.

    The engine itself is not thread-safe; each instance must be driven by
    exactly one thread (the sync caller, or the async pipeline's worker)."""

    def __init__(self, policies: Sequence[Policy], *, k: int = 2,
                 cooldown: Optional[int] = None,
                 log: Optional[PolicyLog] = None):
        if k < 1:
            raise ValueError("k must be >= 1")
        if cooldown is not None and cooldown < 0:
            raise ValueError("cooldown must be >= 0")
        self.policies = list(policies)
        names = [p.name for p in self.policies]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate policy names: {names}")
        self.k = k
        self.cooldown = k if cooldown is None else cooldown
        self.log = log if log is not None else PolicyLog()
        self._streaks: Dict[Tuple, List[int]] = {}    # key -> evidence windows
        self._last_fired: Dict[Tuple, int] = {}       # key -> window index

    def observe(self, entry: WindowEntry,
                session: AnalysisSession) -> List[Action]:
        """Run every policy over one analyzed window; return the actions
        that fired.  Every proposal is logged, fired or not."""
        fired: List[Action] = []
        proposed: set = set()
        for pol in self.policies:
            for prop in pol.observe(entry, session):
                prop = dataclasses.replace(prop, policy=pol.name,
                                           window=entry.index)
                key = prop.key()
                if key in proposed:      # a policy double-proposing a key
                    continue             # counts once per window
                proposed.add(key)
                ev = self._streaks.setdefault(key, [])
                ev.append(entry.index)
                evidence = tuple(ev)
                streak = len(ev)
                last = self._last_fired.get(key)
                if streak < self.k:
                    reason = DEBOUNCE
                elif last is not None and \
                        entry.index - last <= self.cooldown:
                    reason = RATE_LIMITED
                else:
                    reason = FIRED
                action = None
                if reason == FIRED:
                    action = dataclasses.replace(prop, evidence=evidence)
                    fired.append(action)
                    self._last_fired[key] = entry.index
                    ev.clear()           # k fresh windows before a re-fire
                self.log.append(Decision(
                    window=entry.index, policy=prop.policy, kind=prop.kind,
                    target=prop.target, reason=reason, streak=streak,
                    evidence=evidence, action=action))
        # a key not re-proposed this window loses its streak: "consecutive"
        # means consecutive
        for key in [k_ for k_ in self._streaks if k_ not in proposed]:
            del self._streaks[key]
        return fired
