"""Task model: SLO spec, utility, and runtime accounting (paper §IV-A).

Real-time tasks carry an end-to-end deadline which is translated into dual
TTFT/TPOT constraints (paper: "we translate the deadline constraints of
real-time tasks into dual-metric requirements for TTFT and TPOT").
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

_ids = itertools.count()


@dataclasses.dataclass
class SLOSpec:
    tpot_ms: float                     # max time-per-output-token
    ttft_ms: float = 1_000.0           # max time-to-first-token
    deadline_ms: Optional[float] = None  # end-to-end (real-time tasks only)
    realtime: bool = False

    @staticmethod
    def realtime_deadline(deadline_ms: float, output_len: int,
                          ttft_frac: float = 0.25) -> "SLOSpec":
        """Paper's translation: split the deadline into a TTFT budget and a
        per-token budget for the remaining tokens."""
        ttft = deadline_ms * ttft_frac
        tpot = (deadline_ms - ttft) / max(output_len - 1, 1)
        return SLOSpec(tpot_ms=tpot, ttft_ms=ttft, deadline_ms=deadline_ms,
                       realtime=True)

    @property
    def rate(self) -> float:
        """Required generation rate v_i = 1/T_TPOT (tokens/s)."""
        return 1000.0 / self.tpot_ms


@dataclasses.dataclass
class Task:
    slo: SLOSpec
    utility: float
    prompt_len: int = 128
    output_len: int = 64               # tokens to generate (incl. first)
    arrival_ms: float = 0.0
    task_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    kind: str = "generic"              # control | navigation | voice | qa ...

    # shared-prompt-prefix metadata (DESIGN.md §6): tasks in the same
    # prefix_group open with the same prefix_len prompt tokens (a shared
    # system prompt / task template), which the radix prefix cache
    # deduplicates. None/0 = fully private prompt.
    prefix_group: Optional[int] = None
    prefix_len: int = 0

    # fleet routing (DESIGN.md §11): quality-tier requests demand a model
    # tier >= min_tier (0 = any model qualifies — the single-model default,
    # which leaves slo_met unchanged). routed_to is the fleet-layer
    # admission record (written once, never moved); served_by/served_tier
    # name the instance that actually serves the tokens — a spill rewrites
    # these BEFORE any engine-side progress, so token attribution is
    # always unique.
    min_tier: int = 0
    routed_to: Optional[str] = None
    served_by: Optional[str] = None
    served_tier: Optional[int] = None

    # runtime accounting (filled by the serving loop)
    prefill_done_ms: Optional[float] = None
    prefill_done_tokens: int = 0       # prompt tokens cached (chunked prefill)
    token_times_ms: list = dataclasses.field(default_factory=list)
    dropped: bool = False
    # Cache swapped to host (DESIGN.md §7, §12): logical length preserved,
    # device residency released — KV pages for attention archs, the
    # constant-size recurrent-state slot for SSM/hybrid archs, both for
    # hybrids (one atomic stash; see serving/kv_swap.py). Must be resumed
    # before decoding again. The serving loop flips this after the
    # executor's suspend/resume actually runs.
    suspended: bool = False

    # dynamic utility (Algorithm 4 UtilityAdaptor may rescale)
    effective_utility: Optional[float] = None

    def __post_init__(self):
        if self.effective_utility is None:
            self.effective_utility = self.utility

    # ---- paper quantities ----
    @property
    def rate(self) -> float:
        return self.slo.rate

    @property
    def utility_rate(self) -> float:
        """Eq. (6): r_i = U_i * T_TPOT_i (utility per token/s consumed)."""
        return self.effective_utility * (self.slo.tpot_ms / 1000.0)

    # ---- progress ----
    @property
    def tokens_done(self) -> int:
        return len(self.token_times_ms)

    @property
    def finished(self) -> bool:
        return self.tokens_done >= self.output_len

    # ---- measured metrics ----
    @property
    def ttft_ms(self) -> Optional[float]:
        if not self.token_times_ms:
            return None
        return self.token_times_ms[0] - self.arrival_ms

    @property
    def tpot_measured_ms(self) -> Optional[float]:
        """Steady-state TPOT: mean inter-token gap EXCLUDING the gap between
        the prefill-emitted first token and the first decode token — that gap
        is admission queueing (TTFT-like), not decode rate. Matches the
        paper's per-class 'Actual TPOT' accounting (Table II)."""
        tt = self.token_times_ms
        if len(tt) < 2:
            return self.ttft_ms
        if len(tt) == 2:
            return tt[1] - tt[0]
        return (tt[-1] - tt[1]) / (len(tt) - 2)

    @property
    def completion_ms(self) -> Optional[float]:
        if not self.finished or not self.token_times_ms:
            return None
        return self.token_times_ms[-1] - self.arrival_ms

    def tier_met(self) -> bool:
        """Fleet routing (DESIGN.md §11): a quality-tier request counts
        only when served by a model of at least its tier — degraded-mode
        fallback keeps it flowing but not attaining. Tasks with
        min_tier == 0 (every single-model workload) always pass."""
        if self.min_tier <= 0:
            return True
        return self.served_tier is not None and self.served_tier >= self.min_tier

    def slo_met(self) -> bool:
        """Paper §VI-A Metrics: RT -> completion <= deadline;
        non-RT -> TTFT and TPOT SLOs both satisfied. Quality-tier
        requests (min_tier > 0) additionally require a qualifying model
        tier (DESIGN.md §11)."""
        if self.dropped or not self.finished:
            return False
        if not self.tier_met():
            return False
        if self.slo.realtime:
            return self.completion_ms <= self.slo.deadline_ms
        return (self.ttft_ms <= self.slo.ttft_ms
                and self.tpot_measured_ms <= self.slo.tpot_ms)

    def ttft_met(self) -> bool:
        return (self.ttft_ms is not None) and self.ttft_ms <= self.slo.ttft_ms

    def tpot_met(self) -> bool:
        return (self.finished and self.tpot_measured_ms is not None
                and self.tpot_measured_ms <= self.slo.tpot_ms)


# ---- the paper's workload task types (§VI-A) ----

def control_task(arrival_ms=0.0, prompt_len=64, output_len=12,
                 deadline_ms=1500.0, utility=50.0) -> Task:
    """Real-time: machine control / navigation — deadline 1.5 s, >=20 tok/s."""
    return Task(SLOSpec.realtime_deadline(deadline_ms, output_len),
                utility=utility, prompt_len=prompt_len, output_len=output_len,
                arrival_ms=arrival_ms, kind="control")


def voice_task(arrival_ms=0.0, prompt_len=128, output_len=256,
               utility=1.0) -> Task:
    """Non-RT voice chat: >=8 tok/s (TPOT <= 125 ms)."""
    return Task(SLOSpec(tpot_ms=125.0, ttft_ms=2000.0), utility=utility,
                prompt_len=prompt_len, output_len=output_len,
                arrival_ms=arrival_ms, kind="voice")


def qa_task(arrival_ms=0.0, prompt_len=256, output_len=288,
            utility=1.0) -> Task:
    """Non-RT text Q&A: >=10 tok/s (TPOT <= 100 ms)."""
    return Task(SLOSpec(tpot_ms=100.0, ttft_ms=2000.0), utility=utility,
                prompt_len=prompt_len, output_len=output_len,
                arrival_ms=arrival_ms, kind="qa")
