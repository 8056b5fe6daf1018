"""Decode latency models l(b) (paper Fig. 1, Table I notation).

l(b) = wall-clock of one decode iteration at batch size b. The paper measures
ChatGLM2-6B-INT4 on an RTX 4060 Ti: near-linear growth up to b~9 where
l(9) ~ 128.6 ms (Orca's uniform TPOT in Table II), flattening afterwards.

Three provenances, one interface:
  AnalyticalLatencyModel  — closed-form, calibrated to the paper's numbers.
  MeasuredLatencyModel    — piecewise-linear fit of observed (b, ms) samples
                            (what a deployment measures on its own engine).
  RooflineLatencyModel    — derived from the dry-run compiled artifact of an
                            (arch x mesh): weight-streaming HBM term +
                            per-token compute term + collective term.
"""
from __future__ import annotations

import bisect
from typing import Dict, Sequence, Tuple


class LatencyModel:
    # Host-offload KV swap pricing (DESIGN.md §7): moving a suspended task's
    # KV between device and host is a pure bandwidth transfer over the
    # host link. Defaults model the paper's testbed — ChatGLM2-6B fp16 KV
    # (28 layers x 2 KV heads x 128 head dim x 2 bytes x K&V = 28 KiB per
    # token) over a PCIe-class 8 GB/s link — and are plain attributes so a
    # deployment (or serve.py --swap-bw-gbps) can overwrite them on any
    # model instance without subclassing.
    swap_bw_gbps: float = 8.0
    kv_bytes_per_token: float = 28672.0
    swap_overhead_ms: float = 0.2          # per-transfer launch/pinning cost

    # Speculative-decode pricing (DESIGN.md §8): decode on the edge device
    # is memory-bound (weight streaming dominates), so verifying k extra
    # query positions in one step costs a small per-token compute
    # increment on top of l(b) — the weights stream either way — and the
    # default draft (the target cut to one layer, spec_decode.py) prices
    # a draft step near 1/n_layers of the target's: ~1/28 for the paper's
    # ChatGLM2-6B testbed, padded for embed/unembed overhead. Plain
    # attributes (like the swap terms) so a deployment can calibrate them
    # on any model instance.
    draft_ms_frac: float = 0.08            # one draft step vs l(b)
    verify_token_frac: float = 0.04        # marginal verify query vs l(b)
    spec_accept_rate: float = 0.8          # modeled per-token acceptance
                                           # (SimExecutor's expectation)

    def decode_ms(self, batch: int) -> float:
        raise NotImplementedError

    def draft_ms(self, batch: int, depth: int) -> float:
        """Cost of drafting ``depth`` tokens autoregressively for a batch
        (the draft model steps the whole batch in lockstep)."""
        if depth <= 0:
            return 0.0
        return depth * self.draft_ms_frac * self.decode_ms(batch)

    def verify_ms(self, batch: int, depth: int) -> float:
        """One verify step over windows of up to depth+1 query positions:
        the base decode iteration plus the marginal multi-query compute."""
        return self.decode_ms(batch) * (1.0 + self.verify_token_frac
                                        * max(depth, 0))

    def spec_token_ms(self, batch: int) -> float:
        """Marginal cost of ONE speculative token at batch size b — what a
        unit of the scheduler's Eq. 7 depth budget spends
        (selection.spec_depth_budget)."""
        return (self.draft_ms_frac + self.verify_token_frac) * self.decode_ms(batch)

    def prefill_ms(self, prompt_len: int) -> float:
        raise NotImplementedError

    def swap_ms(self, n_tokens: int) -> float:
        """One-way device<->host transfer time for n_tokens of KV (used by
        SimExecutor.suspend/resume and by the scheduler's resume-headroom
        pricing so planned swap-ins never break Eq. 7's cycle budget)."""
        if n_tokens <= 0 or self.swap_bw_gbps <= 0:
            return 0.0
        return (self.swap_overhead_ms
                + n_tokens * self.kv_bytes_per_token / (self.swap_bw_gbps * 1e6))

    def __call__(self, batch: int) -> float:
        if batch <= 0:
            return 0.0
        return self.decode_ms(batch)

    def max_throughput(self, batch: int) -> float:
        """b / l(b), tokens/s (Eq. 5 RHS)."""
        return 0.0 if batch <= 0 else 1000.0 * batch / self(batch)


class AnalyticalLatencyModel(LatencyModel):
    """l(b) = base + slope*b up to a knee, then a flatter slope.

    Defaults calibrated so l(9) = 128.6 ms (paper Table II, Orca) and
    decode rate per task drops below 10 tok/s past b=9 (paper Fig. 1).
    """

    def __init__(self, base: float = 20.0, slope: float = 12.07,
                 knee: int = 9, post_knee_slope: float = 1.5,
                 prefill_ms_per_token: float = 0.9,
                 prefill_base_ms: float = 15.0):
        self.base, self.slope, self.knee = base, slope, knee
        self.post_knee_slope = post_knee_slope
        self.prefill_ms_per_token = prefill_ms_per_token
        self.prefill_base_ms = prefill_base_ms

    def decode_ms(self, batch: int) -> float:
        if batch <= self.knee:
            return self.base + self.slope * batch
        return (self.base + self.slope * self.knee
                + self.post_knee_slope * (batch - self.knee))

    def prefill_ms(self, prompt_len: int) -> float:
        return self.prefill_base_ms + self.prefill_ms_per_token * prompt_len


class MeasuredLatencyModel(LatencyModel):
    """Piecewise-linear interpolation over measured (batch, ms) samples."""

    def __init__(self, samples: Sequence[Tuple[int, float]],
                 prefill_samples: Sequence[Tuple[int, float]] = ()):
        if not samples:
            raise ValueError("need at least one (batch, ms) sample")
        self._bs = sorted(dict(samples).items())
        self._ps = sorted(dict(prefill_samples).items()) or [(1, 1.0)]

    @staticmethod
    def _interp(table, x: float) -> float:
        xs = [t[0] for t in table]
        i = bisect.bisect_left(xs, x)
        if i == 0:
            lo, hi = table[0], table[min(1, len(table) - 1)]
        elif i >= len(table):
            lo, hi = table[-2] if len(table) > 1 else table[-1], table[-1]
        else:
            lo, hi = table[i - 1], table[i]
        if hi[0] == lo[0]:
            return float(lo[1])
        w = (x - lo[0]) / (hi[0] - lo[0])
        return float(lo[1] + w * (hi[1] - lo[1]))

    def decode_ms(self, batch: int) -> float:
        return self._interp(self._bs, batch)

    def prefill_ms(self, prompt_len: int) -> float:
        return self._interp(self._ps, prompt_len)

    @staticmethod
    def fit(measure_fn, batches: Sequence[int],
            prompt_lens: Sequence[int] = (),
            prefill_fn=None) -> "MeasuredLatencyModel":
        dec = [(b, measure_fn(b)) for b in batches]
        pre = [(s, prefill_fn(s)) for s in prompt_lens] if prefill_fn else ()
        return MeasuredLatencyModel(dec, pre)


class RooflineLatencyModel(LatencyModel):
    """l(b) from first principles for an (arch x mesh):

      l(b) = max(weight_bytes/HBM_bw, b*flops_per_tok/peak) + coll_bytes(b)/link
             + fixed overhead

    In the memory-bound decode regime (small b) this is nearly flat in b —
    exactly the regime where SLICE's economics change vs. the edge GPU (see
    EXPERIMENTS.md §Perf): admission is then bounded by HBM residency, not
    by per-step latency growth.
    """

    def __init__(self, active_param_bytes: float, flops_per_token: float,
                 kv_bytes_per_token: float, chips: int = 1,
                 hbm_bw: float = 819e9, peak_flops: float = 197e12,
                 link_bw: float = 50e9, collective_bytes_per_step: float = 0.0,
                 overhead_ms: float = 0.5):
        self.wb = active_param_bytes
        self.fpt = flops_per_token
        self.kvb = kv_bytes_per_token
        self.chips = chips
        self.hbm_bw, self.peak, self.link = hbm_bw, peak_flops, link_bw
        self.coll = collective_bytes_per_step
        self.overhead_ms = overhead_ms

    def decode_ms(self, batch: int) -> float:
        mem_s = (self.wb / self.chips + batch * self.kvb) / self.hbm_bw
        comp_s = batch * self.fpt / (self.chips * self.peak)
        coll_s = self.coll / (self.chips * self.link) if self.chips > 1 else 0.0
        return 1000.0 * (max(mem_s, comp_s) + coll_s) + self.overhead_ms

    def prefill_ms(self, prompt_len: int) -> float:
        comp_s = prompt_len * self.fpt / (self.chips * self.peak)
        mem_s = self.wb / (self.chips * self.hbm_bw)
        return 1000.0 * max(comp_s, mem_s) + self.overhead_ms


def moe_expert_factor(cfg) -> float:
    """Activated-expert compute factor of a MoE arch vs. pricing its FFN
    dense over ALL experts: attention/embedding cost is unchanged, the FFN
    runs top_k of n_experts. Approximates the FLOP shares from the config's
    parameter shapes (FFN params 3*D*F per expert vs 4*D^2 attention per
    layer), clamped to [top_k/n_experts, 1]. Returns 1.0 for non-MoE archs
    — safe to apply unconditionally when building a fleet."""
    n_e = getattr(cfg, "n_experts", 0) or 0
    top_k = getattr(cfg, "top_k", 0) or 0
    if n_e <= 1 or top_k <= 0 or top_k >= n_e:
        return 1.0
    d, f = cfg.d_model, cfg.d_ff
    ffn_all = 3.0 * d * f * n_e            # dense-over-all-experts pricing
    other = 4.0 * d * d                    # qkv/out projections per layer
    factor = (other + ffn_all * top_k / n_e) / (other + ffn_all)
    return max(factor, top_k / n_e)


class ExpertScaledLatencyModel(LatencyModel):
    """Wrap any base l(b), scaling compute by a MoE arch's activated-expert
    factor (DESIGN.md §12): grouped decode runs top_k experts per token, so
    a curve calibrated for the dense-equivalent model over-prices the MoE
    engine by ~1/factor. Used where no engine-measured curve exists —
    analytical fleet tiers, routing views — a ``MeasuredLatencyModel``
    probed on the live engine already embeds the real expert cost and
    must NOT be wrapped (factor there would double-count)."""

    def __init__(self, base: LatencyModel, factor: float):
        if factor <= 0:
            raise ValueError(f"factor must be positive, got {factor}")
        self.base = base
        self.factor = float(factor)
        # swap pricing is bandwidth-bound, not expert-dependent
        self.swap_bw_gbps = base.swap_bw_gbps
        self.kv_bytes_per_token = base.kv_bytes_per_token
        self.swap_overhead_ms = base.swap_overhead_ms
        self.draft_ms_frac = base.draft_ms_frac
        self.verify_token_frac = base.verify_token_frac
        self.spec_accept_rate = base.spec_accept_rate

    def decode_ms(self, batch: int) -> float:
        return self.base.decode_ms(batch) * self.factor

    def prefill_ms(self, prompt_len: int) -> float:
        return self.base.prefill_ms(prompt_len) * self.factor


def paper_fig1_model() -> MeasuredLatencyModel:
    """Calibration used by the reproduction benchmarks (paper Fig. 1 +
    Table II anchors, ChatGLM2-6B-INT4 / RTX 4060 Ti):

    - Orca's uniform TPOT at the 9-task static workload = l(9) = 128.6 ms;
    - growth is modest while memory-bound (b <= 7), then spikes near b = 9
      ('when batch size exceeds 9 ... absolute latency spikes above 120 ms');
    - past the knee latency stabilizes (throughput scales ~linearly).

    A *linear* fit through l(9)=128.6 would make the paper's own Table II
    workload inadmissible under Eq. 7 (period >= 1000 ms), so the curve must
    be convex — see EXPERIMENTS.md §Calibration for the derivation.
    """
    return MeasuredLatencyModel(
        [(1, 35.0), (3, 50.0), (5, 65.0), (7, 85.0), (8, 100.0), (9, 128.6),
         (12, 135.0), (16, 142.0), (24, 152.0), (32, 160.0), (64, 200.0)],
        prefill_samples=[(32, 45.0), (128, 130.0), (512, 480.0)],
    )
