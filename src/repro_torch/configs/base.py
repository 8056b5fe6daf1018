"""Architecture + shape configuration dataclasses.

Every assigned architecture gets one module in this package exporting
``CONFIG: ArchConfig``. ``registry.get_config(name)`` resolves them, and
``reduced()`` derives the CPU smoke-test variant (2 layers, d_model<=512,
<=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"  # parallel attention + SSM heads (Hymba)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    block_kind: str              # DENSE/MOE/SSM/HYBRID — per-layer mixer+ffn kind
    n_layers: int
    d_model: int
    n_heads: int                 # query heads (0 for attn-free)
    n_kv_heads: int
    head_dim: int                # explicit; q_dim = n_heads*head_dim may != d_model
    d_ff: int
    vocab_size: int
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # attention flavour
    causal: bool = True          # False => encoder-only (no decode step)
    sliding_window: Optional[int] = None   # used for long-context decode
    rope_theta: float = 1e6
    # modality frontend stub: inputs are precomputed embeddings, not token ids
    embedding_inputs: bool = False
    # provenance
    source: str = ""
    norm_eps: float = 1e-5

    # ---- derived ----
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding: odd vocab sizes (122753, 49155,
        92553, ...) cannot be input-sharded over the 16-way 'model' axis,
        which forces a D-sharded head and a full-logits partial-sum
        all-reduce (12.9 GB per step for granite). Pad to a multiple of 2048
        (16 shards x 128 lanes); the pad rows are masked at the loss/sample
        boundary. Vocabs already divisible by 16 shard fine unpadded —
        padding them only adds logits traffic (measured +30% on yi-6b's
        train memory term), so they are left alone."""
        if self.vocab_size % 16 == 0:
            return self.vocab_size
        m = 2048
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0 and self.block_kind in (SSM, HYBRID)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        p = self.vocab_size * d * (1 if self.tied_embeddings else 2)
        per_layer = 0
        if self.has_attention:
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.has_ssm:
            di = self.ssm_inner
            # in_proj (z,x,B,C,dt) + out_proj + conv
            conv_dim = di + 2 * self.ssm_state
            per_layer += d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
            per_layer += di * d + conv_dim * self.ssm_conv
        if self.block_kind == MOE:
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * f
        elif f > 0:
            per_layer += 3 * d * f  # gated mlp
        return p + L * per_layer

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.block_kind != MOE:
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        total = self.n_params()
        moe_all = L * self.n_experts * 3 * d * f
        moe_active = L * self.top_k * 3 * d * f
        return total - moe_all + moe_active

    tied_embeddings: bool = False

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        d = min(self.d_model, 256)
        hd = 32
        n_h = max(2, min(4, self.n_heads)) if self.n_heads else 0
        n_kv = 0
        if self.n_heads:
            n_kv = 1 if self.n_kv_heads < self.n_heads else n_h
            while n_h % max(n_kv, 1):  # keep GQA divisibility
                n_kv += 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=d,
            n_heads=n_h,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            sliding_window=64 if self.sliding_window else None,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    # decode shapes attend over a cache of seq_len and emit ONE token
    sub_quadratic_required: bool = False


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode", sub_quadratic_required=True)

SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPE_BY_NAME = {s.name: s for s in SHAPES}
