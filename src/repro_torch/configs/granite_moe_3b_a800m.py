"""Granite-3.0 MoE 3B-A800M style: 40 experts, top-8 routing
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe", block_kind="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, n_experts=40, top_k=8, sliding_window=8192,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
