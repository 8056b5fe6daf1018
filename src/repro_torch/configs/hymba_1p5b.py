"""Hymba-1.5B: hybrid-head layers — parallel attention + Mamba(SSM) heads
fused per layer [arXiv:2411.13676]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid", block_kind="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, ssm_state=16, ssm_expand=2, ssm_head_dim=64,
    sliding_window=1024,  # Hymba uses SWA on most layers
    source="arXiv:2411.13676",
)
