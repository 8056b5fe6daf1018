"""Llama-4-Scout-17B-16E: MoE 16 experts top-1, early fusion (text path)
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe", block_kind="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048, n_experts=16, top_k=1, sliding_window=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
