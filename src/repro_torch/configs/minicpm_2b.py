"""MiniCPM-2B: llama-like dense MHA (kv=36), WSD schedule [arXiv:2404.06395]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense", block_kind="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab_size=122753, sliding_window=8192,
    source="arXiv:2404.06395",
)
