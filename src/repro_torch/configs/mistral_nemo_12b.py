"""Mistral-Nemo-12B: dense GQA, head_dim=128 (q_dim 4096 != d_model 5120),
128k context [hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense", block_kind="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, sliding_window=8192,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
