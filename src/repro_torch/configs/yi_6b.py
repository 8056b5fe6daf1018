"""Yi-6B: llama-arch dense GQA (kv=4) [arXiv:2403.04652]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense", block_kind="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000, sliding_window=8192,
    source="arXiv:2403.04652",
)
