"""The paper's own testbed model: ChatGLM2-6B-class dense GQA decoder
(28L d=4096 32H kv=2 d_ff=13696 vocab=65024) served on an edge device."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="edge-6b", family="dense", block_kind="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=65024, sliding_window=8192,
    source="paper testbed: ChatGLM2-6B",
)
