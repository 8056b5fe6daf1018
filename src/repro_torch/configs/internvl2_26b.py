"""InternVL2-26B language backbone (InternLM2-20B-ish decoder) [arXiv:2404.16821].

VLM: the InternViT-6B vision encoder + MLP projector are STUBBED — input_specs
provides precomputed patch/prompt embeddings of shape (B, S, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm", block_kind="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553, sliding_window=8192,
    embedding_inputs=True, source="arXiv:2404.16821",
)
