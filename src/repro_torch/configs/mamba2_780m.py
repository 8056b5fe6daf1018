"""Mamba2-780M: attention-free SSD (state-space duality) [arXiv:2405.21060].
d_inner = 2*d_model = 3072, head_dim 64 -> 48 SSM heads, state 128."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm", block_kind="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    tied_embeddings=True, source="arXiv:2405.21060",
)
