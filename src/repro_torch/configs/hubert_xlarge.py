"""HuBERT-XLarge: encoder-only audio transformer (w2v2 arch) [arXiv:2106.07447].

Audio: the mel-spectrogram + conv feature extractor frontend is STUBBED —
input_specs provides precomputed frame embeddings (B, S, d_model). vocab=504
are the k-means cluster targets for masked prediction. Encoder-only: NO decode
step; decode_32k/long_500k are skipped (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio", block_kind="dense",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504, causal=False, embedding_inputs=True,
    source="arXiv:2106.07447",
)
