"""SmolLM-360M: llama-arch small dense GQA [hf:HuggingFaceTB/SmolLM-135M family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense", block_kind="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152, sliding_window=8192,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
