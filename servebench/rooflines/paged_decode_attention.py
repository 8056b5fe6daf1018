"""Work of the paged decode attention (``csrc/paged_decode_attention.cu``,
split and combine kernels) over one decode step, every attending layer
(the layout's ``attn_layers``): each live key and value read once, each
query read and each output written once. ``KERNEL`` matches its
kernels' names in the profiler."""
from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

from servebench.harness import registry

KERNEL = re.compile(r"split_attn::")


def work(m: Dict, keys: Sequence[int], eb: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one step whose row r attends ``keys[r]`` keys."""
    hd, Hq, Hkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    L = registry.layout_of(m).attn_layers(m)
    flops = sum(4 * hd * Hq * k for k in keys) * L
    nbytes = sum(2 * k * Hkv * hd + 2 * Hq * hd for k in keys) * eb * L
    return float(flops), float(nbytes)
