"""Work of the chunk entry of the flash prefill (``csrc/flash_prefill.cu``,
``flash_prefill_chunk``), every attending layer (the layout's
``attn_layers``): ``n`` queries after ``start`` cached keys, causal
(query i sees start + i + 1 keys); Q read and the output written once,
the keys and values of the prefix and the chunk read once."""
from __future__ import annotations

import re
from typing import Dict, Tuple

from servebench.harness import registry

KERNEL = re.compile(r"::(tc|cc)::kernel<")


def work(m: Dict, start: int, n: int, eb: int) -> Tuple[float, float]:
    hd, Hq, Hkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    Ls = registry.layout_of(m).attn_layers(m)
    flops = 4 * hd * Hq * (n * start + n * (n + 1) // 2) * Ls
    nbytes = (2 * n * Hq * hd + 2 * (start + n) * Hkv * hd) * eb * Ls
    return float(flops), float(nbytes)
