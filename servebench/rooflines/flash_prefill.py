"""Work of the whole-prompt flash prefill (``csrc/flash_prefill.cu``,
entry ``flash_prefill``), causal, every attending layer (the layout's
``attn_layers``): the lower triangle of QK and PV, each of Q, K, V read
once and the output written once.
``KERNEL`` matches its kernels' names in the profiler; the chunk entry
shares them, and an op's kind tells the two apart."""
from __future__ import annotations

import re
from typing import Dict, Tuple

from servebench.harness import registry

KERNEL = re.compile(r"::(tc|cc)::kernel<")


def work(m: Dict, L: int, eb: int) -> Tuple[float, float]:
    hd, Hq, Hkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    Ls = registry.layout_of(m).attn_layers(m)
    flops = 2 * hd * Hq * L * (L + 1) * Ls
    nbytes = (2 * L * Hq * hd + 2 * L * Hkv * hd) * eb * Ls
    return float(flops), float(nbytes)
