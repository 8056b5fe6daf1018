"""Small models and mixes that run the benchmark's path on the CPU."""
import copy

from servebench.harness import registry

TINY_DENSE = {"name": "tiny-dense", "family": "dense", "block_kind": "dense",
              "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
              "head_dim": 16, "d_ff": 128, "vocab_size": 512,
              "sliding_window": 8192, "rope_theta": 1e6, "norm_eps": 1e-5}
TINY_MOE = {**TINY_DENSE, "name": "tiny-moe", "family": "moe",
            "block_kind": "moe", "d_model": 128, "head_dim": 32,
            "d_ff": 64, "n_experts": 16, "top_k": 4}


def tiny_mix(traffic: str, prefill_chunk=None) -> dict:
    """A cell's traffic file cut to lengths a CPU engine serves quickly:
    the same classes, SLOs and scheduler; prompts go in whole, or in
    pieces of ``prefill_chunk``."""
    mix = copy.deepcopy(registry.traffic(traffic))
    mix["engine"] = {"max_batch": 8, "max_seq": 512, "page_size": 16,
                     "pages": 256, "prefill_chunk": prefill_chunk}
    for c in mix["classes"]:
        p = c["prompt"]
        p["lo"], p["hi"] = min(p["lo"], 50), min(p["hi"], 100)
        o = c["output"]
        o["mean"], o["sd"] = min(o["mean"], 24), min(o["sd"], 3)
    mix["drain_s"] = 20
    return mix
