"""Kernels: the chunk flash prefill's share of its roofline over the
profiled chunk ops (``rooflines/flash_prefill_chunk.py``). An op of
several pieces runs the kernel once a piece a layer; its work is that of
its tokens after its start, which the pieces cover alike."""
from servebench.harness.window import kernel_share


def read(w):
    rl = w.roofline("flash_prefill_chunk")
    return kernel_share(w, "chunk", "flash_prefill_chunk",
                        lambda o: rl.work(w.model, o.shape[0], o.shape[1],
                                          w.elem_bytes))
