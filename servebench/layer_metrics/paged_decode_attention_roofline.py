"""Kernels: the paged decode attention's share of its roofline over the
profiled decode steps (``rooflines/paged_decode_attention.py``)."""
from servebench.harness.window import kernel_share


def read(w):
    rl = w.roofline("paged_decode_attention")
    return kernel_share(w, "decode", "paged_decode_attention",
                        lambda o: rl.work(w.model, o.shape, w.elem_bytes))
