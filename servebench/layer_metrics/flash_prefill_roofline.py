"""Kernels: the whole-prompt flash prefill's share of its roofline over
the profiled prefills (``rooflines/flash_prefill.py``)."""
from servebench.harness.window import kernel_share


def read(w):
    rl = w.roofline("flash_prefill")
    return kernel_share(w, "prefill", "flash_prefill",
                        lambda o: rl.work(w.model, o.shape[0], w.elem_bytes))
