"""Kernels: the grouped-expert FFN's device ms per profiled decode step
(``rooflines/moe_grouped_ffn.py`` names its kernels)."""


def read(w):
    rl = w.roofline("moe_grouped_ffn")
    ops = w.profiled("decode")
    if not ops:
        return None
    t = sum(s for o in ops for name, s in w.kernels_by_op.get(o.serial, ())
            if rl.KERNEL.search(name))
    return 1000.0 * t / len(ops) if t > 0 else None
