"""Model step: the window's whole-prompt and chunk steps' share of the
bf16 peak: the FLOPs their prompts need (``rooflines/model_step.py``)
over their host time."""
from servebench.harness.window import step_mfu


def read(w):
    ms = w.roofline("model_step")

    def flops(o):
        if o.kind == "prefill":
            return ms.chunk(w.model, 0, o.shape[0])
        return ms.chunk(w.model, o.shape[0], o.shape[1])
    return step_mfu(w, ("prefill", "chunk"), flops)
