"""Model step: the window's decode steps' share of the bf16 peak: the
FLOPs their rows need (``rooflines/model_step.py``) over their host
time."""
from servebench.harness.window import step_mfu


def read(w):
    ms = w.roofline("model_step")
    return step_mfu(w, ("decode",), lambda o: ms.decode(w.model, o.shape))
