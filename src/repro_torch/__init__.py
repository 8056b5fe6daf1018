"""PyTorch/CUDA port of the SLICE serving stack (the JAX package ``repro``
is the reference). The port keeps the reference's module names: a
control plane copied as is (configs, core, data, serving), the model in
PyTorch (models), and hand-written CUDA kernels for the attention hot
paths (kernels, csrc)."""
