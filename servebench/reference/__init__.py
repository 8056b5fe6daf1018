"""Plain PyTorch models the output check holds the port against.

They import nothing of the port and nothing of JAX, run in float32 with
TF32 off, and follow the port's block as the configuration file states
it (each departure from the published model is listed there).
"""
