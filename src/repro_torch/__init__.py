"""PyTorch / CUDA port of the FedALIGN system in ``repro``.

The package mirrors ``repro``'s subpackage and function names so each
counterpart is easy to find, but imports nothing from it (and never
``jax``): where it needs code from there it keeps its own copy.

Entry points take an explicit ``device`` argument that defaults to
``"cuda"``. Asking for the card on a machine without one raises; it never
carries on on the CPU. Pass ``device="cpu"`` to run there, as the tests do.

Each Pallas kernel of the reference that the port has reached is a
hand-written CUDA kernel under ``kernels/csrc/`` (fedagg, the flash-attention
forward and backward, decode attention, RMSNorm). Everything else is plain
PyTorch: cuBLAS / cuDNN through autograd and ``torch.func``.
"""
