"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.
Sources live in ``csrc/``; ``build.py`` compiles them with nvcc on first use.
Nothing is compiled or imported from triton when this package is imported."""
