"""Hand-written Hopper kernels of the port.

Each kernel's CUDA C++ source is under ``csrc/``; ``nvcc.py`` builds it
into a shared library with a plain C entry point at first use, and the
module named after the kernel holds its wrapper (which checks inputs,
launches on the current stream and counts its launches) beside the
plain PyTorch version the tests and the CPU path use.
"""
