"""Kernel wrappers of the port: each module holds a hand-written CUDA
kernel's wrapper and its plain torch version side by side.  A CUDA
tensor launches the kernel (or raises); a CPU tensor runs the plain
version."""
