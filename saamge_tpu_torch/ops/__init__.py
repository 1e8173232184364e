"""Kernel wrappers of the port: each module holds a hand-written CUDA
kernel's wrapper and its plain torch version side by side.  A CUDA
tensor launches the kernel (or raises); a CPU tensor runs the plain
version.

Every wrapper launches on PyTorch's current stream and reads no tensor
value on the host, so it can be captured in a CUDA graph
(solve/device_pcg.py); its outputs then come from the graph's memory
pool.  Each wrapper's ``launches`` counter (and ``mode_launches`` where
it has modes) adds one where the wrapper launches its kernel: every
launch of an eager call, but for a captured graph only the one
recording at capture, since a replay runs no Python."""
