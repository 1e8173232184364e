"""Precision policy and device checks of the port.

The JAX package pins ``precision="highest"`` on its setup einsums,
because the TPU's default float32 matmul is a single bf16 pass.  The
analog on Hopper is TF32, which cuBLAS and cuDNN may use for float32
products; the port turns it off everywhere."""

from __future__ import annotations

import torch


def pin_fp32_precision() -> None:
    """Full float32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def is_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; raises on a mix or any other device.  The kernels'
    wrappers dispatch on this and nothing else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        devs = {t.device for t in tensors}
        if len(devs) != 1:
            raise ValueError("tensors on several cards: "
                             f"{sorted(map(str, devs))}")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: expected all "
                     "cuda or all cpu")


def check(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless ``t`` has the dtype, shape and contiguity a kernel
    reads it with."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def card_or_cpu(device) -> torch.device:
    """The device a setup step runs on, as the caller named it: a CUDA
    device must exist (no card raises; nothing moves to the CPU on its
    own), the CPU is taken only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, but there is no CUDA "
                           "card; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: expected cuda or cpu")
    return dev
