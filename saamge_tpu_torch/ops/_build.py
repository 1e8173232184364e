"""Build of the hand-written CUDA kernels.

All ``saamge_tpu_torch/csrc/*.cu`` files are compiled by ``nvcc`` for
``sm_90a`` (one nvcc process per source, all started together) and
linked into one shared library with a plain C interface, cached under
``build/saamge_tpu_torch/`` of the checkout and keyed by a hash of the
sources, and loaded with ``ctypes``.  The build happens at the first
kernel launch, never at import.  A failed build or load raises: there
is no fallback that would hide the card."""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

from saamge_tpu_torch.utils.logging import TIMERS

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "saamge_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
MAX_ROOTS = 32          # SAAMGE_MAX_ROOTS of csrc/common.cuh
SMEM_MAX = 232448       # shared bytes one block may use on an H100
H100_SMS = 132          # SMs of an H100 SXM
GRID_MAX = (2 ** 31 - 1, 65535)

_lock = threading.Lock()
_lib = None
ptxas_log = {}                # source name -> nvcc -Xptxas -v report


class KernelBuildError(RuntimeError):
    pass


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (CUDA_HOME or PATH)")
    return found


def _declare(lib) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.saamge_stencil.argtypes = [I, P, I, P, I, I, I, P, P, P, F, P, P]
    lib.saamge_wavefront.argtypes = [P, I, P, I, I, I, P, I, I, P, P, P,
                                     P, P, P, P]
    lib.saamge_window_R.argtypes = [I, P, P, P, P, P, P]
    lib.saamge_window_P.argtypes = [I, P, P, P, P, P, P]
    lib.saamge_mid_chain.argtypes = [P, I, P, I, P, P, I, I, P, P, P, P,
                                     P, P, P]
    lib.saamge_mfree.argtypes = [I, P, P, I, P, I, I, I, I, P, P, P, P, F,
                                 P, P]
    lib.saamge_mfree_point.argtypes = [I, P, P, I, P, I, I, I, I, P, P, P,
                                       F, P, P]
    lib.saamge_mfree_chain.argtypes = [P, P, I, P, I, I, I, I, P, P, I, I, P,
                                       P, P, P, P, P, P]
    lib.saamge_midmv.argtypes = [I, P, I, P, I, P, P, P, P, F, P, P]
    lib.saamge_contract_R.argtypes = [P, P, P, P, I, P, P, P, P]
    lib.saamge_contract_P.argtypes = [I, P, P, I, I, I, P, P, P]
    lib.saamge_blockrow.argtypes = [I, P, P, P, I, P, I, P, P, P, F, P, P]
    for name in ("saamge_stencil", "saamge_wavefront", "saamge_window_R",
                 "saamge_window_P", "saamge_mid_chain", "saamge_mfree",
                 "saamge_mfree_point", "saamge_mfree_chain",
                 "saamge_midmv", "saamge_contract_R", "saamge_contract_P",
                 "saamge_blockrow"):
        getattr(lib, name).restype = I
    lib.saamge_error_string.argtypes = [I]
    lib.saamge_error_string.restype = ctypes.c_char_p


def _run(cmds):
    """Run the nvcc commands in parallel; wait for all, then raise if
    any failed.  Returns each command's standard error."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed, errs = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise KernelBuildError("\n".join(failed))
    return errs


def _compile(so: str) -> None:
    nvcc = _nvcc()
    work = f"{so}.{os.getpid()}.d"
    os.makedirs(work, exist_ok=True)
    try:
        objs, cmds = [], []
        srcs = [p for p in sources() if p.endswith(".cu")]
        for src in srcs:
            obj = os.path.join(work, os.path.basename(src) + ".o")
            objs.append(obj)
            cmds.append([nvcc] + NVCC_FLAGS + ["-Xptxas", "-v", "-I", CSRC,
                                               "-c", src, "-o", obj])
        for src, err in zip(srcs, _run(cmds)):
            ptxas_log[os.path.basename(src)] = err
        tmp = os.path.join(work, "lib.so")
        _run([[nvcc] + NVCC_FLAGS + ["-shared", "-o", tmp] + objs])
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load():
    """Build (once per source hash) and load the kernel library: the
    phase ``kernels.load`` of utils/logging.TIMERS, and one count of
    ``kernels.builds`` when nvcc runs."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with TIMERS.phase("kernels.load"):
            so = os.path.join(BUILD_DIR, f"libsaamge_kernels_{_digest()}.so")
            if not os.path.exists(so):
                _compile(so)
                TIMERS.count("kernels.builds")
            lib = ctypes.CDLL(so)
            _declare(lib)
        _lib = lib
        return lib


def check_plan(threads: int, grid, smem: int) -> None:
    """Raise unless a launch plan is within the card's limits."""
    if not (32 <= threads <= 1024 and threads % 32 == 0):
        raise ValueError(f"{threads} threads per block")
    if not all(1 <= g <= m for g, m in zip(grid, GRID_MAX)):
        raise ValueError(f"grid {grid} outside {GRID_MAX}")
    if not 0 <= smem <= SMEM_MAX:
        raise ValueError(f"{smem} shared bytes > {SMEM_MAX}")


def ptxas_resources(source: str, kernel: str):
    """[(entry, registers, static shared bytes, spill stores, spill
    loads)] of the entry functions of ``source`` whose mangled name holds
    ``kernel``, from the -Xptxas -v report of this process's build."""
    out, entry, spill = [], None, (0, 0)
    for line in ptxas_log.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if kernel in m.group(1) else None
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((entry, int(m.group(1)),
                        int(smem.group(1)) if smem else 0, *spill))
            entry = None
    return out


def check_launch(lib, code: int, what: str) -> None:
    """Raise if the C launcher reported a CUDA error."""
    if code != 0:
        msg = lib.saamge_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def int_array(values):
    """Host int32 array for a launcher argument; keep the returned object
    alive across the call and pass ``ctypes.addressof`` of it."""
    values = [int(v) for v in values]
    return (ctypes.c_int * max(len(values), 1))(*values)


def float_array(values):
    values = [float(v) for v in values]
    return (ctypes.c_float * max(len(values), 1))(*values)


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
