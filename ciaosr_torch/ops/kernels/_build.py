"""Build and load the port's CUDA kernels.

Each ``ciaosr_torch/csrc/<name>.cu`` is compiled by nvcc into its own
shared library with a plain C interface, loaded with ctypes. Builds run at
first use, never at import, keyed on a hash of every source under csrc/,
into ``ciaosr_torch/_build/<hash>/`` (git-ignored). All sources compile in
parallel, one nvcc process each. Only the repository's own sources are
compiled; nothing falls back when a build fails — it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
KERNELS = ("f3p_build", "wt_hoist_sm90", "grid_decode_sm90",
           "csa_stencil_sm90", "csa_flash", "csa_paste", "swin_block_sm90",
           "swin_block_bwd_sm90")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "-lineinfo"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def build_dir() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every kernel library that is not built yet; returns the
    seconds taken. Raises with nvcc's output if any build fails."""
    out = build_dir()
    todo = [k for k in KERNELS if not (out / f"lib{k}.so").exists()]
    if not todo:
        return 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for k in todo:
        tmp = out / f"lib{k}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{k}.cu")]
        procs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for k, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out / f"{k}.log").write_text(log)
        if proc.returncode:
            failed.append(f"--- {k} (rc {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out / f"lib{k}.so")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    if name not in _libs:
        build_all()
        _libs[name] = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
    return _libs[name]


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def check_tensor(t, shape: tuple, name: str, dtype=None) -> None:
    """Raise unless t is a contiguous CUDA tensor of this shape and dtype
    (default bf16) — what a kernel takes."""
    dtype = dtype or torch.bfloat16
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """The current stream of ``device``, the launch's tensors' device;
    raises unless it is the current device. The kernels' shared-memory
    attributes and SM counts are set once per process on the current
    device (``allow_smem``, csrc/common.cuh), so a process runs on one GPU:
    its launches must not go to another."""
    device = torch.device(device)
    current = torch.cuda.current_device()
    if device.index != current:
        raise RuntimeError(
            f"kernel launch on {device} while the current device is "
            f"cuda:{current}: the port runs one process per GPU; call "
            f"torch.cuda.set_device({device.index}) first")
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
