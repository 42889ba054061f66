"""Build and load the port's CUDA kernels.

At first use, every ``repro_torch/csrc/*.cu`` is compiled for ``sm_90a``
by its own ``nvcc`` process (all started together), and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``.  No PyTorch header is compiled, which keeps a cold build to
seconds.  The library lives in ``build/torch_kernels/`` at the root of the
checkout (override with ``REPRO_TORCH_BUILD_DIR``) under a name that
carries a hash of the sources and flags, so a changed source is rebuilt.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.  Pointers and the stream are passed as
``ctypes.c_void_p``, sizes as ``ctypes.c_int``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes shared with csrc/*.cu
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

BUILD_INFO: dict = {}
_LIB = None
_LOCK = threading.Lock()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, k_scales, v_scales, rows, ctl, n_offset,
    # B, KH, G, D, MP, NP, PS, S, scale, q_dtype, kv_dtype, partials,
    # scratch, out, o_part, m_part, l_part, stream
    "decode_attention_launch": [_P] * 7 + [_I] * 9 + [_F] + [_I] * 3
                               + [_P] * 6,
    # table, m, keys, hv, n, found, slot, stream
    "probe_lookup_launch": [_P, _I, _P, _P, _I, _P, _P, _P],
}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / \
        "torch_kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of repro_torch are built at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: pathlib.Path) -> str:
    """Compile every source in parallel, then link; returns the log."""
    exe = nvcc()
    objdir = out.parent / (out.stem + ".obj")
    objdir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in _sources():
        obj = objdir / (src.stem + ".o")
        cmd = [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [exe, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *[str(o) for _, o, _ in jobs], "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"== link (rc {link.returncode})\n{link.stdout}")
    if link.returncode:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    os.replace(tmp, out)
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = build_dir() / f"libreprotorch_{_digest()}.so"
        t0 = time.perf_counter()
        if out.exists():
            log = "cached"
        else:
            out.parent.mkdir(parents=True, exist_ok=True)
            log = _compile(out)
        lib = ctypes.CDLL(str(out))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                          log=log)
        _LIB = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
