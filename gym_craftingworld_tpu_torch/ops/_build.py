"""Build the package's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

On first CUDA use, ``load()`` compiles ``csrc/*.cu`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and links the objects into one
shared library with a plain C interface, under ``build/kernels/`` at the root
of the checkout, and loads it. The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Only sources in the repository are compiled.

Every C entry point takes its device pointers and the stream as ``void *``
and returns ``cudaGetLastError()``; ``check()`` raises on a nonzero code. A
missing compiler, a failed build or a failed load raises too: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U32, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# C signatures of the entry points in csrc/*.cu
_SIGNATURES = {
    # packed_fused.cu
    # in[13], out[9], checksum, B, T, height, width, max_steps, reward_equal, seed, stream
    "cw_packed_bench": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _U32, _P),
    # in[13], out[9], actions, reward, done, B, T, height, width, max_steps, reward_equal, stream
    "cw_packed_actions": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # out, B, T, seed, stream
    "cw_action_stream": (_P, _I, _I, _U32, _P),
    # fused_rollout.cu
    # in[10], out[6], actions (NULL: Philox), reward, done, B, T, height, width,
    # max_steps, reward_equal, seed, stream
    "cw_fused_rollout": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U32, _P),
    # in[14], out[8], reward, done, B, T, height, width, max_steps, reward_equal,
    # seed, stream
    "cw_fused_rollout_t": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U32, _P),
    # fused_reset.cu
    # seeds, picks, n, hw, sel_mask, n_sel, n_tasks, stacking, stream
    "cw_pool": (_P, _P, _I, _I, _U32, _I, _I, _I, _P),
    # fused_update.cu
    # in[13], work[8], out[6], n, f, h, blk, s_w1, s_w2, s_head,
    # clip_eps, vf_coef, ent_coef, stream
    "cw_ppo_grads": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelBuildError("nvcc not found: put the CUDA toolkit's bin on PATH "
                           "or set CUDA_HOME")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libcw_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless they are built; (path, seconds, nvcc log)."""
    path = _library_path()
    if path.exists():
        return path, 0.0, ""
    cus, _ = _sources()
    if not cus:
        raise KernelBuildError(f"no CUDA sources in {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in cus]
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(cu)]
                         for cu, o in zip(cus, objs))]
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    try:
        if not failed:
            cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link failed ({proc.returncode}):\n{' '.join(cmd)}\n{logs[-1]}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError("\n".join(failed))
    os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
    return path, seconds, "".join(logs)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    path, _, _ = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {path}: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cw_error_string.argtypes = (ctypes.c_int,)
    lib.cw_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        what = load().cw_error_string(code).decode()
        raise KernelLaunchError(f"{name}: CUDA error {code} ({what})")


def pointer_array(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers, for the C entry points."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
