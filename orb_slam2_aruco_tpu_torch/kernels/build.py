"""Build the CUDA sources with nvcc and load them with ctypes.

A source `csrc/<name>.cu` with a plain C interface builds in seconds (no
PyTorch headers), so every kernel is built from the checkout at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

`build_all()` starts one nvcc per source at once and waits for all of them.
A failed build raises with nvcc's output; there is no fallback.

`build_host_library(src)` builds a host C++ source (native/quadfind.cpp,
the optional quad proposer of ops/aruco/native.py) into the same directory
with native/build.sh's compiler line.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# argtypes of each launcher (pointers and the stream as c_void_p, so ctypes
# never truncates them to 32 bits)
SIGNATURES = {
    "fast": ("fast_score_nms_launch", [P, I, F, F, P]),
    "patches": ("extract_patches_launch", [P, I, P, P]),
    "cc_fused": ("cc_fused_launch", [P, I, I, I, I, P, P, P, P, I, I, P]),
    "cc_propagate": ("cc_propagate_launch", [P, P, I, I, I, I, I, I, P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def _digest(src: str) -> str:
    with open(src, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _so_path(name: str) -> str:
    digest = _digest(os.path.join(SRC_DIR, f"{name}.cu"))
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def _nvcc_cmd(name: str, out: str):
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", out, os.path.join(SRC_DIR, f"{name}.cu")]


def build_all(names=None) -> Dict[str, str]:
    """Compile every named source not yet built, one nvcc each, all at once.
    Returns {name: nvcc's output} for the sources compiled now."""
    names = list(names or SIGNATURES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _so_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (out, tmp, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = {}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def build_host_library(src: str, build_dir: str = BUILD_DIR) -> str:
    """Compile the host C++ source `src` into build_dir (keyed by a hash of
    the source) unless it is built there, with native/build.sh's line:

        g++ -O3 -march=native -fPIC -shared -std=c++17 <src> -o <lib>

    Returns the library's path; raises with the compiler's output when the
    build fails."""
    stem = os.path.splitext(os.path.basename(src))[0]
    out = os.path.join(build_dir, f"lib{stem}-{_digest(src)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
           src, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded launcher library of one kernel, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _so_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def launcher(name: str):
    return getattr(library(name), SIGNATURES[name][0])
