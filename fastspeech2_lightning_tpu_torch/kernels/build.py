"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled on first use for Hopper (``sm_90a``) into ``_build/`` beside this
package, named by a hash of the sources and flags so an edited source is
rebuilt and an unchanged one is reused. Pointers and the CUDA stream cross
as ``c_void_p``; every C entry returns ``cudaGetLastError()`` and
``check()`` raises when it is not 0.

Nothing here runs at import: the CPU tests import every module, and this
host has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Union

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    """csrc/<name>.cu's library for the current sources and flags."""
    return BUILD_DIR / f"{name}-{_source_hash(name)}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu; returns (process, tmp path, lib path),
    or None when the library is already built."""
    lib = lib_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib


def _finish(name: str, started) -> str:
    proc, tmp, lib = started
    out, _ = proc.communicate()
    log = lib.with_suffix(".log")
    log.write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, lib)
    return out


def build_each(names: Iterable[str]) -> Dict[str, Union[str, RuntimeError]]:
    """Compile the named sources, one nvcc each, all started together, and
    wait for every one. Returns name -> compiler output (ptxas register and
    shared-memory report; an already-built library reports its saved log),
    or the RuntimeError of a source nvcc failed on."""
    names = list(names)
    with _lock:
        started = {n: _start(n) for n in names}
        logs: Dict[str, Union[str, RuntimeError]] = {}
        for n in names:
            if started[n] is None:
                log = lib_path(n).with_suffix(".log")
                logs[n] = log.read_text() if log.exists() else ""
            else:
                try:
                    logs[n] = _finish(n, started[n])
                except RuntimeError as exc:  # reported once every nvcc has ended
                    logs[n] = exc
        return logs


def build(names: Iterable[str]) -> Dict[str, str]:
    """``build_each``, raising the first failure."""
    logs = build_each(names)
    for out in logs.values():
        if isinstance(out, RuntimeError):
            raise out
    return logs


def all_sources() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use, with the
    argument types of its C entries (`signatures`: entry -> argtypes; every
    entry returns an int error code) declared."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            for entry, argtypes in signatures.items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (launch refused, bad
    arguments, or an earlier asynchronous fault)."""
    if err != 0:
        msg = lib.error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
