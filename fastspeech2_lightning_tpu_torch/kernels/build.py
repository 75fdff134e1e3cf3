"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled on first use for Hopper (``sm_90a``) into ``_build/`` beside this
package, named by a hash of the sources and flags so an edited source is
rebuilt and an unchanged one is reused. A source may also be built with
-D macros of its own (``load(..., defines=...)``), into a library beside
the default one, and put under the wrappers for a while (``using``): the
tools that time a kernel against variants of itself do so. Pointers and the CUDA stream cross
as ``c_void_p``; every C entry returns ``cudaGetLastError()`` and
``check()`` raises when it is not 0.

A C entry launches on the calling thread's current CUDA device, so
``launch`` makes the tensors' device current for the call where another
one is (a process may drive several cards, one thread each); ``count``
adds to a wrapper's launch counter under a lock, as those threads launch
at once. A capture launches nothing: inside ``recording()`` the counts go
into the recorder's dict instead, and whoever replays the captured graph
adds them back (``add``) at every replay.

Nothing here runs at import: the CPU tests import every module, and this
host has no nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator, Sequence, Tuple, Union

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[Union[str, Tuple[str, ...]], ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_hash(name: str, defines: Sequence[str] = ()) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str, defines: Sequence[str] = ()) -> Path:
    """csrc/<name>.cu's library for the current sources and flags, and the
    -D macros `defines` (``"-DNAME=VALUE"``) where given."""
    return BUILD_DIR / f"{name}-{_source_hash(name, defines)}.so"


def _start(name: str, defines: Sequence[str] = ()):
    """Start nvcc for csrc/<name>.cu; returns (process, tmp path, lib path),
    or None when the library is already built."""
    lib = lib_path(name, defines)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
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
    return _build_all([(n, ()) for n in names], key=lambda n, d: n)


def _build_all(builds, key) -> dict:
    with _lock:
        started = [(n, d, _start(n, d)) for n, d in builds]
        logs: dict = {}
        for n, d, s in started:
            if s is None:
                log = lib_path(n, d).with_suffix(".log")
                logs[key(n, d)] = log.read_text() if log.exists() else ""
            else:
                try:
                    logs[key(n, d)] = _finish(n, s)
                except RuntimeError as exc:  # reported once every nvcc has ended
                    logs[key(n, d)] = exc
        return logs


def build_variants(builds: Iterable[Tuple[str, Sequence[str]]]) -> None:
    """Compile each (source name, -D macros) pair given, one nvcc each, all
    started together; raises the first failure."""
    logs = _build_all([(n, tuple(d)) for n, d in builds], key=lambda n, d: (n, *d))
    for out in logs.values():
        if isinstance(out, RuntimeError):
            raise out


def build(names: Iterable[str]) -> Dict[str, str]:
    """``build_each``, raising the first failure."""
    logs = build_each(names)
    for out in logs.values():
        if isinstance(out, RuntimeError):
            raise out
    return logs


def all_sources() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def load(name: str, signatures: Dict[str, list], defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use, with the
    argument types of its C entries (`signatures`: entry -> argtypes; every
    entry returns an int error code) declared. With `defines` (-D macros),
    the source built with them: a library of its own, which the wrappers
    call only inside ``using``."""
    key = (name, *defines) if defines else name
    lib = _libs.get(key)
    if lib is not None:
        return lib
    build_variants([(name, defines)])
    with _lock:
        if key not in _libs:
            lib = ctypes.CDLL(str(lib_path(name, defines)))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            for entry, argtypes in signatures.items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[key] = lib
        return _libs[key]


@contextlib.contextmanager
def using(name: str, lib: ctypes.CDLL) -> Iterator[None]:
    """Within: the wrappers of csrc/<name>.cu call `lib` (a build of it with
    other macros, from ``load``); after, the library they called before."""
    with _lock:
        before = _libs.get(name)
        _libs[name] = lib
    try:
        yield
    finally:
        with _lock:
            if before is None:
                _libs.pop(name, None)
            else:
                _libs[name] = before


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (launch refused, bad
    arguments, or an earlier asynchronous fault)."""
    if err != 0:
        msg = lib.error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def launch(device, entry, *args) -> int:
    """``entry(*args)`` (a C entry of a loaded library) with `device` the
    current CUDA device: ``torch.cuda.device`` is entered only where another
    device is current, so the common path costs one integer compare."""
    import torch

    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return entry(*args)
    return entry(*args)


_recorder: list = []  # the dict counts go into while a graph is captured


def count(wrapper, **extra) -> None:
    """One launch more on `wrapper.launches` (and each of `extra` added to
    the attribute it names), under a lock: replicas on several threads
    launch the same kernel at once. Inside ``recording()`` the counts go
    to the recorder (from every thread: a captured backward runs on the
    autograd engine's)."""
    with _count_lock:
        if _recorder:
            sink = _recorder[-1]
            for name, n in (("launches", 1), *extra.items()):
                sink[(wrapper, name)] = sink.get((wrapper, name), 0) + n
            return
        wrapper.launches += 1
        for name, n in extra.items():
            setattr(wrapper, name, getattr(wrapper, name) + n)


@contextlib.contextmanager
def recording() -> Iterator[dict]:
    """Within: ``count`` records into the dict yielded, {(wrapper,
    attribute): n}, and leaves the wrappers as they are (a capture launches
    nothing)."""
    sink: dict = {}
    with _count_lock:
        _recorder.append(sink)
    try:
        yield sink
    finally:
        with _count_lock:
            _recorder[:] = [r for r in _recorder if r is not sink]


def add(counts: dict) -> None:
    """Add a recording's counts to the wrappers (a replay launched them)."""
    with _count_lock:
        for (wrapper, name), n in counts.items():
            setattr(wrapper, name, getattr(wrapper, name) + n)
