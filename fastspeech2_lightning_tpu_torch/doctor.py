"""``doctor``: environment and installation diagnostics (counterpart of the
JAX package's ``cli/doctor.py``).

The same rows (``OK``/``WARN``/``FAIL``, the icons and the summary line),
exit code 1 on any FAIL:

- ``versions``: the port, torch, numpy and scipy;
- ``nvcc`` and one row a ``csrc/`` source: nvcc is found, and every source
  builds for sm_90a (all started together, ``kernels.build.build_each``)
  and its library loads;
- ``build-cache``: ``_build/`` is writable, with its count of libraries;
- ``devices``: CUDA initialized in a subprocess with a timeout, so a hung
  initialization is reported instead of hanging the command: the card's name and
  count, compute capability, the torch and CUDA versions and the power
  limit as ``nvidia-smi`` reads it. No CUDA device is a FAIL: the port runs
  on the card;
- with a config file, the JAX package's config rows: the config parses, the
  text inventory, the preprocessed artifacts, ``stats.json`` and both
  filelists.

A check that raises becomes a FAIL row; the command never crashes."""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, List, Optional, Tuple

OK = "ok"
WARN = "warn"
FAIL = "fail"
Row = Tuple[str, str, str]

_DEVICE_PROBE = r"""
import json
import subprocess
import torch
if not torch.cuda.is_available():
    raise SystemExit("no CUDA device is available (torch.cuda.is_available() is false)")
torch.zeros(1, device="cuda")  # initializes the context
props = torch.cuda.get_device_properties(0)
try:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
except (OSError, subprocess.SubprocessError) as exc:
    smi = [f"nvidia-smi: {exc}"]
print(json.dumps({
    "name": torch.cuda.get_device_name(0),
    "count": torch.cuda.device_count(),
    "capability": [props.major, props.minor],
    "torch": torch.__version__,
    "cuda": torch.version.cuda,
    "smi": smi[0] if smi else "nvidia-smi printed nothing",
}))
"""


def probe_devices(timeout_s: float = 60.0) -> Row:
    """The ``devices`` row; CUDA is initialized in a subprocess so a hung
    initialization times out cleanly."""
    try:
        proc = subprocess.run([sys.executable, "-c", _DEVICE_PROBE], capture_output=True,
                              text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return "devices", FAIL, (f"CUDA init hung >{timeout_s:.0f}s — the CUDA stack or "
                                 "the card is not answering")
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout).strip().splitlines()[-1:]
        return "devices", FAIL, f"CUDA init failed: {' '.join(tail)}"
    try:
        info = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return "devices", WARN, f"unparseable probe output: {proc.stdout[:200]!r}"
    major, minor = info["capability"]
    msg = (f"{info['name']} x{info['count']} (sm_{major}{minor}) torch={info['torch']} "
           f"cuda={info['cuda']}; nvidia-smi: {info['smi']}")
    if (major, minor) != (9, 0):
        return "devices", FAIL, f"{msg} — the kernels are built for sm_90a (Hopper)"
    return "devices", OK, msg


def check_versions() -> Row:
    import numpy
    import scipy
    import torch

    from . import __version__ as pkg

    mods = {"fastspeech2_lightning_tpu_torch": pkg, "torch": torch.__version__,
            "numpy": numpy.__version__, "scipy": scipy.__version__}
    return "versions", OK, " ".join(f"{k}={v}" for k, v in mods.items())


def check_kernels() -> List[Row]:
    """``nvcc`` and one row a source: built for sm_90a and loaded."""
    from .kernels import build

    names = build.all_sources()
    try:
        nvcc = build.find_nvcc()
    except RuntimeError as exc:
        return [("nvcc", FAIL, str(exc))] + [
            (f"{n}.cu", FAIL, "not built: no nvcc") for n in names]
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    rows = [("nvcc", OK, f"{nvcc} ({version[-1] if version else 'version unknown'})")]
    for name, out in build.build_each(names).items():
        if isinstance(out, RuntimeError):
            rows.append((f"{name}.cu", FAIL, str(out).splitlines()[0]))
            continue
        lib = build.lib_path(name)
        try:
            ctypes.CDLL(str(lib)).error_string  # every library exports it
        except (OSError, AttributeError) as exc:
            rows.append((f"{name}.cu", FAIL, f"built but does not load: {exc}"))
            continue
        rows.append((f"{name}.cu", OK, f"built for sm_90a and loaded ({lib.name})"))
    return rows


def check_build_cache() -> Row:
    from .kernels import build

    path = build.BUILD_DIR
    try:
        path.mkdir(parents=True, exist_ok=True)
        probe = path / ".doctor_probe"
        probe.write_text("ok")
        probe.unlink()
    except OSError as exc:
        return "build-cache", FAIL, f"{path} not writable: {exc}"
    n = len(list(path.glob("*.so")))
    return "build-cache", OK, f"{path} (writable, {n} built libraries)"


def check_config(config_file: Path) -> List[Row]:
    """Config-specific checks: parse, artifact dirs, stats, filelists (the
    JAX package's rows and messages)."""
    rows: List[Row] = []
    try:
        from .config import FastSpeech2Config

        config = FastSpeech2Config.from_file(config_file)
        rows.append(("config", OK, f"parsed {config_file}"))
    except Exception as exc:
        rows.append(("config", FAIL, f"{type(exc).__name__}: {exc}"))
        return rows
    try:
        from .text import TextProcessor

        tp = TextProcessor(config.text)
        rows.append(("text", OK, f"{len(tp.symbols)} symbols in inventory"))
    except Exception as exc:
        rows.append(("text", FAIL, f"text config: {exc}"))
    save_dir = Path(config.preprocessing.save_dir)
    if not save_dir.exists():
        rows.append(("artifacts", WARN, f"{save_dir} missing — run `fs2t preprocess` first"))
    else:
        missing = [d for d in ("audio", "spec", "text") if not (save_dir / d).is_dir()]
        stats = save_dir / "stats.json"
        if missing:
            rows.append(("artifacts", WARN,
                         f"{save_dir} lacks {missing} — preprocessing incomplete"))
        else:
            rows.append(("artifacts", OK, f"{save_dir} populated"))
        rows.append(("stats", OK, f"{stats} present") if stats.exists()
                    else ("stats", WARN, f"{stats} missing — run preprocess with stats enabled"))
    for name in ("training_filelist", "validation_filelist"):
        p = Path(getattr(config.training, name))
        rows.append((name, OK, str(p)) if p.exists() else (name, WARN, f"{p} does not exist"))
    return rows


def _rows_of(name: str, fn: Callable) -> List[Row]:
    """fn()'s rows (one or a list); a check that raises is one FAIL row."""
    try:
        out = fn()
    except Exception as exc:  # a diagnostic must never crash
        return [(name, FAIL, f"{type(exc).__name__}: {exc}")]
    return out if isinstance(out, list) else [out]


def run_doctor(config_file: Optional[Path] = None, device_timeout_s: float = 60.0,
               echo=print) -> int:
    """Run all checks; returns a shell exit code (1 if any FAIL)."""
    rows: List[Row] = []
    checks = [("versions", check_versions), ("kernels", check_kernels),
              ("build-cache", check_build_cache),
              ("devices", lambda: probe_devices(device_timeout_s))]
    if config_file is not None:
        checks.append(("config", lambda: check_config(Path(config_file))))
    for name, fn in checks:
        rows.extend(_rows_of(name, fn))
    icon = {OK: "✓", WARN: "!", FAIL: "✗"}
    for name, status, msg in rows:
        echo(f"{icon[status]} {name:14s} {msg}")
    n_fail = sum(1 for _, s, _ in rows if s == FAIL)
    n_warn = sum(1 for _, s, _ in rows if s == WARN)
    echo(f"{len(rows)} checks: {n_fail} failed, {n_warn} warnings")
    return 1 if n_fail else 0
