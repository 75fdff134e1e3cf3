"""Kernel A at dh 192 and 256 with and without its warpgroups taking turns.

``attention_fwd_tc_pair`` (``csrc/attention_fwd.cu``) orders its two
warpgroups' products with named barriers 1 and 2, so that one warpgroup's
softmax and dropout hash run while the other's products do. This script
compiles the source a second time with ``-DFS2T_PAIR_TURNS=0``, which takes
those turn barriers out and changes nothing else, and times
``attention_fwd`` with each library in turn (turns, free, free, turns) at
the bf16 shapes of ``tools/default_shapes_ab.py`` at dh 192 and 256, as
device ms (``chip_smoke.device_ms``). It checks that both builds give the
same output, bit for bit.

    python tools/fwd_pair_turns.py [--json PATH]
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

SHAPES = ((16, 2, 2048, 192, 0.2), (16, 2, 1024, 192, 0.2), (8, 2, 1024, 192, 0.0),
          (16, 2, 2048, 256, 0.2))


def free_library(build, entries):
    """csrc/attention_fwd.cu without the turn barriers, compiled and loaded."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "attention_fwd_no_turns.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-DFS2T_PAIR_TURNS=0", "-I",
                    str(build.CSRC_DIR), "-o", str(lib_path),
                    str(build.CSRC_DIR / "attention_fwd.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    for entry, argtypes in entries.items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", type=Path, help="also write the rows here")
    args = parser.parse_args()
    smi = smoke.phase_device()
    print(smi, flush=True)

    import torch

    from fastspeech2_lightning_tpu_torch.kernels import build
    from fastspeech2_lightning_tpu_torch.ops import attention

    libs = {"turns": build.load("attention_fwd", attention._FWD_ENTRIES),
            "free": free_library(build, attention._FWD_ENTRIES)}
    rows = []
    for B, H, T, dh, p in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(1000 + dh + T)
        bias, _ = smoke._ragged_bias(B, T, g)
        q, k, v = (torch.randn(B, H, T, dh, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(3))
        seed = torch.tensor([3217], dtype=torch.int32, device="cuda")

        def fwd():
            return attention.attention_fwd(q, k, v, bias, 1.0 / math.sqrt(dh), p=p, seed=seed,
                                           with_lse=p > 0)

        outs, times = {}, {"turns": [], "free": []}
        for name in ("turns", "free", "free", "turns"):
            build._libs["attention_fwd"] = libs[name]
            outs[name] = fwd()
            times[name].append(smoke.device_ms(fwd))
        build._libs["attention_fwd"] = libs["turns"]
        same = all(torch.equal(a, b) for a, b in zip(outs["turns"], outs["free"]))
        row = dict(shape=[B, H, T, dh], p=p, turns_ms=times["turns"], free_ms=times["free"],
                   free_over_turns=sum(times["free"]) / sum(times["turns"]), same_output=same)
        rows.append(row)
        print(f"{row['shape']} p {p}: turns {times['turns']}, free {times['free']}, "
              f"free / turns {row['free_over_turns']:.3f}, same output {same}", flush=True)
        if not same:
            sys.exit("the two builds differ")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(card=smi, rows=rows), indent=1))


if __name__ == "__main__":
    main()
