"""Time the whole-stage MRF kernel's row tiling against other choices on the card.

``csrc/mrf_stage.cu`` gives each of a block's 8 warps G groups of 16 rows
(one in the 64-row halo on each side of the block's output rows), so a
block computes 128 G rows for 128 (G - 1) outputs: a larger G wastes less
on the halo and holds more registers. This script compiles the source again
for other G (``-DFS2_MRF_STAGE_G16``, ``-DFS2_MRF_STAGE_G8``), and times
HiFiGAN V2's two narrow stages (``chip_smoke.py`` phase 32's shapes: B 8,
896 mel frames; C 16 at [8, 114688, 16] and C 8 at [8, 229376, 8]; f32 and
bf16) with the built tiling and with each other one in turn (built, other,
other, built), as device ms (``chip_smoke.device_ms``). It reports each
build's registers and spills (ptxas) and the largest difference between
the outputs.

Run it from the root of a checkout:

    python tools/mrf_stage_tiles.py --variants 2,3 4,6

It prints the card, one line per stage, dtype and tiling, and the result as
JSON."""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402


def build_variants(build, variants):
    """csrc/mrf_stage.cu compiled once for each (G16, G8), all nvcc at once:
    {(G16, G8): (library path, ptxas register lines)}."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = build.lib_path("mrf_stage").stem
    started = {}
    for g16, g8 in variants:
        path = build.BUILD_DIR / f"{stem}-g{g16}-{g8}.so"
        started[(g16, g8)] = path, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, f"-DFS2_MRF_STAGE_G16={g16}",
             f"-DFS2_MRF_STAGE_G8={g8}", "-o", str(path), str(build.CSRC_DIR / "mrf_stage.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for key, (path, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for G {key}:\n{log}")
        out[key] = path, [line.strip() for line in log.splitlines()
                          if re.search(r"Used \d+ registers|spill", line)]
    return out


def load(path, argtypes):
    lib = ctypes.CDLL(str(path))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    lib.mrf_stage.argtypes = argtypes
    lib.mrf_stage.restype = ctypes.c_int
    return lib


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", nargs="+", default=["2,3", "4,6"],
                        help="G16,G8 pairs to time against the built tiling")
    args = parser.parse_args()
    variants = [tuple(int(v) for v in pair.split(",")) for pair in args.variants]
    t0 = time.time()
    smi = smoke.phase_device()
    print(smi, flush=True)

    import torch

    from fastspeech2_lightning_tpu_torch.kernels import build
    from fastspeech2_lightning_tpu_torch.ops import vocoder_resblocks as mrf

    built = build.load("mrf_stage", {"mrf_stage": mrf._STAGE_ARGTYPES})
    others = build_variants(build, variants)
    libs = {"built": built, **{f"g{a}-{b}": load(p, mrf._STAGE_ARGTYPES)
                               for (a, b), (p, _) in others.items()}}
    for (a, b), (_, regs) in others.items():
        print(f"G16 {a}, G8 {b}: {regs}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 33)
    rows = []
    for C, rate in ((16, 128), (8, 256)):
        T = smoke.V2_FRAMES * rate
        blocks = smoke._stage_blocks(C, g)
        x32 = torch.randn(smoke.V2_BATCH, T, C, device="cuda", generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            flat = mrf.prepare_stage_weights(blocks, smoke.KS, smoke.DILS, dtype)

            def stage():
                return mrf.fused_mrf_stage(x, flat, smoke.KS, smoke.DILS)

            row = dict(shape=[smoke.V2_BATCH, T, C], dtype=str(dtype).split(".")[-1])
            base = stage()
            for name in libs:
                if name == "built":
                    continue
                times = {"built": [], name: []}
                for turn in ("built", name, name, "built"):
                    build._libs["mrf_stage"] = libs[turn]
                    times[turn].append(smoke.device_ms(stage, iters=10))
                build._libs["mrf_stage"] = libs[name]
                diff = float((stage().float() - base.float()).abs().max())
                build._libs["mrf_stage"] = built
                row[name] = dict(device_ms=times[name], built_device_ms=times["built"],
                                 max_abs_diff=diff)
                print(f"[{smoke.V2_BATCH}, {T}, {C}] {row['dtype']}: built {times['built']} ms, "
                      f"{name} {times[name]} ms; outputs differ by {diff:.3e}", flush=True)
            rows.append(row)
            del x, base
        del x32
        torch.cuda.empty_cache()
    result = dict(card=smi, variants={f"g{a}-{b}": regs for (a, b), (_, regs) in others.items()},
                  stages=rows, seconds=time.time() - t0)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
