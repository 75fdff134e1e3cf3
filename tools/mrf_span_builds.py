"""Time the MRF kernel's two input-tile builds against one build on the card.

``csrc/mrf_conv.cu`` keeps two builds of every (dtype, C): an input tile for
conv spans up to 50 (HiFiGAN V1 and V2) and one for spans up to 126. This
script compiles the source a second time with ``-DFS2_MRF_NARROW_SPAN=126``,
which leaves only the wide build, and times HiFiGAN V1's three fused stages
(``chip_smoke.phase_mrf``'s shapes: B 8, 256 mel frames; f32 and bf16) with
each library in turn, in the order split, one, one, split, as device ms
(``chip_smoke.device_ms``). It also reports the largest difference between
the two builds' outputs.

Run it from the root of a checkout:

    python tools/mrf_span_builds.py

It prints the card, one line per stage and dtype, and the result as JSON,
which it also writes to ``chiprun_out/mrf_span_builds.json``."""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402


def one_build_library(build, argtypes):
    """csrc/mrf_conv.cu compiled with the wide build only, loaded."""
    lib_path = build.BUILD_DIR / f"mrf_conv-one-span-{build.lib_path('mrf_conv').stem[9:]}.so"
    if not lib_path.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-DFS2_MRF_NARROW_SPAN=126",
                        "-o", str(lib_path), str(build.CSRC_DIR / "mrf_conv.cu")],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    lib.mrf_conv.argtypes = argtypes
    lib.mrf_conv.restype = ctypes.c_int
    return lib


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    t0 = time.time()
    smi = smoke.phase_device()
    print(smi, flush=True)

    import torch

    from fastspeech2_lightning_tpu_torch.kernels import build
    from fastspeech2_lightning_tpu_torch.ops import vocoder_resblocks as mrf

    split = build.load("mrf_conv", {"mrf_conv": mrf._ARGTYPES})
    one = one_build_library(build, mrf._ARGTYPES)
    libs = {"split": split, "one": one}
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 1)
    rows = []
    for C, rate in ((128, 64), (64, 128), (32, 256)):
        T = 256 * rate
        blocks = smoke._stage_blocks(C, g)
        x32 = torch.randn(8, T, C, device="cuda", generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            flat = mrf.prepare_stage_weights(blocks, smoke.KS, smoke.DILS, dtype)

            def stage():
                return mrf.fused_mrf_stage(x, flat, smoke.KS, smoke.DILS)

            outs, times = {}, {"split": [], "one": []}
            for name in ("split", "one", "one", "split"):
                build._libs["mrf_conv"] = libs[name]
                outs[name] = stage()
                times[name].append(smoke.device_ms(stage, iters=10))
            build._libs["mrf_conv"] = split
            diff = float((outs["one"].float() - outs["split"].float()).abs().max())
            row = dict(shape=[8, T, C], dtype=str(dtype).split(".")[-1],
                       split_device_ms=times["split"], one_device_ms=times["one"],
                       max_abs_diff=diff)
            print(f"V1 stage {row['shape']} {row['dtype']}: split builds {times['split']} ms, "
                  f"span-126 build only {times['one']} ms; outputs differ by {diff:.3e}",
                  flush=True)
            rows.append(row)
            del x, outs
        del x32
        torch.cuda.empty_cache()
    result = dict(card=smi, stages=rows, seconds=time.time() - t0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "mrf_span_builds.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
