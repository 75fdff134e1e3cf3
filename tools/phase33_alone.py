"""Phase 33 of ``chip_smoke.py`` (head dims above 256 and texts of 1024
symbols or more) alone on the card.

Phase 11's configuration (the default model in bf16, B 16) and synthetic
corpus are written as phase 11 writes them, for the one-head training part;
then the kernels are built and ``chip_smoke.phase_long_shapes`` runs:
kernels A and A' at dh 257 to 768 and timed at dh 384 and 512, B at L 1025
to 8191 and C at S 2049 to 16383 against their plain versions and timed at
(16, 2048, 2000), the d-384 model at one head served over HTTP and trained
2 steps, and the default model trained 2 steps and validated at
``max_length`` 2048 and at 9000; B at L 8193 to 16385 and C at S 16385 and
24001 (in panels) held and timed alone, and A and A' with dropout at T
65600.

Run it from the root of a checkout:

    python tools/phase33_alone.py

It prints the card, the log lines, the result as JSON and the seconds the
whole took."""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    t0 = time.time()
    smi = smoke.phase_device()
    print(smi, flush=True)
    smoke.phase_build()
    with tempfile.TemporaryDirectory() as d:
        wd = Path(d)
        cfg = smoke.model_config("bfloat16")
        smoke.write_corpus(wd / "corpus", cfg, np.random.default_rng(smoke.SEED + 7))
        cfg["preprocessing"]["save_dir"] = "corpus"
        cfg["training"].update(batch_size=16, training_filelist="corpus/training_filelist.psv",
                               validation_filelist="corpus/validation_filelist.psv",
                               val_check_interval=4, save_top_k_ckpts=1, ema_decay=0.999,
                               async_checkpoint=True)
        cfg["training"]["logger"].update(save_dir="logs", name="smoke", version="train")
        (wd / "config.json").write_text(json.dumps(cfg))
        out = smoke.phase_long_shapes(wd, smi)
        print(json.dumps(out), flush=True)
    print(f"phase 33 alone done in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
