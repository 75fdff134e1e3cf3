"""Phase 29 of ``chip_smoke.py`` (data- and tensor-parallel training) alone
on the card.

Phase 11's configuration (the default model in bf16, B 16) and synthetic
corpus are written as phase 11 writes them, and 8 steps are trained through
the ``train`` CLI as phase 11 trains them (its step=8/, losses and step
times are the one-process reference). Then ``chip_smoke.phase_distributed``
runs torchrun at world 1 over NCCL, the two-rank gloo runs on the one card
and the offset kernel checks.

Run it from the root of a checkout:

    python tools/phase29_alone.py

It prints the card, the log lines, the result as JSON and the seconds the
whole took."""

import argparse
import json
import shutil
import statistics
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
    from fastspeech2_lightning_tpu_torch import cli

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
        cli.main(["train", str(wd / "config.json"), "--max-steps", str(smoke.TRAIN_STEPS)])
        run = wd / "logs" / "smoke" / "train"
        shutil.copytree(run / "checkpoints" / f"step={smoke.TRAIN_STEPS}",
                        wd / smoke.PHASE11_STEP8)
        rows = smoke._rows(run / "train_log.jsonl")
        phase11 = {"totals": [r["total"] for r in rows],
                   "ms": statistics.median(r["ms"] for r in rows[2:])}
        out = smoke.phase_distributed(wd, phase11, smi)
        print(json.dumps(out), flush=True)
    print(f"phase 29 alone done in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
