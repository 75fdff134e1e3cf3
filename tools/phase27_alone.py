"""Phase 27 of ``chip_smoke.py`` (``export-serving`` and ``.fs2x``) alone on
the card.

A 4-step run of phase 11's configuration (the default model in bf16, B 16)
on a synthetic corpus gives a step directory, and the seeded HiFiGAN V1 of
phase 5 is written beside it; then ``chip_smoke.phase_export_serving``
exports the serving artifact through the CLI, serves it and holds it to the
live path. It needs a CUDA card; run it from the root of a checkout:

    python tools/phase27_alone.py

It prints the card, phase 27's log lines, the phase's result as JSON and the
seconds the whole took."""

import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def main() -> None:
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
        from fastspeech2_lightning_tpu_torch import cli

        cli.main(["train", str(wd / "config.json"), "--max-steps", "4"])
        smoke.random_hifigan_npz(wd / "hifigan_v1.npz", np.random.default_rng(smoke.SEED + 2))
        out = smoke.phase_export_serving(wd, smi)
        print(json.dumps(out), flush=True)
    print(f"phase 27 alone done in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
