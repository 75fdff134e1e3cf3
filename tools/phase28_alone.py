"""Phase 28 of ``chip_smoke.py`` (YAML configs and TensorBoard media) alone
on the card.

Phase 11's configuration (the default model in bf16, B 16) and synthetic
corpus are written as phase 11 writes them, with the seeded HiFiGAN V1 of
phase 5 where phase 21 leaves its trained ``vocoder.npz``; then
``chip_smoke.phase_yaml_media`` writes the config as YAML, trains 2 steps
from it through the CLI and reads the event file back. It needs a CUDA
card; run it from the root of a checkout:

    python tools/phase28_alone.py

It prints the card, phase 28's log lines, the phase's result as JSON and the
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
        npz = wd / "vlogs" / "vocoder" / "checkpoints" / "vocoder.npz"
        npz.parent.mkdir(parents=True)
        smoke.random_hifigan_npz(npz, np.random.default_rng(smoke.SEED + 2))
        out = smoke.phase_yaml_media(wd, npz, smi)
        print(json.dumps(out), flush=True)
    print(f"phase 28 alone done in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
