"""Phase 30 of ``chip_smoke.py`` (data-parallel serving, bulk synthesis and
vocoder training) alone on the card.

Writes what the earlier phases leave for it, without their runs: phase 5's
seeded checkpoint and HiFiGAN V1, phase 15's synthesis filelist, phase 11's
corpus with a seeded ``step=12/`` in place of the trained one, and phase
21's vocoder corpus and config with the seeded HiFiGAN V1 in place of the
trained ``vocoder.npz``; then runs ``chip_smoke.phase_data_parallel``. It
needs a CUDA card; run it from the root of a checkout:

    python tools/phase30_alone.py

It prints the card, phase 30's log lines, the phase's result as JSON and the
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
    from fastspeech2_lightning_tpu_torch.checkpoint import write_checkpoint

    t0 = time.time()
    smi = smoke.phase_device()
    print(smi, flush=True)
    smoke.phase_build()
    with tempfile.TemporaryDirectory() as d:
        wd = Path(d)
        cfg = smoke.model_config("bfloat16")
        sd = smoke.random_state_dict(cfg, np.random.default_rng(smoke.SEED))
        write_checkpoint(wd / "model.ckpt", sd, cfg, smoke.STATS)
        smoke.random_hifigan_npz(wd / "hifigan_v1.npz", np.random.default_rng(smoke.SEED + 2))
        smoke.synthesis_filelist(wd / "synthesis_filelist.psv",
                                 np.random.default_rng(smoke.SEED + 11))
        smoke.write_corpus(wd / "corpus", cfg, np.random.default_rng(smoke.SEED + 7))
        step12 = wd / "logs" / "smoke" / "train" / "checkpoints" / f"step={smoke.RESUME_STEPS}"
        step12.mkdir(parents=True)
        write_checkpoint(step12 / "model.ckpt", sd, cfg, smoke.STATS, {"default": 0},
                         {"default": 0})  # the lookups the trainer writes for the corpus
        vcfg = json.loads(json.dumps(cfg))
        smoke.write_vocoder_corpus(wd / "vcorpus", vcfg, np.random.default_rng(smoke.SEED + 21))
        vcfg["preprocessing"]["save_dir"] = "vcorpus"
        vcfg["training"].update(training_filelist="vcorpus/training_filelist.psv",
                                validation_filelist="vcorpus/validation_filelist.psv")
        vcfg["training"]["logger"].update(save_dir="vlogs")
        (wd / "vocoder_config.json").write_text(json.dumps(vcfg))
        npz = wd / "vlogs" / "vocoder" / "checkpoints" / "vocoder.npz"
        npz.parent.mkdir(parents=True)
        smoke.random_hifigan_npz(npz, np.random.default_rng(smoke.SEED + 2))
        print(f"prerequisites written in {time.time() - t0:.1f} s", flush=True)
        out = smoke.phase_data_parallel(wd, smi)
        print(json.dumps(out), flush=True)
    print(f"phase 30 alone done in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
