"""Where the time of ``chip_smoke.py``'s phase 27 (``export-serving`` and
``.fs2x``) goes, on the card.

Builds phase 27's inputs as ``tools/phase27_alone.py`` does (a 4-step run
of phase 11's configuration and phase 5's seeded HiFiGAN V1), then runs
``chip_smoke.phase_export_serving`` with its pieces timed: each program's
``torch.export.export`` and ``torch.export.save`` inside ``export-serving``,
each program's ``torch.export.load`` and the calls of every program (the
warmups and the checks), and the phase's wall. Run it from the root of a
checkout:

    python tools/export_timing.py

It prints the card, one JSON line per timed piece (``EXPORT_TIMING``) and a
summary: seconds in export, save, load and program runs by program, and the
phase's total."""

import collections
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def main() -> None:
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.synthesis import exported

    smi = smoke.phase_device()
    print(smi, flush=True)
    smoke.phase_build()
    pieces = []

    def note(kind, name, seconds):  # printed at the end: the phase checks what the CLI prints
        pieces.append(dict(kind=kind, name=name, seconds=seconds))

    real_export, real_save, real_load = torch.export.export, torch.export.save, torch.export.load

    def timed(kind, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            note(kind, type(args[0]).__name__ if kind == "export" else "", time.perf_counter() - t0)
            return out
        return wrapper

    real_run = exported.ExportedSynthesizer._run

    def run(self, entry, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_run(self, entry, *args)
        torch.cuda.synchronize()
        note("run", entry["files"][self.platform], time.perf_counter() - t0)
        return out

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
        cli.main(["train", str(wd / "config.json"), "--max-steps", "4"])
        smoke.random_hifigan_npz(wd / "hifigan_v1.npz", np.random.default_rng(smoke.SEED + 2))
        torch.export.export = timed("export", real_export)
        torch.export.save = timed("save", real_save)
        torch.export.load = timed("load", real_load)
        exported.ExportedSynthesizer._run = run
        t0 = time.time()
        try:
            smoke.phase_export_serving(wd, smi)
        finally:
            torch.export.export, torch.export.save = real_export, real_save
            torch.export.load = real_load
            exported.ExportedSynthesizer._run = real_run
        total = time.time() - t0
    for p in pieces:
        print("EXPORT_TIMING " + json.dumps(p), flush=True)
    by = collections.defaultdict(float)
    runs = collections.Counter()
    for p in pieces:
        by[p["kind"]] += p["seconds"]
        if p["kind"] == "run":
            runs[p["name"]] += 1
    print("EXPORT_SUMMARY " + json.dumps(dict(
        card=smi, phase_s=total, seconds_by_kind=by, calls_by_program=runs,
        exports=[p["seconds"] for p in pieces if p["kind"] == "export"])), flush=True)


if __name__ == "__main__":
    main()
