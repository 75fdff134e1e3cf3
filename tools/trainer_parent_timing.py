"""Time the port's training steps against commit 7cd25bd's trainer (before
validation, step checkpoints and the prefetcher), in turns on one card.

Both trees train the seeded corpus of `chip_smoke.py` phase 11 with its
config (the default model at full width and depth, bf16, batch 16) for
STEPS steps, each tree in processes of its own, in the order parent, this,
this, parent. Every process runs EMA off and then on (`ema_decay` 0.999);
this checkout runs each with `prefetch_batches` 0 and 2, with no save and no
validation among the steps (`ckpt_epochs` 0, `val_check_interval` past the
end). A step's wall is the time from one `train_step` call to the next
(the step, its logging and the wait for the next batch), over steps
3..STEPS; `ms` is the median of the step as `train_log.jsonl` times it.
Prints one JSON line a run and a summary line of medians by tree and
setting.

    git archive 7cd25bd | tar -x -C _archive/parent
    python tools/trainer_parent_timing.py _archive/parent
"""
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
STEPS = 16
EMA = 0.999


def child(tree: Path, workdir: Path, turn: int) -> None:
    """One process of one tree: every setting in turn, a JSON line each."""
    sys.path.insert(0, str(tree))
    import torch

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.kernels import build
    from fastspeech2_lightning_tpu_torch.training import loop

    assert Path(loop.__file__).resolve().is_relative_to(tree.resolve()), loop.__file__
    build.build(build.all_sources())
    parent = not hasattr(loop, "DevicePrefetcher")
    starts = []
    step = loop.train_step

    def timed_step(*args, **kwargs):
        starts.append(time.perf_counter())
        return step(*args, **kwargs)

    loop.train_step = timed_step
    cfg = json.loads((workdir / "config.json").read_text())
    for ema in (0.0, EMA):
        for prefetch in ((None,) if parent else (0, 2)):
            name = f"{'parent' if parent else 'this'}_{turn}_ema{ema}_prefetch{prefetch}"
            c = json.loads(json.dumps(cfg))
            c["training"].update(ema_decay=ema, prefetch_batches=prefetch, ckpt_epochs=0,
                                 ckpt_steps=None, async_checkpoint=False,
                                 val_check_interval=10**6)
            c["training"]["logger"]["version"] = name
            path = workdir / f"config_{name}.json"
            path.write_text(json.dumps(c))
            trainer = loop.Trainer(FastSpeech2Config.from_file(path))
            starts.clear()
            rows = trainer.fit(max_steps=STEPS)
            torch.cuda.synchronize()
            walls = [(b - a) * 1e3 for a, b in zip(starts[2:], starts[3:])]
            print(json.dumps({
                "tree": "parent" if parent else "this", "turn": turn, "ema_decay": ema,
                "prefetch_batches": prefetch, "step_wall_ms": statistics.median(walls),
                "ms": statistics.median(r["ms"] for r in rows[2:]), "walls": walls,
                "shapes": [r["shape"] for r in rows],
            }), flush=True)
            del trainer


def main(parent: Path) -> None:
    sys.path.insert(0, str(HERE))
    import numpy as np

    import chip_smoke as c

    results = []
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        cfg = c.model_config("bfloat16")
        c.write_corpus(workdir / "corpus", cfg, np.random.default_rng(c.SEED + 7))
        cfg["preprocessing"]["save_dir"] = "corpus"
        cfg["training"].update(batch_size=16, training_filelist="corpus/training_filelist.psv",
                               validation_filelist="corpus/validation_filelist.psv")
        cfg["training"]["logger"].update(save_dir="logs", name="timing")
        (workdir / "config.json").write_text(json.dumps(cfg))
        for turn, tree in enumerate((parent, HERE, HERE, parent)):
            out = subprocess.run([sys.executable, __file__, "--child", str(tree), str(workdir),
                                  str(turn)], capture_output=True, text=True, timeout=900)
            c.check(out.returncode == 0, f"{tree} (turn {turn}) exited {out.returncode}: "
                    f"{out.stderr[-3000:]}")
            for line in out.stdout.splitlines():
                if line.startswith('{"tree"'):
                    row = json.loads(line)
                    print(json.dumps({k: v for k, v in row.items() if k != "shapes"}),
                          flush=True)
                    results.append(row)
    shapes = {json.dumps(r["shapes"]) for r in results}
    c.check(len(shapes) == 1, "the runs trained different batch shapes")
    summary = {}
    for r in results:
        key = f"{r['tree']} ema {r['ema_decay']} prefetch {r['prefetch_batches']}"
        summary.setdefault(key, []).append(r["walls"])
    print(json.dumps({"step_wall_ms_median": {k: statistics.median(w for ws in v for w in ws)
                                              for k, v in summary.items()},
                      "runs": {k: [statistics.median(ws) for ws in v]
                               for k, v in summary.items()}}))


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        child(Path(sys.argv[2]), Path(sys.argv[3]), int(sys.argv[4]))
    else:
        main(Path(sys.argv[1]).resolve())
