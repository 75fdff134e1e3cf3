"""Where a teacher-forced forward at batch 1 spends its time on the card:
the forward ``check-data --model-path`` runs for every utterance.

The default model at full width and depth (bf16) with the seeded random
weights of ``chip_smoke.py``, on one utterance of L text positions and T
mel frames: the teacher-forced forward with its loss, and for comparison the
free-running forward at the same shape. For each: the median wall of a call
with the card synchronized after it, the median time the host takes to
queue a call, and from a profiler trace the card's busy time and span a
call; then the profiler's table of host ops by their own time, and the
device events a call.

    python tools/teacher_forced_profile.py [L T]
"""
import statistics
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(L: int = 48, T: int = 320) -> None:
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from fastspeech2_lightning_tpu_torch.checkpoint import (
        load_model_from_checkpoint, write_checkpoint,
    )
    from fastspeech2_lightning_tpu_torch.training.loss import compute_loss
    from fastspeech2_lightning_tpu_torch.training.step import batch_to_device

    print(c.phase_device(), flush=True)
    c.phase_build()
    cfg = c.model_config("bfloat16")
    with tempfile.TemporaryDirectory() as wd:
        ckpt = write_checkpoint(Path(wd) / "m.ckpt",
                                c.random_state_dict(cfg, np.random.default_rng(c.SEED)), cfg,
                                c.STATS, lang2id={"default": 0}, speaker2id={"default": 0})
        model, config, *_ = load_model_from_checkpoint(ckpt)
    rng = np.random.default_rng(c.SEED + 1)
    L_pad = -(-L // 16) * 16
    batch = {"text": rng.integers(1, 27, (1, L_pad)).astype(np.int32),
             "src_lens": np.array([L], np.int32),
             "mel": rng.standard_normal((1, T, 80)).astype(np.float32) - 4.0,
             "mel_lens": np.array([T], np.int32),
             "attn_prior": np.full((1, T, L_pad), 1.0 / L, np.float32),
             "speaker_id": np.zeros(1, np.int32), "language_id": np.zeros(1, np.int32)}
    db = batch_to_device(batch, "cuda")
    ctrl = {"pitch": 1.0, "energy": 1.0, "duration": 1.0}

    def teacher_forced():
        out = model.forward_teacher_forced(db, ctrl)
        with torch.no_grad():
            compute_loss(config, out, db, 0)

    def free_running():
        model(db["text"], db["src_lens"], T, control=ctrl, speaker_id=db["speaker_id"],
              language_id=db["language_id"])

    for name, fn in (("teacher-forced forward + loss", teacher_forced),
                     ("free-running forward", free_running)):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        walls, queued = [], []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            queued.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        busy = c.device_busy_ms(fn, iters=5)
        print(f"{name} at (1, L {L}, T {T}): wall {statistics.median(walls):.2f} ms, the host "
              f"queues it in {statistics.median(queued):.2f} ms; card {busy}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            teacher_forced()
        torch.cuda.synchronize()
    table = prof.key_averages()
    print(table.table(sort_by="self_cpu_time_total", row_limit=25))
    events = sum(e.count for e in table if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"device events a teacher-forced forward + loss: {events / 3:.0f}")
    print(c.phase_device())


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))
