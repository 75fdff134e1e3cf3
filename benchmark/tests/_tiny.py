"""Small sizes of the benchmark's cells for the CPU tests: every width cut
so a run holds in seconds on the CPU, the program at float32 (where it
agrees with the reference to round-off), and limits that round-off meets."""

from __future__ import annotations

import time

import torch

from benchmark.common import harness

TINY_LIMIT = 1e-3


def shrink_model(c: dict) -> None:
    for part in ("encoder", "decoder"):
        c["model"][part].update(input_dim=32, heads=2, feedforward_dim=64, layers=1)
    for v in c["model"]["variance_predictors"].values():
        v.update(input_dim=32, n_layers=2, n_bins=16)
    c["model"]["dtype"] = "float32"
    c["vocoder"].update(upsample_initial_channel=32, resblock_kernel_sizes=[3, 5],
                        resblock_dilation_sizes=[[1, 3], [1, 3]])
    c["discriminators"].update(periods=[2, 3], mpd_channels=[4, 8, 8, 8, 8],
                               msd_channels=[8, 8, 16, 16, 16, 16, 16],
                               msd_groups=[1, 4, 4, 4, 4, 4, 1], n_scales=2)


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    shrink_model(cell.config)
    p = cell.params
    if cell.traffic == "acoustic_train":
        p.update(utterances=16, chars=[10, 24], max_frames=120)
        p["training"] = dict(p["training"], batch_size=4)
    elif cell.traffic == "vocoder_train":
        p.update(utterances=6, seconds=[0.5, 1.0])
        p["training"] = dict(p["training"], batch_size=2, frames_per_crop=8)
    elif cell.traffic == "bulk_synth":
        p.update(batch=2, chars=[10, 30], pool_batches=4)
    else:
        p.update(rate=8.0, chars=[10, 60], median_chars=30, warmup_requests=4, max_batch=4)
    p["limits"] = {k: TINY_LIMIT for k in p["limits"]}
    return cell


def tiny_run(name: str, fault=None, seconds: float = 1.5, seed: int = 2 ** 33 + 5) -> dict:
    return harness.run_cell(tiny_cell(name), seed=seed, seconds=seconds, trace=False,
                            device=torch.device("cpu"), t_process=time.perf_counter(),
                            fault=fault)
