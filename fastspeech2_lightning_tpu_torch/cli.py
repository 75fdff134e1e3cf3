"""Command line of the PyTorch port (argparse; the JAX package's click CLI is
not a dependency here).

    python -m fastspeech2_lightning_tpu_torch serve MODEL.ckpt -v VOCODER.npz --port 8777
    python -m fastspeech2_lightning_tpu_torch train CONFIG.yaml --max-steps 1000
    python -m fastspeech2_lightning_tpu_torch serve LOGS/.../checkpoints/step=1000 --use-ema
    python -m fastspeech2_lightning_tpu_torch synthesize MODEL.ckpt -t "hello" -O spec textgrid
    python -m fastspeech2_lightning_tpu_torch synthesize MODEL.ckpt -f LIST.psv -v griffin-lim
    python -m fastspeech2_lightning_tpu_torch synthesize GST.ckpt -t "hello" -S REF.wav -O spec
    python -m fastspeech2_lightning_tpu_torch serve GST.ckpt -v VOCODER.npz -S REF.wav
    python -m fastspeech2_lightning_tpu_torch train-vocoder CONFIG.json --max-steps 1000
    python -m fastspeech2_lightning_tpu_torch evaluate-vocoder CONFIG.json -v VOCODER.npz
    python -m fastspeech2_lightning_tpu_torch preprocess CONFIG.json --cpus 8
    python -m fastspeech2_lightning_tpu_torch preprocess CONFIG.json --on-device-spec
    python -m fastspeech2_lightning_tpu_torch check-data CONFIG.json --model-path STEP_DIR
    python -m fastspeech2_lightning_tpu_torch convert-artifacts PREPROCESSED_DIR
    python -m fastspeech2_lightning_tpu_torch benchmark CONFIG.json --benchmark-type inference
    python -m fastspeech2_lightning_tpu_torch average-checkpoints CKPT_DIR --last 3 -o AVG_DIR
    python -m fastspeech2_lightning_tpu_torch export-checkpoint STEP_DIR -o MODEL.ckpt
    python -m fastspeech2_lightning_tpu_torch export-serving MODEL.ckpt -o MODEL.fs2x -v VOCODER.npz
    python -m fastspeech2_lightning_tpu_torch serve MODEL.fs2x --warmup
    python -m fastspeech2_lightning_tpu_torch doctor CONFIG.json

Every command that reads a config takes a YAML file (a ``.json`` one is read as
JSON, as the JAX CLI does) and the JAX CLI's ``-c key.path=value`` overrides.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from .type_definitions import SynthesizeOutputFormats


STEPS = ("audio", "spec", "attn", "text", "pitch", "energy")


def _config_args(parser) -> None:
    parser.add_argument("--config-args", "-c", dest="config_args", action="append",
                        default=[], help="Dotted-path config overrides, e.g. "
                        "-c training.batch_size=8 (values read as YAML).")


def _must_exist(args, *named) -> None:
    """The JAX CLI's usage error (exit 2) for a path argument that does not
    exist."""
    for name, path in named:
        if path is not None and not Path(path).exists():
            args.command_parser.error(f"Invalid value for {name}: Path '{path}' does not exist.")


def _load_config(args):
    """The config file of `args` with its ``-c`` overrides."""
    from .config import load_config_base_command

    return load_config_base_command(args.config, args.config_args)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m fastspeech2_lightning_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser(
        "serve",
        help="Resident batch-streaming synthesis server (POST /synthesize, "
        "GET /health, GET /stats). MODEL_PATH is a Lightning .ckpt in the "
        "reference layout (`fs2t export-checkpoint` converts an orbax checkpoint), "
        "a step=N/ directory the train command wrote, or a .fs2x artifact that "
        "export-serving wrote.",
    )
    s.add_argument("model_path")
    s.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=False,
                   help="Serve the EMA weights of a step=N/ directory trained with "
                   "training.ema_decay.")
    s.add_argument("--vocoder-path", "-v", default=None)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8777)
    s.add_argument("--max-batch", type=int, default=8,
                   help="Chunks micro-batched into one device call.")
    s.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="How long to wait for more chunks before dispatching.")
    s.add_argument("--max-frames", type=int, default=None)
    s.add_argument("--vocoder-precision", choices=["float32", "bfloat16"],
                   default="float32")
    s.add_argument("--data-parallel", type=int, default=None,
                   help="Split each micro-batch's rows over N model replicas in this "
                   "process, one a card (cuda:0 .. cuda:N-1; N CPU replicas with --device "
                   "cpu); a long request alone is vocoded in windows across them.")
    s.add_argument("--warmup", action=argparse.BooleanOptionalAction, default=False,
                   help="Build the kernels before accepting requests.")
    s.add_argument("--style-reference", "-S", default=None,
                   help="GST style-reference wav applied to every request (the model must "
                   "be trained with the global-style-token module).")
    s.add_argument("--device", default=None,
                   help="'cuda' (default, the current card) or 'cpu'.")
    s.set_defaults(command_parser=s)
    t = sub.add_parser(
        "train",
        help="Train the acoustic model on a preprocessed corpus. CONFIG is a YAML or "
        "JSON config file (the JAX package's CLI reads the same file); the run writes "
        "TensorBoard event files with validation media, train_log.jsonl, "
        "val_log.jsonl and checkpoints/step=N/ under the logger's directory. "
        "SIGTERM checkpoints the step in flight and exits 0.",
    )
    t.add_argument("config")
    t.add_argument("--max-steps", type=int, default=None,
                   help="Stop after this many steps (default: training.max_steps).")
    t.add_argument("--resume", action=argparse.BooleanOptionalAction, default=True,
                   help="Resume from the newest step=N/ checkpoint of the run's "
                   "directory (default); --no-resume starts fresh.")
    t.add_argument("--model-parallel", type=int, default=1,
                   help="Tensor-parallel axis size (ranks per model shard; needs "
                   "--distributed and a world divisible by it).")
    t.add_argument("--distributed", action=argparse.BooleanOptionalAction, default=False,
                   help="Join the process group of a torchrun launch (or of the "
                   "FS2T_COORDINATOR_ADDRESS, FS2T_NUM_PROCESSES and FS2T_PROCESS_ID "
                   "variables): one device per process, NCCL on the cards, gloo with "
                   "--device cpu.")
    t.add_argument("--device", default=None,
                   help="'cuda' (default, the current card; cuda:LOCAL_RANK with "
                   "--distributed) or 'cpu'.")
    _config_args(t)
    t.set_defaults(command_parser=t)
    y = sub.add_parser(
        "synthesize",
        help="Synthesize audio, specs and alignments from texts or a filelist. Writes "
        "under OUTPUT_DIR: wav/, synthesized_spec/, textgrids/ and readalongs/.",
    )
    y.add_argument("model_path", help="A reference-layout .ckpt or a step=N/ directory.")
    y.add_argument("--texts", "-t", action="append", default=None,
                   help="Text to synthesize (repeatable).")
    y.add_argument("--filelist", "-f", default=None)
    y.add_argument("--output-type", "-O", action="extend", nargs="+",
                   choices=[f.value for f in SynthesizeOutputFormats], default=None,
                   help="One or more of the formats (default: wav).")
    y.add_argument("--language", "-l", default=None)
    y.add_argument("--speaker", "-s", default=None)
    y.add_argument("--text-representation", choices=["characters", "phones", "arpabet"],
                   default="characters",
                   help="Which filelist column / input representation to synthesize from.")
    y.add_argument("--duration-control", "-D", type=float, default=1.0)
    y.add_argument("--pitch-control", type=float, default=1.0)
    y.add_argument("--energy-control", type=float, default=1.0)
    y.add_argument("--vocoder-path", "-v", default=None,
                   help="A HiFiGAN .npz/.ckpt, or griffin-lim (also griffin_lim, gl).")
    y.add_argument("--vocoder-precision", choices=["float32", "bfloat16"], default="float32")
    y.add_argument("--style-reference", "-S", default=None,
                   help="A wav whose style a global-style-token model takes.")
    y.add_argument("--output-dir", "-o", default="synthesis_output")
    y.add_argument("--batch-size", "-b", type=int, default=None)
    y.add_argument("--data-parallel", type=int, default=None,
                   help="Split each batch's rows over N model replicas in this process, one "
                   "a card (cuda:0 .. cuda:N-1; N CPU replicas with --device cpu); the batch "
                   "size is rounded down to a multiple of N.")
    y.add_argument("--teacher-forcing-directory", "-T", default=None,
                   help="A preprocessed directory holding the target mels (and attention "
                   "priors or durations) of the filelist's utterances.")
    y.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=False,
                   help="Synthesize with the EMA weights of a step=N/ directory.")
    y.add_argument("--device", default=None,
                   help="'cuda' (default, the current card) or 'cpu'.")
    _config_args(y)
    y.set_defaults(command_parser=y)
    v = sub.add_parser(
        "train-vocoder",
        help="Train a HiFiGAN vocoder on the preprocessed corpus against the MPD and MSD "
        "discriminators. Writes <logger.save_dir>/vocoder/checkpoints/step=N/ and "
        "vocoder.npz (usable via --vocoder-path, in this package and the JAX one) and logs "
        "vocoder_log.jsonl. SIGTERM checkpoints the step in flight and exits 0.",
    )
    v.add_argument("config")
    v.add_argument("--max-steps", type=int, default=None)
    v.add_argument("--resume", action=argparse.BooleanOptionalAction, default=True)
    v.add_argument("--batch-size", type=int, default=16)
    v.add_argument("--frames-per-crop", type=int, default=32,
                   help="Mel frames per training crop (x hop = samples).")
    v.add_argument("--learning-rate", type=float, default=2e-4)
    v.add_argument("--ckpt-steps", type=int, default=5000)
    v.add_argument("--log-steps", type=int, default=50,
                   help="Log the losses at step 1 and every this many steps.")
    v.add_argument("--data-parallel", type=int, default=None,
                   help="Train as N ranks of a torchrun launch, one card each (torchrun "
                   "--nproc_per_node N ... train-vocoder CONFIG --data-parallel N; gloo with "
                   "--device cpu): the batch size is rounded up to a multiple of N and split "
                   "over the ranks, the gradients averaged.")
    v.add_argument("--finetune-from", default=None,
                   help="Initialize the generator from an existing vocoder checkpoint "
                   "(.ckpt torch or .npz); discriminators start fresh.")
    v.add_argument("--finetune-mels", default=None,
                   help="Train on acoustic-model-predicted mels: a directory produced by "
                   "`synthesize -O spec --teacher-forcing-directory <preprocessed>`.")
    v.add_argument("--precision", choices=["bfloat16", "float32"], default="bfloat16",
                   help="Conv compute dtype of the D+G step (parameters, losses and "
                   "optimizers stay float32).")
    v.add_argument("--device", default=None,
                   help="'cuda' (default, the current card) or 'cpu'.")
    _config_args(v)
    v.set_defaults(command_parser=v)
    e = sub.add_parser(
        "evaluate-vocoder",
        help="Copy-synthesis quality of a vocoder on the validation set: vocode "
        "ground-truth mels and score against the real audio (mel-L1, SI-SDR, STOI, "
        "PESQ-family proxy). Prints the report as JSON.",
    )
    e.add_argument("config")
    e.add_argument("--vocoder-path", "-v", required=True)
    e.add_argument("--n-utterances", "-n", type=int, default=16)
    e.add_argument("--vocoder-precision", choices=["float32", "bfloat16"], default="float32")
    e.add_argument("--device", default=None,
                   help="'cuda' (default, the current card) or 'cpu'.")
    _config_args(e)
    e.set_defaults(command_parser=e)
    r = sub.add_parser(
        "preprocess",
        help="Preprocess audio/spec/attn/text/pitch/energy artifacts + stats: the wavs "
        "of preprocessing.source_data become the tree under preprocessing.save_dir "
        "that train reads (filelists, stats.json, .npy artifacts).",
    )
    r.add_argument("config")
    r.add_argument("--steps", "-s", action="append", choices=STEPS, default=None,
                   help="Subset of preprocessing steps (default: all).")
    r.add_argument("--cpus", type=int, default=None, help="Worker processes.")
    r.add_argument("--on-device-spec", dest="on_device_spec", action="store_true",
                   default=False, help="Compute mel+energy as batched ops on the card.")
    r.add_argument("--host-spec", dest="on_device_spec", action="store_false",
                   help="Compute them on the host (the default).")
    r.add_argument("--device", default=None,
                   help="The on-device pass's device: 'cuda' (default) or 'cpu'.")
    _config_args(r)
    r.set_defaults(command_parser=r)
    k = sub.add_parser("check-data",
                       help="Dataset QA: stats, clipping, per-utterance loss scores.")
    k.add_argument("config")
    k.add_argument("--filelist", "-f", default=None)
    k.add_argument("--calculate-stats", action=argparse.BooleanOptionalAction, default=True)
    k.add_argument("--model-path", default=None,
                   help="Score utterances by model loss using this checkpoint.")
    k.add_argument("--output-dir", "-o", default="checked_data")
    k.add_argument("--objective-evaluation", action=argparse.BooleanOptionalAction,
                   default=False, help="Reference-free STOI/SI-SDR/PESQ-proxy metrics.")
    k.add_argument("--clip-detection", action=argparse.BooleanOptionalAction, default=False,
                   help="Thorough consecutive-run clipping detection (slower).")
    k.add_argument("--device", default=None,
                   help="The scoring model's device: 'cuda' (default) or 'cpu'.")
    _config_args(k)
    k.set_defaults(command_parser=k)
    a = sub.add_parser(
        "convert-artifacts",
        help="Convert a reference preprocessed tree (.pt artifacts) to .npy in place, so "
        "a corpus preprocessed with the PyTorch reference trains here without "
        "re-preprocessing.",
    )
    a.add_argument("preprocessed_dir")
    a.add_argument("--overwrite", action=argparse.BooleanOptionalAction, default=False,
                   help="Re-convert even when the .npy sibling already exists.")
    a.add_argument("--verbose", "-V", action="store_true")
    a.set_defaults(command_parser=a)
    b = sub.add_parser("benchmark", help="Time forward passes (training or inference mode).")
    b.add_argument("config")
    b.add_argument("--benchmark-type", choices=["training", "inference"], default="training")
    b.add_argument("--warmup-reps", type=int, default=10)
    b.add_argument("--repetitions", type=int, default=300)
    b.add_argument("--profile-dir", default=None,
                   help="Write a torch.profiler Chrome trace of the timed region into this "
                   "directory.")
    b.add_argument("--device", default=None,
                   help="'cuda' (default, the current card) or 'cpu'.")
    _config_args(b)
    b.set_defaults(command_parser=b)
    g = sub.add_parser(
        "average-checkpoints",
        help="Uniform parameter averaging over the step=N/ checkpoints under CKPT_DIR "
        "(a serving artifact: buffers, optimizer state and metadata come from the newest).")
    g.add_argument("ckpt_dir")
    g.add_argument("--output", "-o", required=True,
                   help="Directory to write the averaged checkpoint to.")
    g.add_argument("--last", "-n", type=int, default=None,
                   help="Average the N newest checkpoints (default: all under CKPT_DIR).")
    g.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=False,
                   help="Average the EMA shadows instead of the raw parameters.")
    g.set_defaults(command_parser=g)
    x = sub.add_parser(
        "export-checkpoint",
        help="Write a step=N/ directory's model as a standalone reference-layout Lightning "
        ".ckpt (loadable by the reference stack and by both packages).")
    x.add_argument("ckpt_path")
    x.add_argument("--output", "-o", required=True, help="Output .ckpt file path.")
    x.set_defaults(command_parser=x)
    o = sub.add_parser(
        "export-serving",
        help="Trace the serving program set with torch.export and write one self-contained "
        ".fs2x artifact: `serve MODEL.fs2x` (or ExportedSynthesizer) then runs synthesis with "
        "no model code or checkpoint (synthesis/exported.py). One program set per platform.")
    o.add_argument("ckpt_path", help="A reference-layout .ckpt or a step=N/ directory.")
    o.add_argument("--output", "-o", required=True, help="Output .fs2x artifact path.")
    o.add_argument("--vocoder-path", "-v", default=None,
                   help="Also export the HiFiGAN mel->wav programs.")
    o.add_argument("--batch-size", "-b", dest="batch_sizes", type=int, action="append",
                   default=None, help="Batch sizes to export programs for (repeatable; "
                   "default: 1 and 8).")
    o.add_argument("--text-bucket", dest="text_buckets", type=int, action="append",
                   default=None, help="Text-length buckets (repeatable). Default: every "
                   "16-multiple up to the corpus chunker's max emit length.")
    o.add_argument("--max-frames", type=int, default=None)
    o.add_argument("--streaming-window", dest="streaming_windows", type=int, action="append",
                   default=None, help="Low-latency windowed-vocoder window sizes (frames) to "
                   "export (repeatable; default: 128).")
    o.add_argument("--platforms", default=None,
                   help="Comma-separated platforms to export programs for: cpu, cuda (gpu) or "
                   "cpu,cuda. Default: the device the export runs on.")
    o.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=False,
                   help="Export the EMA weights of a step=N/ directory.")
    o.add_argument("--device", default=None,
                   help="'cuda' (default, the current card) or 'cpu': where the export runs.")
    o.set_defaults(command_parser=o)
    d = sub.add_parser(
        "doctor",
        help="Environment diagnostics: versions, the card (probed in a subprocess with a "
        "timeout), nvcc and every CUDA kernel source, the kernel build cache, and optional "
        "config/artifact validation. Exit code 1 on hard failures.")
    d.add_argument("config", nargs="?", default=None)
    d.add_argument("--device-timeout", type=float, default=60.0,
                   help="Seconds to wait for the card's initialization before declaring it "
                   "down (default: 60.0).")
    d.set_defaults(command_parser=d)
    return p


def benchmark_command(args) -> None:
    """The JAX ``benchmark``'s timing and line: one batch, warmup, 5 trials of
    ``--repetitions`` chained calls, the mean, spread and best ms a call
    beside the FLOPs and MFU."""
    import numpy as np
    import torch

    _must_exist(args, ("'CONFIG_FILE'", args.config))
    from .device import resolve_device
    from .utils.benchmarking import (
        check_mfu,
        count_flops,
        prepare_benchmark,
        time_chained,
    )

    device = resolve_device(args.device)
    config = _load_config(args)
    bench = prepare_benchmark(config, args.benchmark_type, device)
    flops = count_flops(bench.fn, bench.batch, torch.zeros((), device=device))
    profiler = None
    if args.profile_dir is not None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    trials = time_chained(bench.fn, [bench.batch], reps=args.repetitions, trials=5,
                          warmup=args.warmup_reps)
    if profiler is not None:
        profiler.stop()
        trace = Path(args.profile_dir) / "trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(trace))
        print(f"Wrote profiler trace to {trace}", flush=True)
    per_call_ms = np.asarray(trials) / args.repetitions * 1000
    mfu = check_mfu(flops, float(per_call_ms.min()) / 1000)
    print(
        f"Average forward pass for {args.benchmark_type} duration after "
        f"{args.repetitions} repetitions: {per_call_ms.mean():.3f} ms "
        f"Standard Deviation: {per_call_ms.std():.3f} "
        f"(best {per_call_ms.min():.3f} ms, {flops / 1e12:.3f} TFLOP/call, "
        f"MFU {mfu * 100:.1f}%; forced-completion chained timing)", flush=True)


def average_checkpoints_command(args) -> None:
    _must_exist(args, ("'CKPT_DIR'", args.ckpt_dir))
    from .training.checkpoint import average_checkpoints

    steps = sorted((p for p in Path(args.ckpt_dir).glob("step=*")
                    if p.is_dir() and p.name.split("=")[1].isdigit()),
                   key=lambda p: int(p.name.split("=")[1]))
    if not steps:
        args.command_parser.error(f"No step=N checkpoints under {args.ckpt_dir}")
    if args.last:
        steps = steps[-args.last:]
    out = average_checkpoints(steps, Path(args.output), use_ema=args.use_ema)
    print(f"Averaged {len(steps)} checkpoints -> {out}", flush=True)


def export_checkpoint_command(args) -> None:
    """A port ``step=N/``'s ``model.ckpt`` (already in the reference layout)
    copied to `--output`; an orbax directory is the JAX command's job."""
    import shutil

    _must_exist(args, ("'CKPT_PATH'", args.ckpt_path))
    src = Path(args.ckpt_path) / "model.ckpt"
    if not src.is_file():
        args.command_parser.error(
            f"{args.ckpt_path} is not a step=N/ directory holding model.ckpt (an orbax "
            "checkpoint?): export it with the JAX package's `fs2t export-checkpoint`")
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src, out)
    print(f"exported {args.ckpt_path} -> {out}", flush=True)


def export_serving_command(args) -> None:
    from .synthesis.exported import export_serving_artifact, parse_platforms

    _must_exist(args, ("'CKPT_PATH'", args.ckpt_path),
                ("'--vocoder-path' / '-v'", args.vocoder_path))
    try:
        platforms = parse_platforms(args.platforms)
    except ValueError as e:
        args.command_parser.error(f"Invalid value for '--platforms': {e}")
    out = export_serving_artifact(
        args.ckpt_path, args.output, vocoder_path=args.vocoder_path,
        batch_sizes=tuple(args.batch_sizes or (1, 8)),
        text_buckets=tuple(args.text_buckets) if args.text_buckets else None,
        max_frames=args.max_frames,
        streaming_windows=tuple(args.streaming_windows or (128,)),
        platforms=platforms, use_ema=args.use_ema, device=args.device,
    )
    print(f"exported serving artifact -> {out} ({out.stat().st_size / 1e6:.1f} MB)", flush=True)


def preprocess_command(args) -> None:
    _must_exist(args, ("'CONFIG_FILE'", args.config))
    from .preprocessing.pipeline import ALL_STEPS, Preprocessor

    config = _load_config(args)
    result = Preprocessor(config).run(steps=args.steps or ALL_STEPS, cpus=args.cpus,
                                      on_device_spec=args.on_device_spec, device=args.device)
    print(f"Preprocessed {result['n_train']} training + {result['n_val']} validation "
          f"utterances -> {config.preprocessing.save_dir}", flush=True)


def check_data_cli(args) -> None:
    _must_exist(args, ("'CONFIG_FILE'", args.config), ("'--filelist' / '-f'", args.filelist))
    from .check_data import check_data_command

    check_data_command(
        _load_config(args), None if args.filelist is None else Path(args.filelist),
        args.calculate_stats, None if args.model_path is None else Path(args.model_path),
        Path(args.output_dir), objective_evaluation=args.objective_evaluation,
        clip_detection=args.clip_detection, device=args.device)


def convert_artifacts_command(args) -> None:
    _must_exist(args, ("'PREPROCESSED_DIR'", args.preprocessed_dir))
    from .preprocessing.convert import convert_artifact_tree

    converted, skipped = convert_artifact_tree(
        Path(args.preprocessed_dir), overwrite=args.overwrite,
        log=print if args.verbose else (lambda s: None))
    print(f"converted {converted} artifacts, skipped {skipped}", flush=True)


def train_vocoder_command(args) -> None:
    _must_exist(args, ("'CONFIG_FILE'", args.config), ("'--finetune-from'", args.finetune_from),
                ("'--finetune-mels'", args.finetune_mels))
    from .device import resolve_device
    from .training.vocoder import VocoderTrainingConfig, train_vocoder

    device = resolve_device(args.device)
    tc = VocoderTrainingConfig(batch_size=args.batch_size,
                               frames_per_crop=args.frames_per_crop,
                               learning_rate=args.learning_rate, ckpt_steps=args.ckpt_steps,
                               compute_dtype=args.precision, log_steps=args.log_steps)
    try:
        train_vocoder(
            _load_config(args), train_config=tc, max_steps=args.max_steps, resume=args.resume,
            data_parallel=args.data_parallel,
            finetune_from=None if args.finetune_from is None else Path(args.finetune_from),
            finetune_mel_dir=None if args.finetune_mels is None else Path(args.finetune_mels),
            device=device)
    finally:
        if (args.data_parallel or 1) > 1:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def evaluate_vocoder_command(args) -> None:
    import json

    _must_exist(args, ("'CONFIG_FILE'", args.config),
                ("'--vocoder-path' / '-v'", args.vocoder_path))
    from .device import resolve_device
    from .evaluation import evaluate_vocoder

    device = resolve_device(args.device)
    report = evaluate_vocoder(_load_config(args), Path(args.vocoder_path),
                              n_utterances=args.n_utterances,
                              precision=args.vocoder_precision, device=device)
    print(json.dumps(report, indent=2), flush=True)


def synthesize(args) -> None:
    """The ``synthesize`` command: the JAX package's options, defaults and
    usage errors (each exits 2 with the JAX package's message)."""
    from .config import CHARACTERS

    parser = args.command_parser
    output_type = [SynthesizeOutputFormats(o) for o in args.output_type or ["wav"]]
    _must_exist(args, ("'MODEL_PATH'", args.model_path), ("'--filelist' / '-f'", args.filelist),
                ("'--style-reference' / '-S'", args.style_reference))
    if not args.texts and args.filelist is None:
        parser.error("You must define either --text or --filelist")
    if args.texts and args.filelist is not None:
        parser.error("Only one of --text and --filelist may be used")
    needs_vocoder = (SynthesizeOutputFormats.wav in output_type
                     or SynthesizeOutputFormats.readalong_html in output_type)
    if needs_vocoder and args.vocoder_path is None:
        parser.error("Missing --vocoder-path option. A vocoder is required for wav "
                     "and readalong-html output.")

    from .checkpoint import load_model_from_checkpoint
    from .parallel.replicas import replica_devices
    from .synthesis.prepare import prepare_data
    from .synthesis.synthesize import synthesize_items
    from .synthesis.writers import get_synthesis_output_writers

    # --data-parallel N: one model replica a device in this process
    devices = (replica_devices(None, args.data_parallel, args.device)
               if (args.data_parallel or 1) > 1 else None)
    model, config, stats, lang2id, speaker2id, global_step = load_model_from_checkpoint(
        Path(args.model_path), device=devices[0] if devices else args.device,
        use_ema=args.use_ema)
    if args.config_args:
        # inference-time overrides of the checkpoint's config
        from .config import FastSpeech2Config, apply_overrides

        config = FastSpeech2Config.from_dict(apply_overrides(config.to_dict(),
                                                             args.config_args))
    teacher_forcing = args.teacher_forcing_directory is not None
    if teacher_forcing:
        # the target mels and priors come from this preprocessed directory
        config.preprocessing.save_dir = str(args.teacher_forcing_directory)

    vocoder, vocoder_global_step, output_hop = None, 0, None
    if args.vocoder_path is not None:
        from .synthesis.griffin_lim import GriffinLimVocoder, is_griffin_lim_path

        device = next(model.parameters()).device
        if is_griffin_lim_path(args.vocoder_path):
            vocoder = GriffinLimVocoder(config.preprocessing.audio, device=device)
            output_hop = vocoder.hop
        else:
            from .models.hifigan import load_vocoder_params, make_vocoder_fn

            vp, vcfg, vocoder_global_step = load_vocoder_params(Path(args.vocoder_path))
            vocoder = make_vocoder_fn(vp, vcfg, precision=args.vocoder_precision,
                                      device=device)
            output_hop = vcfg.total_upsampling

    if (args.text_representation != CHARACTERS
            and config.model.target_text_representation_level == CHARACTERS):
        parser.error(
            f"--text-representation {args.text_representation} requires a model "
            "trained on phones (target_text_representation_level), but this "
            "checkpoint was trained on characters.")
    items = prepare_data(
        texts=args.texts, language=args.language, speaker=args.speaker,
        filelist=args.filelist, config=config, stats=stats, lang2id=lang2id,
        speaker2id=speaker2id, text_representation=args.text_representation,
        duration_control=args.duration_control, style_reference=args.style_reference,
        # each utterance pairs with its whole target mel: no chunking
        split_text=False if teacher_forcing else None,
    )
    writers = get_synthesis_output_writers(
        output_type, Path(args.output_dir), config,
        "postnet_output" if config.model.use_postnet else "output",
        global_step, vocoder=vocoder, vocoder_global_step=vocoder_global_step,
        output_hop_size=output_hop,
    )
    synthesize_items(
        items, model, config, lang2id, speaker2id, writers, batch_size=args.batch_size,
        teacher_forcing=teacher_forcing,
        control={"pitch": args.pitch_control, "energy": args.energy_control,
                 "duration": args.duration_control},
        devices=devices,
    )
    print(f"Wrote outputs to {args.output_dir}", flush=True)


def train_command(args) -> None:
    """``train``; with ``--distributed`` one rank of a process group (one
    device a process: the JAX package's one-process mesh over several
    devices is ``torchrun --nproc_per_node N`` here)."""
    from .parallel import init_distributed, layout
    from .training.loop import Trainer

    if args.model_parallel < 1:
        args.command_parser.error("--model-parallel must be at least 1")
    device, layout_args = args.device, {}
    if args.distributed:
        device = init_distributed(args.device)
        layout_args = {"model_parallel": args.model_parallel}
    elif args.model_parallel > 1:
        args.command_parser.error(
            f"--model-parallel {args.model_parallel} needs one process per device: launch "
            f"with torchrun (torchrun --nproc_per_node N -m fastspeech2_lightning_tpu_torch "
            f"train CONFIG --distributed --model-parallel {args.model_parallel})")
    try:
        trainer = Trainer(_load_config(args), device=device, **layout_args)
        rows = trainer.fit(max_steps=args.max_steps, resume=args.resume)
        if layout().is_main:
            print(f"trained {len(rows)} steps; checkpoint {trainer.ckpt_path}", flush=True)
    finally:
        if args.distributed:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    if args.command == "synthesize":
        synthesize(args)
    elif args.command == "train-vocoder":
        train_vocoder_command(args)
    elif args.command == "evaluate-vocoder":
        evaluate_vocoder_command(args)
    elif args.command == "preprocess":
        preprocess_command(args)
    elif args.command == "check-data":
        check_data_cli(args)
    elif args.command == "convert-artifacts":
        convert_artifacts_command(args)
    elif args.command == "benchmark":
        benchmark_command(args)
    elif args.command == "average-checkpoints":
        average_checkpoints_command(args)
    elif args.command == "export-checkpoint":
        export_checkpoint_command(args)
    elif args.command == "export-serving":
        export_serving_command(args)
    elif args.command == "doctor":
        from .doctor import run_doctor

        raise SystemExit(run_doctor(args.config, device_timeout_s=args.device_timeout))
    elif args.command == "train":
        train_command(args)
    elif args.command == "serve":
        from .serving import serve

        if args.style_reference is not None and not Path(args.style_reference).exists():
            args.command_parser.error("Invalid value for '--style-reference' / '-S': Path "
                                      f"'{args.style_reference}' does not exist.")
        server = serve(
            args.model_path, vocoder_path=args.vocoder_path, host=args.host,
            port=args.port, max_batch=args.max_batch,
            batch_window_ms=args.batch_window_ms, max_frames=args.max_frames,
            vocoder_precision=args.vocoder_precision,
            warmup=args.warmup, device=args.device, use_ema=args.use_ema,
            style_reference=args.style_reference, data_parallel=args.data_parallel,
        )
        print(f"serving on http://{server.address[0]}:{server.address[1]}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
