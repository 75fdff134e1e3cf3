"""Command line of the PyTorch port (argparse; the JAX package's click CLI is
not a dependency here).

    python -m fastspeech2_lightning_tpu_torch serve MODEL.ckpt -v VOCODER.npz --port 8777
    python -m fastspeech2_lightning_tpu_torch train CONFIG.json --max-steps 1000
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m fastspeech2_lightning_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser(
        "serve",
        help="Resident batch-streaming synthesis server (POST /synthesize, "
        "GET /health, GET /stats). MODEL_PATH is a Lightning .ckpt in the "
        "reference layout (`fs2t export-checkpoint` converts an orbax checkpoint).",
    )
    s.add_argument("model_path")
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
    s.add_argument("--warmup", action="store_true",
                   help="Build the kernels before accepting requests.")
    s.add_argument("--device", default=None,
                   help="'cuda' (default, the current card) or 'cpu'.")
    t = sub.add_parser(
        "train",
        help="Train the acoustic model on a preprocessed corpus. CONFIG is a JSON "
        "config file (the JAX package's CLI reads the same file); the run writes "
        "train_log.jsonl and checkpoints/last.ckpt under the logger's directory.",
    )
    t.add_argument("config")
    t.add_argument("--max-steps", type=int, default=None,
                   help="Stop after this many steps (default: training.max_steps).")
    t.add_argument("--device", default=None,
                   help="'cuda' (default, the current card) or 'cpu'.")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    if args.command == "train":
        from .config import FastSpeech2Config
        from .training.loop import Trainer

        trainer = Trainer(FastSpeech2Config.from_file(args.config), device=args.device)
        rows = trainer.fit(max_steps=args.max_steps)
        print(f"trained {len(rows)} steps; checkpoint {trainer.ckpt_path}", flush=True)
    elif args.command == "serve":
        from .serving import serve

        server = serve(
            args.model_path, vocoder_path=args.vocoder_path, host=args.host,
            port=args.port, max_batch=args.max_batch,
            batch_window_ms=args.batch_window_ms, max_frames=args.max_frames,
            vocoder_precision=args.vocoder_precision,
            warmup=args.warmup, device=args.device,
        )
        print(f"serving on http://{server.address[0]}:{server.address[1]}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
