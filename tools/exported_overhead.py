"""Whether an exported acoustic program's extra host time is its weight
arguments, on the card.

The serving artifact passes the weights to each program as arguments (the
JAX artifact's design), and the loaded module flattens and checks every
argument on every call. This script exports the acoustic program of the
serving bucket (B 8, L 128, T 1536) of ``chip_smoke.py``'s model (the
default config at full width, bf16, seeded random weights) twice, with the
weights as arguments and with the weights as the program's own constants,
loads both, and times them beside the live forward on the same inputs, in
turns (CUDA events, medians). It needs a CUDA card; run it from the root of
a checkout:

    python tools/exported_overhead.py

It prints the card, each path's median ms and a JSON line."""

import io
import json
import statistics
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402

B, L, T = 8, 128, 1536
REPS = 20


class _Constants(torch.nn.Module):
    """The same forward with the model as a submodule: the program lifts
    its weights and ``module()`` binds them as constants."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, text, src_lens, speaker_id, language_id, pitch, energy, duration):
        out = self.model(text, src_lens, T, control={"pitch": pitch, "energy": energy,
                                                     "duration": duration},
                         speaker_id=speaker_id, language_id=language_id)
        return out["postnet_output"], out["tgt_lens"], out["duration_rounded"]


def _loaded(module, args):
    ep = torch.export.export(module, args)
    ep._example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return torch.export.load(io.BytesIO(buf.getvalue())).module()


def main() -> None:
    smi = smoke.phase_device()
    print(smi, flush=True)
    from fastspeech2_lightning_tpu_torch.checkpoint import (
        load_model_from_checkpoint, write_checkpoint,
    )
    from fastspeech2_lightning_tpu_torch.synthesis.exported import _Acoustic

    cfg = smoke.model_config("bfloat16")
    sd = smoke.random_state_dict(cfg, np.random.default_rng(smoke.SEED))
    with tempfile.TemporaryDirectory() as d:
        ckpt = write_checkpoint(Path(d) / "model.ckpt", sd, cfg, smoke.STATS)
        model = load_model_from_checkpoint(ckpt)[0]
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    text = torch.randint(8, 34, (B, L), generator=g).to(dev)
    lens = torch.full((B,), L, dtype=torch.int64, device=dev)
    ids = torch.zeros((B,), dtype=torch.int64, device=dev)
    one = torch.ones((), device=dev)
    params = dict(model.state_dict())
    user = (text, lens, ids, ids, one, one, one)
    as_args = _loaded(_Acoustic(model, T, "postnet_output"), (params, *user))
    as_consts = _loaded(_Constants(model), user)
    paths = {
        "live": lambda: model(text, lens, T, control={"pitch": 1.0, "energy": 1.0,
                                                      "duration": 1.0},
                              speaker_id=ids, language_id=ids)["postnet_output"],
        "weights_as_arguments": lambda: as_args(params, *user)[0],
        "weights_as_constants": lambda: as_consts(*user)[0],
    }
    with torch.inference_mode():
        want = paths["live"]()
        for name, fn in paths.items():
            got = fn()
            assert torch.equal(got, want), f"{name} differs from the live forward"
        ms = {name: [] for name in paths}
        order = list(paths)
        for i in range(REPS):
            for name in (order if i % 2 == 0 else order[::-1]):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                paths[name]()
                end.record()
                end.synchronize()
                ms[name].append(start.elapsed_time(end))
    med = {name: statistics.median(v) for name, v in ms.items()}
    for name, v in med.items():
        print(f"{name}: {v:.3f} ms a call (median of {REPS}, in turns; {len(params)} weight "
              f"tensors; {smi})", flush=True)
    print(json.dumps({"shape": [B, L, T], "ms": med, "weights": len(params), "card": smi}))


if __name__ == "__main__":
    main()
