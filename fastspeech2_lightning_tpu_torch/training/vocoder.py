"""HiFiGAN vocoder training (counterpart of the JAX package's
``training/vocoder.py``): the discriminator and generator step, the crop
loader, checkpoints without orbax, and ``train_vocoder``.

The recipe is the HiFiGAN paper's (arXiv:2010.05646), as the JAX package
runs it: LSGAN losses over the MPD and MSD sub-discriminators; feature
matching (L1, weight 2) over every discriminator feature map; log-mel L1
(weight 45) between the generated and the real wav through
``mel_spectrogram_torch``; AdamW (betas 0.8/0.99, eps 1e-8, weight decay
0.01 on every parameter) on each side with an exponential learning-rate
decay; D updated first, then G against the updated D.

Precision: ``compute_dtype`` "bfloat16" (the default) casts every parameter
and the waveforms to bf16 inside the forward, before the weight norm, as the
JAX step casts its parameter tree (``vocoder.py:100-114``); scores and
features come back to f32, and the losses, the mel and both optimizers are
f32. "float32" keeps PyTorch's defaults, TF32 included on a card (the port
sets no TF32 flag, as the acoustic trainer does not).

The generator runs once a step: its output, detached, feeds the D update,
and the same output with its graph feeds the G loss. The JAX step runs the
generator twice on the same parameters, which computes the same function.

A checkpoint is ``checkpoints/step=N/`` with ``train_state.pt`` (generator,
discriminators and both optimizers' state_dicts, host tensors) and
``meta.json`` (the JAX package's keys), written into ``step=N.tmp`` and
renamed; the 5 newest are kept, and each save refreshes
``checkpoints/vocoder.npz``, the generator in the JAX package's pytree of
numpy f32 arrays, which both packages' ``load_vocoder_params`` read."""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..convert import hifigan_state_to_jax
from ..device import resolve_device
from ..models.hifigan import HiFiGANConfig, HiFiGANGenerator, init_random_hifigan
from ..models.hifigan_discriminators import (
    DiscriminatorConfig,
    Discriminators,
    discriminator_forward,
)
from ..preprocessing.features import LOG_CLIP, mel_spectrogram_torch
from ..utils.tensorboard import SummaryWriter
from .checkpoint import latest_checkpoint
from .preemption import install_preemption_handler

MODEL_INFO = {"name": "HiFiGAN", "version": "1.0"}
LOSS_KEYS = ("d", "g", "g_adv", "fm", "mel_l1")


@dataclasses.dataclass
class VocoderTrainingConfig:
    """The JAX package's ``VocoderTrainingConfig`` (``vocoder.py:51-70``),
    and ``log_steps``: the JAX loop logs at step 1 and every 50 steps; the
    port takes the 50 from here."""

    batch_size: int = 16
    frames_per_crop: int = 32  # 32 * hop(256) = 8192-sample crops
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999  # per lr_decay_steps updates
    lr_decay_steps: int = 1000
    mel_weight: float = 45.0
    fm_weight: float = 2.0
    max_steps: int = 400000
    ckpt_steps: int = 5000
    seed: int = 0
    compute_dtype: str = "bfloat16"
    log_steps: int = 50


def learning_rate(tc: VocoderTrainingConfig, update: int) -> float:
    """The rate of update `update` (0-based): lr * decay^(update / steps),
    no staircase, evaluated in float32 as optax's ``exponential_decay``."""
    p = np.float32(update) / np.float32(tc.lr_decay_steps)
    return float(np.float32(tc.learning_rate) * np.float32(tc.lr_decay) ** p)


@dataclasses.dataclass
class VocoderState:
    gen: HiFiGANGenerator
    disc: Discriminators
    opt_g: torch.optim.AdamW
    opt_d: torch.optim.AdamW
    step: int = 0


def _adamw(params, tc: VocoderTrainingConfig, device: torch.device) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate(tc, 0), betas=(tc.adam_b1, tc.adam_b2),
                             eps=1e-8, weight_decay=0.01, fused=device.type == "cuda")


def create_vocoder_state(gen_config: HiFiGANConfig, disc_config: DiscriminatorConfig,
                         train_config: VocoderTrainingConfig, device=None) -> VocoderState:
    """The generator from ``init_random_hifigan`` (the JAX package's weights
    for the seed), fresh discriminators and two AdamWs, on `device`."""
    device = resolve_device(device)
    gen = HiFiGANGenerator(gen_config, init_random_hifigan(gen_config, train_config.seed),
                           device=device)
    disc = Discriminators(disc_config, seed=train_config.seed, device=device)
    return VocoderState(gen=gen, disc=disc, opt_g=_adamw(gen.parameters(), train_config, device),
                        opt_d=_adamw(disc.parameters(), train_config, device))


def mel_fn(wav: torch.Tensor, a) -> torch.Tensor:
    """[B, N] -> [B, n_mels, T] log-mel with the corpus audio settings."""
    return mel_spectrogram_torch(wav, a.input_sampling_rate, a.n_fft, a.fft_hop_size,
                                 a.fft_window_size, a.n_mels, a.f_min, a.f_max,
                                 htk=a.spec_type == "mel")


def _disc(disc: Discriminators, wav: torch.Tensor, dt: torch.dtype):
    return discriminator_forward(disc, wav.to(dt))


def _step_optimizer(opt: torch.optim.AdamW, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def make_vocoder_train_step(gen_config: HiFiGANConfig, disc_config: DiscriminatorConfig,
                            train_config: VocoderTrainingConfig, audio_config):
    """-> step(state, batch) -> losses: one D update, then one G update,
    in place on `state`. batch: {"mel" [B, F, n_mels], "wav" [B, F * hop]}
    f32 tensors on the state's device. The losses are 0-d f32 tensors on the
    device (read them at a logging step only: each read waits for the card).
    After the step each D parameter's ``.grad`` holds the D update's
    gradient and each G parameter's the G update's."""
    dt = torch.bfloat16 if train_config.compute_dtype == "bfloat16" else torch.float32

    def step(state: VocoderState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        mel, wav = batch["mel"], batch["wav"]
        B = wav.shape[0]
        gen, disc = state.gen, state.disc
        lr = learning_rate(train_config, state.step)
        wav_fake = gen(mel, dt)

        # 1) discriminator update on [real; fake] at 2B, the fake detached
        disc.requires_grad_(True)
        s_all, _ = _disc(disc, torch.cat([wav, wav_fake.detach()]), dt)
        d_loss = 0.0
        for s in s_all:
            s = s.float()
            d_loss = d_loss + torch.mean((s[:B] - 1.0) ** 2) + torch.mean(s[B:] ** 2)
        state.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        _step_optimizer(state.opt_d, lr)

        # 2) generator update against the updated discriminator, which
        # takes no gradient here
        disc.requires_grad_(False)
        try:
            s_fake, f_fake = _disc(disc, wav_fake, dt)
            with torch.no_grad():
                _, f_real = _disc(disc, wav, dt)
                mel_real = mel_fn(wav, audio_config)
            adv = 0.0
            for sf in s_fake:
                adv = adv + torch.mean((sf.float() - 1.0) ** 2)
            fm = 0.0
            for fr_list, ff_list in zip(f_real, f_fake):
                for fr, ff in zip(fr_list, ff_list):
                    fm = fm + torch.mean(torch.abs(fr.float() - ff.float()))
            mel_l1 = torch.mean(torch.abs(mel_fn(wav_fake, audio_config) - mel_real))
            total = adv + train_config.fm_weight * fm + train_config.mel_weight * mel_l1
            state.opt_g.zero_grad(set_to_none=True)
            total.backward()
        finally:
            disc.requires_grad_(True)
        _step_optimizer(state.opt_g, lr)
        state.step += 1
        return {"d": d_loss.detach(), "g": total.detach(), "g_adv": adv.detach(),
                "fm": fm.detach(), "mel_l1": mel_l1.detach()}

    return step


# ---------------------------------------------------------------------------
# data: random fixed-size crops of the preprocessed corpus
# ---------------------------------------------------------------------------


class VocoderCropLoader:
    """Random (mel, wav) crops of the corpus the acoustic model trains on
    (``vocoder.py:222-328``): ``audio-SR.wav`` and the log-mel ``spec``
    ([n_mels, T]) of each row of the training filelist, or with
    `finetune_mel_dir` the teacher-forced ``spec-pred`` files that
    ``synthesize -O spec -T ...`` wrote under ``<dir>/synthesized_spec``
    (named by the slugified utterance text, else the basename). A crop
    shorter than ``frames_per_crop`` is padded: the mel with log(LOG_CLIP),
    the wav with zeros. The draws are the JAX loader's, in its order, so the
    same seed gives the same batches."""

    def __init__(self, config, train_config: VocoderTrainingConfig, rng=None,
                 finetune_mel_dir: Optional[Path] = None):
        from ..dataset import SEP
        from ..preprocessing.pipeline import Preprocessor
        from ..text.lookups import load_filelist
        from ..utils import slugify, truncate_basename

        self.a = config.preprocessing.audio
        self.frames = train_config.frames_per_crop
        self.hop = self.a.fft_hop_size
        self.batch = train_config.batch_size
        self.rng = rng or np.random.default_rng(train_config.seed)
        pre = Preprocessor(config)
        self.items = []
        skipped = 0
        for r in load_filelist(Path(config.training.training_filelist)):
            b = r["basename"]
            s = r.get("speaker") or "default"
            lang = r.get("language") or "default"
            wav_p = pre.artifact_path("audio", b, s, lang,
                                      f"audio-{self.a.input_sampling_rate}.wav")
            if finetune_mel_dir is not None:
                tail = f"spec-pred-{self.a.input_sampling_rate}-{self.a.spec_type}.npy"
                text = r.get("characters") or r.get("text") or ""
                spec_p = None
                for name in (truncate_basename(slugify(text)) if text else None,
                             truncate_basename(b)):
                    if not name:
                        continue
                    spec_p = (Path(finetune_mel_dir) / "synthesized_spec"
                              / SEP.join([name, s, lang, tail]))
                    if spec_p.exists():
                        break
            else:
                spec_p = pre.artifact_path("spec", b, s, lang, pre.spec_filename())
            if wav_p.exists() and spec_p.exists():
                self.items.append((wav_p, spec_p))
            else:
                skipped += 1
        if not self.items:
            raise FileNotFoundError(
                "no (audio, spec) artifact pairs found — run `preprocess` with the audio "
                "and spec steps first"
                + (f" (and synthesize teacher-forced specs into {finetune_mel_dir})"
                   if finetune_mel_dir else ""))
        if skipped:
            print(f"vocoder loader: skipped {skipped} rows missing artifacts")

    def next_batch(self) -> Dict[str, np.ndarray]:
        from ..preprocessing.pipeline import load_wav

        F, hop = self.frames, self.hop
        mels = np.full((self.batch, F, self.a.n_mels), np.log(LOG_CLIP), np.float32)
        wavs = np.zeros((self.batch, F * hop), np.float32)
        for i in range(self.batch):
            wav_p, spec_p = self.items[self.rng.integers(len(self.items))]
            mel = np.load(spec_p)  # [n_mels, T]
            wav = load_wav(wav_p, self.a.input_sampling_rate)
            T = mel.shape[1]
            s = int(self.rng.integers(0, T - F)) if T > F else 0
            m = mel[:, s: s + F]
            w = wav[s * hop: (s + F) * hop]
            mels[i, : m.shape[1]] = m.T
            wavs[i, : len(w)] = w
        return {"mel": mels, "wav": wavs}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _host(obj):
    """A state_dict (nested dicts and lists) with every tensor copied to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def write_vocoder_npz(path: Path, gen: HiFiGANGenerator, step: int) -> None:
    """The generator as the JAX package's ``vocoder.npz`` (``params``: its
    pytree of numpy f32 arrays; ``config``; ``global_step``), written to a
    temporary file and renamed."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, params=np.array(hifigan_state_to_jax(gen.state_dict(), gen.config),
                                    dtype=object),
                 config=np.array(dataclasses.asdict(gen.config), dtype=object),
                 global_step=step)
    os.replace(tmp, path)


def save_vocoder_checkpoint(ckpt_dir: Path, state: VocoderState, keep: int = 5) -> Path:
    """Write ``step=N/`` (N = state.step) and refresh ``vocoder.npz`` under
    `ckpt_dir`; keep the `keep` newest step directories."""
    ckpt_dir = Path(ckpt_dir)
    path = ckpt_dir / f"step={state.step}"
    tmp = ckpt_dir / f"step={state.step}.tmp"
    for p in (path, tmp):
        if p.exists():
            shutil.rmtree(p)
    tmp.mkdir(parents=True)
    torch.save(_host({"gen": state.gen.state_dict(), "disc": state.disc.state_dict(),
                      "opt_g": state.opt_g.state_dict(), "opt_d": state.opt_d.state_dict()}),
               tmp / "train_state.pt")
    (tmp / "meta.json").write_text(json.dumps(
        {"model_info": MODEL_INFO, "global_step": state.step,
         "generator_config": dataclasses.asdict(state.gen.config)}, indent=2))
    tmp.rename(path)
    write_vocoder_npz(ckpt_dir / "vocoder.npz", state.gen, state.step)
    steps = sorted((p for p in ckpt_dir.glob("step=*") if p.name.split("=")[1].isdigit()),
                   key=lambda p: int(p.name.split("=")[1]))
    for old in steps[:-keep]:
        shutil.rmtree(old)
    return path


def load_vocoder_training_checkpoint(path: Path, state: VocoderState) -> VocoderState:
    """Restore a ``step=N/`` the port wrote into `state` (resume). A JAX
    package's ``step=N/`` (orbax ``arrays/``) is refused by name: the port
    cannot read it without orbax."""
    path = Path(path)
    if (path / "arrays").exists() or not (path / "train_state.pt").exists():
        raise ValueError(
            f"{path} is not a checkpoint of the port's vocoder trainer (no train_state.pt"
            + ("; it holds the JAX package's orbax arrays/" if (path / "arrays").exists()
               else "")
            + "): pass --no-resume or another log directory")
    meta = json.loads((path / "meta.json").read_text())
    saved = torch.load(path / "train_state.pt", map_location="cpu", weights_only=True)
    state.gen.load_state_dict(saved["gen"])
    state.disc.load_state_dict(saved["disc"])
    state.opt_g.load_state_dict(saved["opt_g"])
    state.opt_d.load_state_dict(saved["opt_d"])
    state.step = int(meta["global_step"])
    return state


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def train_vocoder(config, train_config: Optional[VocoderTrainingConfig] = None,
                  gen_config: Optional[HiFiGANConfig] = None,
                  disc_config: Optional[DiscriminatorConfig] = None,
                  log_dir: Optional[Path] = None, max_steps: Optional[int] = None,
                  resume: bool = True, data_parallel: Optional[int] = None,
                  finetune_from: Optional[Path] = None,
                  finetune_mel_dir: Optional[Path] = None, device=None) -> VocoderState:
    """Crops -> D+G steps -> checkpoints (``vocoder.py:411-599``), on
    `device` (the card unless "cpu"). The log directory defaults to
    ``<logger.save_dir>/vocoder``; a run resumes from the newest complete
    ``checkpoints/step=N/`` unless `resume` is False. `finetune_from` (a
    .ckpt/.pt or .npz vocoder) starts the generator from its weights, the
    discriminators fresh; with checkpoints to resume it raises. At step 1
    and every ``log_steps`` steps the losses go to stdout, to
    ``vocoder_log.jsonl`` and to a TensorBoard event file in the log
    directory as ``vocoder/<k>`` (``vocoder.py:526-531, :585-587``), and a
    non-finite one raises. SIGTERM or SIGINT
    finishes the step in flight, checkpoints and returns. The run ends with
    a checkpoint at its last step (the JAX loop writes that one twice)."""
    device = resolve_device(device)
    train_config = train_config or VocoderTrainingConfig()
    if data_parallel is not None and data_parallel > 1:
        raise NotImplementedError(
            "data-parallel vocoder training is not ported yet (later slice: data parallel)")
    a = config.preprocessing.audio
    ft_sd = None
    if finetune_from is not None:
        from ..models.hifigan import load_vocoder_params

        ft_sd, ft_config, ft_step = load_vocoder_params(Path(finetune_from))
        if gen_config is not None and dataclasses.asdict(gen_config) != (
                dataclasses.asdict(ft_config)):
            raise ValueError("--finetune-from checkpoint architecture differs from the "
                             "requested generator config")
        gen_config = ft_config
        print(f"fine-tuning generator from {finetune_from} (step {ft_step})")
    if gen_config is None:
        gen_config = HiFiGANConfig(n_mels=a.n_mels, sampling_rate=a.output_sampling_rate,
                                   hop_size=a.fft_hop_size)
    if gen_config.total_upsampling != a.fft_hop_size:
        raise ValueError(f"generator upsampling {gen_config.total_upsampling} != "
                         f"fft_hop_size {a.fft_hop_size}")
    disc_config = disc_config or DiscriminatorConfig()
    log_dir = Path(log_dir or Path(config.training.logger.save_dir) / "vocoder")
    ckpt_dir = log_dir / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    state = create_vocoder_state(gen_config, disc_config, train_config, device)
    if ft_sd is not None:
        state.gen.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                                   for k, v in ft_sd.items()})
    latest = latest_checkpoint(ckpt_dir) if resume else None
    if latest is not None:
        if finetune_from is not None:
            raise ValueError(
                f"--finetune-from given but {ckpt_dir} already contains checkpoints (would "
                f"resume {latest.name} and discard the finetune initialization). Pass "
                "--no-resume, a fresh log dir, or drop --finetune-from to continue the old run.")
        load_vocoder_training_checkpoint(latest, state)
        print(f"resumed vocoder training from {latest}")
    step_fn = make_vocoder_train_step(gen_config, disc_config, train_config, a)
    loader = VocoderCropLoader(config, train_config, finetune_mel_dir=finetune_mel_dir)
    max_steps = max_steps or train_config.max_steps
    log_path = log_dir / "vocoder_log.jsonl"

    # crops are read and cut on a thread, off the step's path
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def produce():
        batch = None
        while not stop.is_set():
            if batch is None:
                try:
                    batch = loader.next_batch()
                except Exception as e:  # raised again by the loop, which would wait forever
                    batch = e
            try:
                q.put(batch, timeout=0.5)
                batch = None
            except queue.Full:
                continue  # the same batch again; the disk is not read twice

    threading.Thread(target=produce, name="fs2t-vocoder-crops", daemon=True).start()
    tb = SummaryWriter(log_dir)
    preempt = install_preemption_handler()
    t0 = time.time()
    first = saved = state.step
    try:
        while state.step < max_steps:
            if preempt["flag"]:
                print(f"received signal {preempt['signum']}: checkpointing vocoder at step "
                      f"{state.step} and exiting cleanly", flush=True)
                break
            batch = q.get()
            if isinstance(batch, Exception):
                raise batch
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            losses = step_fn(state, batch)
            step = state.step
            if step % train_config.log_steps == 0 or step == 1:
                host = {k: float(v) for k, v in losses.items()}
                sps = (step - first) / max(time.time() - t0, 1e-9)
                print(f"vocoder step {step} d={host['d']:.4f} g={host['g']:.4f} "
                      f"mel_l1={host['mel_l1']:.4f} ({sps:.2f} steps/s)", flush=True)
                with open(log_path, "a") as f:
                    f.write(json.dumps({"step": step, **host, "steps_per_s": sps}) + "\n")
                for k, v in host.items():
                    tb.add_scalar(f"vocoder/{k}", v, step)
                if not all(np.isfinite(v) for v in host.values()):
                    raise RuntimeError(f"non-finite vocoder loss at step {step}: {host}")
            if step % train_config.ckpt_steps == 0 or step >= max_steps:
                save_vocoder_checkpoint(ckpt_dir, state)
                saved = step
    finally:
        stop.set()
        preempt["disarm"]()
        tb.close()
    if saved != state.step or not (ckpt_dir / "vocoder.npz").exists():
        save_vocoder_checkpoint(ckpt_dir, state)
    print(f"vocoder checkpoint: {ckpt_dir / 'vocoder.npz'}", flush=True)
    return state
