#!/usr/bin/env python3
"""How far the vocoder trainer's f32 generator gradients lie from float64 ones,
on the CPU and on a CUDA card (TF32 off).

    python tools/vocoder_grad_precision.py            # on a machine with a card

The generator loss of ``training/vocoder.py`` (LSGAN adversarial + 2 x
feature matching + 45 x mel L1), or its mel L1 alone, at the seeded initial
HiFiGAN V1 and default discriminators, on two seeded 8192-sample crops
(noisy tones). For each precision and device, the three generator
parameters whose gradient lies furthest (rel-L2) from the CPU's float64
gradient. float64 on the card against float64 on the CPU shows that both
devices compute the same function; f32 on either against float64 shows the
rounding a per-parameter comparison of f32 gradients has to allow for. The
log-mel is written out here so that it can run in float64 (the trainer's
``mel_spectrogram_torch`` works in float32, as the JAX trainer's does)."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fastspeech2_lightning_tpu_torch.models.hifigan import HiFiGANConfig  # noqa: E402
from fastspeech2_lightning_tpu_torch.models.hifigan_discriminators import (  # noqa: E402
    DiscriminatorConfig,
    discriminator_forward,
)
from fastspeech2_lightning_tpu_torch.preprocessing.features import (  # noqa: E402
    LOG_CLIP,
    mel_filterbank,
    reflect_pad,
    stft_window,
)
from fastspeech2_lightning_tpu_torch.training import vocoder as tv  # noqa: E402


def log_mel(w: torch.Tensor) -> torch.Tensor:
    """``mel_spectrogram_torch`` at 22.05 kHz, 1024/256, 80 bands, in w's dtype."""
    win = torch.as_tensor(stft_window(1024, 1024), dtype=w.dtype, device=w.device)
    fb = torch.as_tensor(mel_filterbank(22050, 1024, 80, 0, 8000, False), dtype=w.dtype,
                         device=w.device)
    mag = torch.fft.rfft(reflect_pad(w, 512).unfold(-1, 1024, 256) * win, n=1024, dim=-1).abs()
    return torch.log(torch.clamp(torch.einsum("mf,btf->bmt", fb, mag), min=LOG_CLIP))


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    t = torch.arange(8192, dtype=torch.float64) / 22050.0
    noise = [0.02 * torch.randn(8192, generator=g, dtype=torch.float64) for _ in range(2)]
    wav = torch.stack([0.3 * torch.sin(2 * torch.pi * f * t) + n
                       for f, n in zip((180.0, 250.0), noise)])
    mel = log_mel(wav).transpose(1, 2)[:, :32].float().contiguous()
    state = tv.create_vocoder_state(HiFiGANConfig(), DiscriminatorConfig(),
                                    tv.VocoderTrainingConfig(), device="cpu")

    def grads(dtype, device, mel_only):
        gen, disc = state.gen.to(device, dtype), state.disc.to(device, dtype)
        gen.zero_grad(set_to_none=True)
        disc.requires_grad_(False)
        real = wav.to(device, dtype)
        fake = gen(mel.to(device, dtype), dtype).to(dtype)
        loss = torch.mean(torch.abs(log_mel(fake) - log_mel(real)))
        if not mel_only:
            s_fake, f_fake = discriminator_forward(disc, fake)
            with torch.no_grad():
                _, f_real = discriminator_forward(disc, real)
            adv = sum(torch.mean((s - 1.0) ** 2) for s in s_fake)
            fm = sum(torch.mean(torch.abs(a - b)) for fr, ff in zip(f_real, f_fake)
                     for a, b in zip(fr, ff))
            loss = adv + 2.0 * fm + 45.0 * loss
        loss.backward()
        return {k: p.grad.double().cpu() for k, p in gen.named_parameters()}

    for mel_only in (False, True):
        ref = grads(torch.float64, "cpu", mel_only)
        runs = [("CPU f32", torch.float32, "cpu")]
        if torch.cuda.is_available():
            runs += [("card f64", torch.float64, "cuda"), ("card f32", torch.float32, "cuda")]
        for name, dtype, device in runs:
            got = grads(dtype, device, mel_only)
            rel = {k: float((got[k] - ref[k]).norm() / ref[k].norm()) for k in ref}
            worst = sorted(rel, key=rel.get)[::-1][:3]
            print(f"{'mel L1' if mel_only else 'G loss'}: {name} against CPU f64: "
                  + ", ".join(f"{k} {rel[k]:.3e}" for k in worst), flush=True)


if __name__ == "__main__":
    main()
