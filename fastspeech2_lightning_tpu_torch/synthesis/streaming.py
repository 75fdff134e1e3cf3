"""Low-latency streaming vocoding (counterpart of the JAX package's
``synthesis/streaming.py``).

The acoustic model is non-autoregressive, so the whole mel exists after one
forward; the vocoder is the larger cost per frame. ``windowed_vocode``
vocodes the mel in slices of ``window + 2 * margin`` frames placed so that
each kept window carries `margin` frames of true context on both sides (or
meets the signal's edge), keeps the window's samples and yields them as they
come: the first audio leaves after one slice, and the pieces put together
equal vocoding the whole mel in one call, since `margin` defaults to the
generator's one-sided receptive field. Every slice has one shape.

The mel goes to the vocoder's device once; the slices are views of it, and
only each window's kept samples are copied to the host."""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch


def windowed_vocode(vocoder, mel, window: int = 128,
                    margin: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yield float32 wav segments of `mel` [T, n_mels] (numpy or a tensor)
    in order; put together they equal ``vocoder(mel[None])[0]`` to float
    tolerance. `vocoder` is the port's HiFiGAN function or Griffin-Lim
    vocoder (``device_fn``, ``device``, ``hop``). `margin` defaults to
    ``vocoder.receptive_margin_frames`` (32 where the vocoder has none, as
    Griffin-Lim). A mel of at most window + 2 * margin frames is
    zero-padded to a 32-frame bucket, vocoded in one call and trimmed to
    T * hop samples."""
    if mel.ndim != 2:
        raise ValueError(f"windowed_vocode expects [T, n_mels], got {tuple(mel.shape)}")
    hop = int(vocoder.hop)
    if margin is None:
        margin = int(getattr(vocoder, "receptive_margin_frames", 32))
    T = mel.shape[0]
    W = window + 2 * margin
    mel_t = torch.as_tensor(mel, dtype=torch.float32, device=vocoder.device)

    def run(mel_slice: torch.Tensor) -> torch.Tensor:
        return vocoder.device_fn(mel_slice[None])[0]

    def host(wav: torch.Tensor) -> np.ndarray:
        return wav.float().cpu().numpy()

    if T <= W:
        # a short mel: one call at a 32-frame bucket, so short lengths share
        # a few shapes (the batched wav path buckets the same way); the last
        # `margin` frames see the zero padding, as in bucketed serving
        Tb = min(W, 32 * -(-T // 32))
        if Tb > T:
            mel_t = torch.cat([mel_t, mel_t.new_zeros((Tb - T, mel_t.shape[1]))])
        yield host(run(mel_t)[: T * hop])
        return

    for start in range(0, T, window):
        end = min(start + window, T)
        # the slice lies inside the signal: interior windows get `margin`
        # true frames on each side, edge windows meet the signal's edge,
        # which is what the whole-mel convolution sees there
        lo = min(max(start - margin, 0), T - W)
        wav = run(mel_t[lo: lo + W])
        yield host(wav[(start - lo) * hop: (end - lo) * hop])
