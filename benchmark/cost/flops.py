"""Operations and bytes, counted from shapes: what each model and kernel
needs for its inputs, whatever implements it.

A product of an [n, a] and an [a, b] matrix counts 2 n a b operations; a
conv counts 2 (output positions) (output channels) (input channels per
group) (kernel taps). Model counts take the real lengths of each item (its
text's symbols and its frames), not the padding a batch adds; a training
step counts three times its forward (the forward, and the backward's two
products a forward product). The kernels' bounds follow PERF.md's kernel
table: attention over the keys the mask needs, every input byte read once
and every output byte written once."""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

from .peaks import bound_s

# -- the acoustic model ---------------------------------------------------------


def conformer_layer(n: int, d: int, ff: int, k: int) -> float:
    """One Conformer layer at n positions attending over n keys: two FFNs,
    the q/k/v and output projections, scores and values, the conv module."""
    return 8.0 * n * d * ff + 14.0 * n * d * d + 4.0 * n * n * d + 2.0 * n * d * k


def predictor(n: int, d: int, c: int, k: int, layers: int) -> float:
    """A depthwise-separable variance predictor at n positions."""
    total = 2.0 * n * d * k + 2.0 * n * d * c
    total += (layers - 1) * (2.0 * n * c * k + 2.0 * n * c * c)
    return total + 2.0 * n * c


def alignment(L: int, T: int, d: int, n_mels: int) -> float:
    """The alignment attention's key and query encoders and its scores."""
    keys = 2.0 * L * d * 2 * d * 3 + 2.0 * L * 2 * d * n_mels
    queries = 2.0 * T * n_mels * 2 * n_mels * 3 + 2.0 * T * 2 * n_mels * n_mels \
        + 2.0 * T * n_mels * n_mels
    return keys + queries + 2.0 * T * L * n_mels


def postnet(T: int, n_mels: int, dim: int = 512, k: int = 5) -> float:
    return 2.0 * T * k * (n_mels * dim + 3 * dim * dim + dim * n_mels)


def acoustic_forward(cfg: dict, L: int, T: int, train: bool) -> float:
    """One utterance of L symbols and T frames through the model; `train`
    adds the alignment attention the training forward runs."""
    m = cfg["model"]
    n_mels = cfg["preprocessing"]["audio"]["n_mels"]
    e, dd = m["encoder"], m["decoder"]
    d = e["input_dim"]
    total = e["layers"] * conformer_layer(L, d, e["feedforward_dim"], e["conv_kernel_size"])
    for v in m["variance_predictors"].values():
        total += predictor(L, d, v["input_dim"], v["kernel_size"], v["n_layers"])
    total += dd["layers"] * conformer_layer(T, dd["input_dim"], dd["feedforward_dim"],
                                            dd["conv_kernel_size"])
    total += 2.0 * T * dd["input_dim"] * n_mels
    if m.get("use_postnet", True):
        total += postnet(T, n_mels)
    if train:
        total += alignment(L, T, d, n_mels)
    return total


def acoustic_train_step(cfg: dict, items: Iterable[Tuple[int, int]]) -> float:
    """A training step over real (L, T) items: three forwards' worth."""
    return 3.0 * sum(acoustic_forward(cfg, L, T, train=True) for L, T in items)


# -- the vocoder ------------------------------------------------------------------


def generator(v: dict, frames: int) -> float:
    """HiFiGAN's generator over `frames` mel frames."""
    ch = v["upsample_initial_channel"]
    total = 2.0 * frames * v["n_mels"] * ch * 7
    t = frames
    ks = sum(v["resblock_kernel_sizes"])
    n_dil = len(v["resblock_dilation_sizes"][0])
    convs_a_dilation = 2 if v.get("resblock", "1") == "1" else 1
    for u, k in zip(v["upsample_rates"], v["upsample_kernel_sizes"]):
        cout = ch // 2
        total += 2.0 * t * ch * cout * k  # each input sample reaches k outputs a channel pair
        t *= u
        total += 2.0 * convs_a_dilation * n_dil * t * cout * cout * ks
        ch = cout
    return total + 2.0 * t * ch * 7


def _out_len(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def discriminators(dcfg: dict, batch: int, samples: int) -> float:
    """MPD and MSD forward over `batch` waveforms of `samples` samples."""
    total = 0.0
    for p in dcfg["periods"]:
        h = -(-samples // p)
        cin = 1
        chans = dcfg["mpd_channels"]
        for j, cout in enumerate(chans):
            h = _out_len(h, 5, 3 if j < len(chans) - 1 else 1, 2)
            total += 2.0 * batch * p * h * cout * cin * 5
            cin = cout
        total += 2.0 * batch * p * h * cin * 3
    n = samples
    for s in range(dcfg["n_scales"]):
        if s > 0:
            n = n // 2 + 1
        t, cin = n, 1
        for cout, k, stride, g in zip(dcfg["msd_channels"], dcfg["msd_kernels"],
                                      dcfg["msd_strides"], dcfg["msd_groups"]):
            groups = g if cin % g == 0 and cout % g == 0 else 1
            t = _out_len(t, k, stride, (k - 1) // 2)
            total += 2.0 * batch * t * cout * (cin // groups) * k
            cin = cout
        total += 2.0 * batch * t * cin * 3
    return total


def vocoder_train_step(v: dict, dcfg: dict, batch: int, frames: int, hop: int) -> float:
    """One discriminator update on real and generated crops, then one
    generator update through the updated discriminators: the generator's
    forward and backward (3x), the discriminator update's forward and
    backward on 2B crops (3x of 2B), and the generator update's
    discriminator passes on B generated crops (forward and the backward to
    the input, 2x) and B real ones (forward)."""
    d = discriminators(dcfg, batch, frames * hop)
    return 3.0 * batch * generator(v, frames) + 6.0 * d + 3.0 * d


# -- kernels -------------------------------------------------------------------------


def attention_bounds(B: int, H: int, T: int, dh: int, keys: Sequence[int]) -> Tuple[float, float]:
    """(A's, A′'s) least seconds at (B, H, T, dh) bf16 with item b's mask
    needing its first keys[b] keys: 4 (A) and 10 (A′) T dh a key and head;
    q, k, v, o (and dO, dQ, dK, dV) bytes once, the bias and statistics."""
    n = float(sum(keys)) * H * T * dh
    fwd = bound_s(4.0 * n, 4 * B * H * T * dh * 2 + B * T * 4 + B * H * T * 4, "bfloat16")
    bwd = bound_s(10.0 * n, 8 * B * H * T * dh * 2 + B * T * 4 + 2 * B * H * T * 4, "bfloat16")
    return fwd, bwd


def mas_bound(B: int, T: int, L: int, in_lens, out_lens) -> float:
    """Kernel B: the valid part of the log-attention read once, the path and
    the durations written once whole."""
    valid = sum(int(a) * int(b) for a, b in zip(in_lens, out_lens))
    return bound_s(0.0, 4 * (valid + B * T * L + B * L), "float32")


def ctc_bound(B: int, T: int, L: int, out_lens, with_grad: bool = True) -> float:
    """Kernel C: both chains (alpha and beta) and the gradient at these
    lengths (about ten operations a state and frame a chain)."""
    S = 2 * L + 1
    frames = sum(min(int(t), T) for t in out_lens)
    rows = B * T * S * 4
    chains = bound_s(20.0 * B * T * S, frames * (L + 1) * 4 + 2 * rows + 2 * B * 4, "float32")
    if not with_grad:
        return chains
    grad = bound_s(3.0 * frames * S, 2 * frames * S * 4 + B * T * (L + 1) * 4 + 3 * B * 4,
                   "float32")
    return chains + grad


def mrf_stage_bound(B: int, T: int, C: int, ks: Sequence[int], n_dil: int,
                    weights_bytes: float, act_bytes: int = 4) -> float:
    """One fused MRF stage (every resblock's convs at C channels over T
    samples): its convs' operations at the f32 arithmetic the tensor cores
    give (three bf16 products a multiply-add, 989/3 TFLOP/s), its input read
    and output written once, its weights read once."""
    flops = 3.0 * 2.0 * B * T * C * C * 2 * sum(ks) * n_dil
    return bound_s(flops, 2 * B * T * C * act_bytes + weights_bytes, "bfloat16")


def served_least_seconds(cfg: dict, work) -> float:
    """The least time a served window's work could take on the card: the
    acoustic forward of every row's real symbols and frames at the bf16
    peak, plus the vocoder's generator on every row's real frames at TF32's
    (the f32 vocoder's fastest arithmetic). `work` holds per call its real
    rows' (symbols, frames)."""
    from .peaks import PEAK_FLOPS

    fwd = sum(acoustic_forward(cfg, L, T, train=False) for w in work for L, T in w["items"])
    voc = sum(generator(cfg["vocoder"], T) for w in work for _, T in w["items"])
    return fwd / PEAK_FLOPS["bfloat16"] + voc / PEAK_FLOPS["tf32"]
