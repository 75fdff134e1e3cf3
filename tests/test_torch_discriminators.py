"""The PyTorch port's HiFiGAN discriminators (models/hifigan_discriminators.py)
against the JAX package's on the same weights (``discriminators_from_jax``).

Every score and feature map of ``discriminator_forward`` equals JAX's within
rel-L2 1e-5 in f32: at the JAX defaults (its phase-packed and block-diagonal
MSD execution on, which compute the plain grouped conv the port runs), at
crop lengths that the periods divide and that they do not, and where a
group count falls back to 1. In bf16 (parameters cast before the weight
norm, as the JAX trainer casts its tree) the scores agree within rel-L2
2e-2: both sides round to bf16 at different places."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models import hifigan_discriminators as jd
from fastspeech2_lightning_tpu_torch.convert import discriminators_from_jax
from fastspeech2_lightning_tpu_torch.models import hifigan_discriminators as pd

torch.set_num_threads(2)

TINY = dict(periods=(2, 3), mpd_channels=(4, 8), msd_channels=(8, 8, 16),
            msd_groups=(1, 4, 4), msd_strides=(1, 2, 2), msd_kernels=(15, 41, 41), n_scales=2)
# a group count that divides neither channel count falls back to 1
FALLBACK = dict(TINY, msd_channels=(8, 12, 16), msd_groups=(1, 5, 4))
CONFIGS = {"tiny": TINY, "fallback": FALLBACK, "full": {}}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _pair(name: str, seed: int = 0):
    jcfg = jd.DiscriminatorConfig(**CONFIGS[name])
    jparams = jd.init_discriminators(seed, jcfg)
    disc = pd.Discriminators(pd.DiscriminatorConfig(**CONFIGS[name]), device="cpu")
    disc.load_state_dict({k: torch.tensor(v) for k, v in discriminators_from_jax(
        jax.device_get(jparams)).items()}, strict=True)
    return jcfg, jparams, disc


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in CONFIGS}


def _wav(B: int, T: int, seed: int = 1) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal((B, T))).astype(np.float32)


def _channels_last(f: torch.Tensor) -> np.ndarray:
    """Port [B, C, T] / [B, C, H, W] -> the JAX layout [B, T, C] / [B, H, W, C]."""
    return f.detach().float().permute(0, *range(2, f.ndim), 1).numpy()


@pytest.mark.parametrize("kernel", [(5,), (5, 1)], ids=["conv1d", "conv2d"])
def test_weight_norm_identity(kernel):
    """g initialised to |v| gives w = v; doubling g doubles w, as JAX's
    ``_wn_weight`` does on the same v and g."""
    conv = pd.WNConv(8, 3, kernel, torch.Generator().manual_seed(0))
    w, b = conv.weight(torch.float32)
    np.testing.assert_allclose(w.detach().numpy(), conv.v.detach().numpy(), rtol=1e-6)
    assert not b.any()
    with torch.no_grad():
        conv.g.mul_(2.0)
    w2, _ = conv.weight(torch.float32)
    perm = (2, 1, 0) if len(kernel) == 1 else (2, 3, 1, 0)
    jw = jd._wn_weight({"v": jnp.asarray(conv.v.detach().numpy().transpose(perm)),
                        "g": jnp.asarray(conv.g.detach().numpy().transpose(perm))})
    np.testing.assert_allclose(w2.detach().numpy(), 2 * conv.v.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(w2.detach().numpy().transpose(perm), np.asarray(jw), rtol=1e-6)


@pytest.mark.parametrize("name,B,T", [
    ("tiny", 2, 2310),  # 2 * 3 * 5 * 7 * 11: every period divides it
    ("tiny", 2, 2048),  # the periods 3, 5, 7, 11 pad by reflection
    ("fallback", 2, 2047),
    ("full", 1, 2310),
    ("full", 1, 2048),
])
def test_discriminator_forward_matches_jax(pairs, name, B, T):
    jcfg, jparams, disc = pairs[name]
    if name == "full":  # the JAX defaults: its lane-packed MSD execution is on
        assert jcfg.msd_phase_packed and jcfg.msd_block_diag
    wav = _wav(B, T)
    js, jf = jax.jit(lambda p, w: jd.discriminator_forward(p, w, jcfg))(jparams, jnp.asarray(wav))
    with torch.no_grad():
        ps, pf = pd.discriminator_forward(disc, torch.from_numpy(wav))
    n_subs = len(jcfg.periods) + jcfg.n_scales
    assert len(ps) == len(js) == n_subs and len(pf) == len(jf) == n_subs
    for i, (s, j) in enumerate(zip(ps, js)):
        assert tuple(s.shape) == j.shape, (i, s.shape, j.shape)
        assert _rel(s.numpy(), j) <= 1e-5, (i, _rel(s.numpy(), j))
    for i, (fl, jl) in enumerate(zip(pf, jf)):
        assert len(fl) == len(jl)
        for k, (f, j) in enumerate(zip(fl, jl)):
            got = _channels_last(f)
            assert got.shape == j.shape, (i, k, got.shape, j.shape)
            assert _rel(got, j) <= 1e-5, (i, k, _rel(got, j))


def test_msd_groups_fall_back_to_one(pairs):
    cfg = pd.DiscriminatorConfig(**FALLBACK)
    assert [pd.msd_groups(cfg, j, cin) for j, cin in enumerate((1, 8, 12))] == [1, 1, 4]
    jcfg = jd.DiscriminatorConfig(**FALLBACK)
    assert [jd._msd_groups(jcfg, j, cin) for j, cin in enumerate((1, 8, 12))] == [1, 1, 4]
    _, _, disc = pairs["fallback"]
    assert tuple(disc.msd[0].layers[1].v.shape) == (12, 8, 41)


@pytest.mark.parametrize("T", [2048, 4097])
def test_avg_pool_matches_jax(T):
    x = _wav(2, T)
    got = pd.avg_pool1d(torch.from_numpy(x)).numpy()
    want = np.asarray(jd._avg_pool1d(jnp.asarray(x)))
    assert got.shape == want.shape == (2, T // 2 + 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["tiny", "full"])
def test_count_params_matches_jax(pairs, name):
    _, jparams, disc = pairs[name]
    assert pd.count_params(disc) == jd.count_params(jparams)


def test_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(pd.DiscriminatorConfig)] == [
        f.name for f in dataclasses.fields(jd.DiscriminatorConfig)]
    assert dataclasses.asdict(pd.DiscriminatorConfig()) == dataclasses.asdict(
        jd.DiscriminatorConfig())


@pytest.mark.parametrize("name", ["tiny", "full"])
def test_bf16_scores_match_jax_bf16(pairs, name):
    """Both sides cast the parameters to bf16 before the weight norm and the
    waveform to bf16, as the vocoder trainers do."""
    jcfg, jparams, disc = pairs[name]
    wav = _wav(2, 2048, seed=3)
    cast = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jparams)
    js, _ = jax.jit(lambda p, w: jd.discriminator_forward(p, w, jcfg))(
        cast, jnp.asarray(wav, jnp.bfloat16))
    with torch.no_grad():
        ps, _ = pd.discriminator_forward(disc, torch.from_numpy(wav).to(torch.bfloat16))
    for s, j in zip(ps, js):
        assert s.dtype == torch.bfloat16
        assert _rel(s.float().numpy(), np.asarray(j, np.float32)) <= 2e-2
