"""The PyTorch port's HiFiGAN path (models/hifigan.py, ops/vocoder_resblocks.py)
against the JAX package on the same random weights.

``mrf_stage_reference`` is the plain version of a stage of the CUDA kernels
``csrc/mrf_stage.cu`` and ``csrc/mrf_conv.cu``: it must equal the JAX
Pallas MRF stage (``fused_mrf_stage(..., interpret=True)``) and its numpy
golden in f32 within relative 1e-5. The generator, with fused=False and
fused=True (the stage wrapper's CPU path: ``mrf_stage_plain`` for a stage of
C <= 16, 18 plain-version convs for a wider one), must equal the
JAX generator within max-abs 1e-5, and the port's .npz/.pt loading must give
the weights the JAX loader gives. The kernel itself is held against the
plain version on the card by tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models import hifigan as jax_hifigan
from fastspeech2_lightning_tpu.ops.vocoder_resblocks import (
    _np_reference_stage,
    fused_mrf_stage as jax_fused_mrf_stage,
    prepare_stage_weights as jax_prepare_stage_weights,
)
from fastspeech2_lightning_tpu.testing import dataclass_to_dict
from fastspeech2_lightning_tpu_torch.convert import hifigan_state_from_jax
from fastspeech2_lightning_tpu_torch.models import hifigan as port_hifigan
from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import (
    fused_mrf_stage,
    mrf_conv,
    mrf_stage,
    mrf_stage_reference,
    prepare_stage_weights,
)

torch.set_num_threads(2)

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3


def _stage_params(C, seed=0):
    """One V1 stage's resblocks in the JAX layout (convs [K, Cin, Cout])."""
    rng = np.random.default_rng(seed)
    blocks = []
    for k, dils in zip(KS, DILS):
        p = {}
        for i in range(len(dils)):
            for name in ("convs1", "convs2"):
                p[f"{name}_{i}_w"] = (rng.standard_normal((k, C, C)) * 0.1).astype(np.float32)
                p[f"{name}_{i}_b"] = (rng.standard_normal(C) * 0.1).astype(np.float32)
        blocks.append(p)
    return blocks


def _torch_stage_params(blocks):
    """JAX-layout resblocks -> torch layout (``convs1.{i}.weight`` [Cout, Cin, K])."""
    out = []
    for p in blocks:
        q = {}
        for key, val in p.items():
            name, i, kind = key.split("_")
            if kind == "w":
                q[f"{name}.{i}.weight"] = torch.as_tensor(np.transpose(val, (2, 1, 0)).copy())
            else:
                q[f"{name}.{i}.bias"] = torch.as_tensor(val)
        out.append(q)
    return out


@pytest.fixture(scope="module")
def stage():
    B, T, C = 2, 300, 16
    x = np.random.default_rng(1).standard_normal((B, T, C)).astype(np.float32)
    blocks = _stage_params(C)
    return x, blocks, _torch_stage_params(blocks)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def test_stage_reference_matches_jax_pallas_stage(stage):
    x, blocks, tblocks = stage
    flat = jax_prepare_stage_weights(blocks, KS, DILS, jnp.float32)
    want = jax_fused_mrf_stage(jnp.asarray(x), flat, KS, DILS, block_t=256, interpret=True)
    got = mrf_stage_reference(torch.as_tensor(x), tblocks, KS, DILS)
    assert _rel(got.numpy(), want) <= 1e-5


def test_stage_reference_matches_numpy_golden(stage):
    x, blocks, tblocks = stage
    want = _np_reference_stage(x, blocks, KS, DILS)
    got = mrf_stage_reference(torch.as_tensor(x), tblocks, KS, DILS)
    assert _rel(got.numpy(), want) <= 1e-5


def test_stage_wrapper_cpu_path_matches_reference(stage):
    """fused_mrf_stage on CPU tensors at C 16, the whole-stage route: the
    plain version of the one-launch kernel (``mrf_stage_plain``), which
    counts no launches."""
    x, _, tblocks = stage
    before = mrf_conv.launches, mrf_stage.launches
    flat = prepare_stage_weights(tblocks, KS, DILS, torch.float32)
    assert len(flat) == 4 * 9
    got = fused_mrf_stage(torch.as_tensor(x), flat, KS, DILS)
    assert (mrf_conv.launches, mrf_stage.launches) == before
    want = mrf_stage_reference(torch.as_tensor(x), tblocks, KS, DILS)
    assert _rel(got.numpy(), want.numpy()) <= 1e-5


GEN_CONFIG = dict(
    upsample_rates=(8, 8, 2, 2),
    upsample_kernel_sizes=(16, 16, 4, 4),
    upsample_initial_channel=32,
    n_mels=20,
)


@pytest.fixture(scope="module")
def generator():
    """A V1-shaped generator at narrow width (stage channels 16/8/4/2), its
    weights from the JAX package's init, and the JAX output on a mel whose
    stages 1-3 reach T >= 256 (the fused gate)."""
    cfg = jax_hifigan.HiFiGANConfig(**GEN_CONFIG)
    params = jax_hifigan.init_random_hifigan(cfg, seed=3)
    # the init's 0.02 scale keeps activations near zero; widen it so the
    # comparison sees non-trivial values
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 3.0, params)
    mel = np.random.default_rng(4).standard_normal((2, 40, 20)).astype(np.float32)
    want = np.asarray(jax_hifigan.hifigan_generator(params, jnp.asarray(mel), cfg))
    return cfg, params, mel, want


@pytest.mark.parametrize("fused", [False, True])
def test_generator_matches_jax(generator, fused):
    jcfg, params, mel, want = generator
    cfg = port_hifigan.HiFiGANConfig(**GEN_CONFIG)
    sd = {k: torch.as_tensor(v) for k, v in hifigan_state_from_jax(params, cfg).items()}
    got = port_hifigan.hifigan_generator(sd, torch.as_tensor(mel), cfg, fused=fused)
    assert got.shape == want.shape == (2, 40 * 256)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_generator_fused_stage_at_a_kernel_width_matches_jax(monkeypatch):
    """Every stage of this generator passes the gate (C <= 128; JAX's), and
    those of 256 frames or more are fused: C = 32 at 320 frames on the
    per-conv kernel's route, C 16 at 2560 and C 8 at 5120 on the
    whole-stage kernel's at their own widths, and C 4 at 10240, which runs
    at 8 with zero channels. Each goes through ``fused_mrf_stage`` (on the
    CPU, the route's plain version on the prepared bf16 weight pairs) and
    the whole must still equal the JAX generator."""
    kw = dict(GEN_CONFIG, upsample_initial_channel=64)
    jcfg = jax_hifigan.HiFiGANConfig(**kw)
    params = jax_hifigan.init_random_hifigan(jcfg, seed=6)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 3.0, params)
    mel = np.random.default_rng(7).standard_normal((1, 40, 20)).astype(np.float32)
    want = np.asarray(jax_hifigan.hifigan_generator(params, jnp.asarray(mel), jcfg))
    cfg = port_hifigan.HiFiGANConfig(**kw)
    sd = {k: torch.as_tensor(v) for k, v in hifigan_state_from_jax(params, cfg).items()}
    fused_shapes = []

    def counting(x, *args):
        fused_shapes.append(tuple(x.shape))
        return fused_mrf_stage(x, *args)

    monkeypatch.setattr(port_hifigan, "fused_mrf_stage", counting)
    got = port_hifigan.hifigan_generator(sd, torch.as_tensor(mel), cfg, fused=True)
    assert fused_shapes == [(1, 320, 32), (1, 2560, 16), (1, 5120, 8), (1, 10240, 4)]
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_receptive_margin_matches_jax():
    for kw in (GEN_CONFIG, {}):
        assert (port_hifigan.HiFiGANConfig(**kw).receptive_margin_frames
                == jax_hifigan.HiFiGANConfig(**kw).receptive_margin_frames)


# jik876/hifi-gan's config_v3.json layout (resblock "2": one dilated conv a
# dilation, no second conv) at a narrow width
V3_CONFIG = dict(
    resblock="2",
    upsample_rates=(8, 8, 4),
    upsample_kernel_sizes=(16, 16, 8),
    upsample_initial_channel=32,
    resblock_kernel_sizes=(3, 5, 7),
    resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)),
    n_mels=20,
)


@pytest.fixture(scope="module")
def generator_v3():
    """A resblock-2 generator (V3's layout, stage channels 16/8/4): the JAX
    init's conv_pre, upsampling and conv_post weights times 3, and each
    resblock's ``convs_{i}`` drawn here with non-zero biases (the JAX init
    draws the type-1 names only); the JAX output on a mel whose stages reach
    T 320, 2560 and 10240 (past the fused gate's 256)."""
    cfg = jax_hifigan.HiFiGANConfig(**V3_CONFIG)
    params = jax_hifigan.init_random_hifigan(cfg, seed=8)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 3.0, params)
    rng = np.random.default_rng(9)
    ch = cfg.upsample_initial_channel
    for i in range(len(cfg.upsample_rates)):
        ch //= 2
        for j, (k, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                          cfg.resblock_dilation_sizes)):
            block = {}
            for di in range(len(dils)):
                block[f"convs_{di}_w"] = (rng.standard_normal((k, ch, ch)) * 0.1).astype(np.float32)
                block[f"convs_{di}_b"] = (rng.standard_normal(ch) * 0.1).astype(np.float32)
            params[f"res_{i}_{j}"] = block
    mel = np.random.default_rng(10).standard_normal((2, 40, 20)).astype(np.float32)
    want = np.asarray(jax_hifigan.hifigan_generator(params, jnp.asarray(mel), cfg))
    return cfg, params, mel, want


@pytest.mark.parametrize("fused", [False, True])
def test_resblock2_generator_matches_jax(generator_v3, fused, monkeypatch):
    """Type "2" through the weight bridge (``resblocks.{r}.convs.{i}``) equals
    the JAX generator at 1e-5, fused or not: JAX fuses type-1 stages only
    (``models/hifigan.py``, ``config.resblock == "1"``), though the first
    stage (C 16, T 320) passes the kernel's gate, so the port routes no
    type-2 stage to ``fused_mrf_stage``."""
    _, params, mel, want = generator_v3
    cfg = port_hifigan.HiFiGANConfig(**V3_CONFIG)
    sd = {k: torch.as_tensor(v) for k, v in hifigan_state_from_jax(params, cfg).items()}
    assert "resblocks.8.convs.1.weight" in sd and not any("convs1" in k for k in sd)
    assert port_hifigan.mrf_stage_supported(16, cfg.resblock_kernel_sizes,
                                            cfg.resblock_dilation_sizes)
    routed = []

    def counting(x, *args):
        routed.append(tuple(x.shape))
        return fused_mrf_stage(x, *args)

    monkeypatch.setattr(port_hifigan, "fused_mrf_stage", counting)
    got = port_hifigan.hifigan_generator(sd, torch.as_tensor(mel), cfg, fused=fused)
    assert routed == []
    assert got.shape == want.shape == (2, 40 * 256)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_resblock2_trainable_generator_and_vocoder_fn_match_jax(generator_v3):
    """The vocoder trainer's ``HiFiGANGenerator`` (its ``convs`` parameters)
    and ``make_vocoder_fn(fused=True)`` on a type-2 state_dict give the JAX
    output at 1e-5."""
    _, params, mel, want = generator_v3
    cfg = port_hifigan.HiFiGANConfig(**V3_CONFIG)
    sd = hifigan_state_from_jax(params, cfg)
    gen = port_hifigan.HiFiGANGenerator(cfg, sd, device="cpu")
    assert {k for k, _ in gen.named_parameters()} == set(sd)
    with torch.no_grad():
        got = gen(torch.as_tensor(mel))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    wav, _ = port_hifigan.make_vocoder_fn(sd, cfg, fused=True, device="cpu")(mel)
    np.testing.assert_allclose(wav, want, rtol=0, atol=1e-5)


def test_resblock2_receptive_margin_matches_jax():
    for kw in (V3_CONFIG, dict(V3_CONFIG, upsample_rates=(8, 8, 2, 2),
                               upsample_kernel_sizes=(16, 16, 4, 4))):
        margin = port_hifigan.HiFiGANConfig(**kw).receptive_margin_frames
        assert margin == jax_hifigan.HiFiGANConfig(**kw).receptive_margin_frames
    # a type-2 stage's convs reach (k - 1) / 2 * d, not type 1's twice-applied reach
    assert (port_hifigan.HiFiGANConfig(**V3_CONFIG).receptive_margin_frames
            < port_hifigan.HiFiGANConfig(**dict(V3_CONFIG, resblock="1"))
            .receptive_margin_frames)


def test_npz_loading_matches_jax_loader(generator, tmp_path):
    jcfg, params, mel, want = generator
    path = tmp_path / "voc.npz"
    np.savez(path, params=np.array(params, dtype=object),
             config=np.array(dataclass_to_dict(jcfg), dtype=object), global_step=5)
    jparams, jcfg2, jstep = jax_hifigan.load_vocoder_params(path)
    sd, cfg, step = port_hifigan.load_vocoder_params(path)
    assert step == jstep == 5
    assert dataclass_to_dict(cfg) == dataclass_to_dict(jcfg2)
    ref = hifigan_state_from_jax(jparams, cfg)
    assert set(sd) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)
    voc = port_hifigan.make_vocoder_fn(sd, cfg, device="cpu")
    wav, sr = voc(mel)
    assert sr == 22050 and voc.hop == 256
    np.testing.assert_allclose(wav, want, rtol=0, atol=1e-5)


def test_torch_checkpoint_with_weight_norm_matches_jax_loader(generator, tmp_path):
    """A torch HiFiGAN .pt with weight-norm (g, v) pairs folds to the weights
    the JAX loader folds to."""
    jcfg, params, _, _ = generator
    cfg = port_hifigan.HiFiGANConfig(**GEN_CONFIG)
    sd = hifigan_state_from_jax(params, cfg)
    rng = np.random.default_rng(5)
    wn = {}
    for k, v in sd.items():
        if k.endswith(".weight") and k.startswith("resblocks."):
            prefix = k[: -len(".weight")]
            g = rng.uniform(0.5, 1.5, (v.shape[0], 1, 1)).astype(np.float32)
            wn[f"{prefix}.weight_g"] = torch.as_tensor(g)
            wn[f"{prefix}.weight_v"] = torch.as_tensor(v)
        else:
            wn[k] = torch.as_tensor(v)
    path = tmp_path / "voc.pt"
    torch.save({"generator": wn}, path)
    jparams, _, _ = jax_hifigan.load_vocoder_params(path)
    got, _, _ = port_hifigan.load_vocoder_params(path)
    ref = hifigan_state_from_jax(jparams, cfg)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=0, err_msg=k)
