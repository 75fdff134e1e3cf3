"""The PyTorch port's FastSpeech2 inference forward against the JAX model.

The same random weights (the JAX init, with BatchNorm statistics and the
duration head's bias set from a numpy seed) go through the port's weight
bridge (convert.state_dict_from_jax), which must load strictly, and a
ragged batch goes through both forwards with inference=True,
deterministic=True. In f32: durations and frame counts are exactly equal,
every other output agrees within max-abs 1e-4 (the two frameworks sum in
different orders). In bf16 the outputs are finite and the log-duration
stays within 5e-2 of the JAX bf16 model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models import FastSpeech2 as JaxFastSpeech2
from fastspeech2_lightning_tpu.models.torch_export import export_torch_fastspeech2
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.convert import state_dict_from_jax
from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_lightning_tpu_torch.type_definitions import Stats

from helpers import synthetic_batch, tiny_config, tiny_stats

torch.set_num_threads(2)

N_SYMBOLS = 30
N_SPEAKERS = 3
B, L, T_MAX = 3, 16, 96
CLOSE = ("duration_prediction", "pitch_prediction", "energy_prediction", "output",
         "postnet_output")


def _set_variables(variables, seed):
    """Give the BatchNorm statistics and the duration head non-trivial
    values (the init leaves mean 0, var 1 and a zero bias, which would round
    most durations to 0)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, variables)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree["batch_stats"]):
        name = jax.tree_util.keystr(path)
        value = (rng.uniform(0.5, 1.5, leaf.shape) if name.endswith("['var']")
                 else rng.standard_normal(leaf.shape) * 0.1)
        container = tree["batch_stats"]
        for key in path[:-1]:
            container = container[key.key]
        container[path[-1].key] = value.astype(np.float32)
    tree["params"]["variance_adaptor"]["duration_predictor"]["linear"]["bias"] = np.full(
        (1,), np.log(4.0), np.float32
    )
    return tree


def _build(dtype, multispeaker):
    cfg = tiny_config(dtype=dtype, multispeaker=multispeaker, max_mel_length=T_MAX)
    stats = tiny_stats()
    model = JaxFastSpeech2(config=cfg, stats=stats, n_symbols=N_SYMBOLS,
                           n_speakers=N_SPEAKERS, n_languages=1)
    batch = synthetic_batch(np.random.default_rng(0), B=2, L=12, T=48)
    variables = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}, batch
    )
    variables = _set_variables(dict(variables), seed=3)
    vp = cfg.model.variance_predictors
    variables["constants"] = {"variance_adaptor": {
        "pitch_bins": np.asarray(jnp.linspace(stats.pitch.norm_min, stats.pitch.norm_max,
                                              vp.pitch.n_bins - 1)),
        "energy_bins": np.asarray(jnp.linspace(stats.energy.norm_min, stats.energy.norm_max,
                                               vp.energy.n_bins - 1)),
    }}

    rng = np.random.default_rng(4)
    src_lens = np.array([L, 11, 5], np.int32)
    text = rng.integers(1, N_SYMBOLS, size=(B, L)).astype(np.int32)
    text[np.arange(L)[None, :] >= src_lens[:, None]] = 0
    speaker_id = np.array([0, 2, 1], np.int32)
    jbatch = {"text": text, "src_lens": src_lens, "mel": None, "mel_lens": None,
              "speaker_id": speaker_id, "language_id": np.zeros(B, np.int32)}
    out = jax.jit(lambda v, b: model.apply(v, b, inference=True, deterministic=True,
                                           max_target_len=T_MAX))(variables, jbatch)
    out = {k: np.asarray(v) for k, v in out.items() if v is not None}

    port_cfg = FastSpeech2Config.from_dict(cfg.model_dump(mode="json"))
    port_stats = Stats.from_dict(stats.model_dump())
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"],
                             variables["constants"], port_cfg, port_stats)
    port = FastSpeech2(port_cfg, n_symbols=N_SYMBOLS, n_speakers=N_SPEAKERS).eval()
    missing, unexpected = port.load_state_dict(
        {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}, strict=True
    )
    got = port(torch.as_tensor(text, dtype=torch.int64), torch.as_tensor(src_lens), T_MAX,
               speaker_id=torch.as_tensor(speaker_id, dtype=torch.int64))
    got = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
           for k, v in got.items() if v is not None}
    return dict(cfg=cfg, variables=variables, stats=stats, sd=sd, jax=out, port=got,
                missing=missing, unexpected=unexpected, src_lens=src_lens)


@pytest.fixture(scope="module", params=[False, True], ids=["single", "multispeaker"])
def f32(request):
    return _build("float32", request.param)


@pytest.fixture(scope="module")
def bf16():
    return _build("bfloat16", False)


def test_weight_bridge_loads_strictly_and_matches_the_jax_exporter(f32):
    assert not f32["missing"] and not f32["unexpected"]
    v = f32["variables"]
    want = export_torch_fastspeech2(v["params"], v["batch_stats"], f32["cfg"],
                                    constants=v["constants"], stats=f32["stats"])
    assert set(f32["sd"]) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(f32["sd"][k]), want[k], err_msg=k)


def test_durations_and_lengths_exactly_equal(f32):
    j, p = f32["jax"], f32["port"]
    np.testing.assert_array_equal(p["duration_rounded"], j["duration_rounded"])
    np.testing.assert_array_equal(p["tgt_lens"], j["tgt_lens"])
    np.testing.assert_array_equal(p["src_mask"], j["src_mask"])
    np.testing.assert_array_equal(p["tgt_mask"], j["tgt_mask"])
    # the batch is ragged and the durations are not trivial
    assert (j["duration_rounded"][:, :5] > 0).mean() > 0.5
    assert len(set(j["tgt_lens"].tolist())) == B


@pytest.mark.parametrize("key", CLOSE)
def test_outputs_within_1e_4(f32, key):
    j, p = f32["jax"][key], f32["port"][key]
    assert p.shape == j.shape and p.dtype == np.float32
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-4)


def test_bf16_outputs_finite_and_close_to_jax_bf16(bf16):
    """bf16 rounds at other places in the two frameworks, so a pitch or
    energy prediction near a bin boundary can land in the neighbouring bin
    and change the embedding added before the duration predictor. The
    log-duration is compared where both models chose the same bins within
    the duration predictor's receptive field (2 layers of kernel 3: +-2
    symbols), which must be most symbols; the energy prediction, which no
    bin precedes, is compared everywhere."""
    p, j = bf16["port"], bf16["jax"]
    for key in CLOSE:
        assert np.isfinite(p[key]).all(), key
    valid = bf16["src_lens"][:, None] > np.arange(L)[None, :]
    np.testing.assert_allclose(p["energy_prediction"][valid], j["energy_prediction"][valid],
                               rtol=0, atol=5e-2)
    consts = bf16["variables"]["constants"]["variance_adaptor"]
    same = np.ones_like(valid)
    for key, bins in (("energy_prediction", consts["energy_bins"]),
                      ("pitch_prediction", consts["pitch_bins"])):
        pb, jb = ((np.asarray(bins)[None, None, :] < out[key][..., None]).sum(-1)
                  for out in (p, j))
        same &= pb == jb
    reach = np.ones_like(same)
    for shift in range(-2, 3):
        reach &= np.roll(np.pad(same, ((0, 0), (2, 2)), constant_values=True), shift,
                         axis=1)[:, 2:-2]
    agree = valid & reach
    assert agree.sum() >= 0.6 * valid.sum()
    np.testing.assert_allclose(p["duration_prediction"][agree], j["duration_prediction"][agree],
                               rtol=0, atol=5e-2)
