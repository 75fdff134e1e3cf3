"""The PyTorch port's training step against the JAX package's, on the CPU.

From identical weights (the JAX init, carried by ``state_dict_from_jax``),
with every dropout at 0 and no PostNet (its 0.5 dropout has no switch), at
epoch 50 so the binarization loss is on, three steps of the port's
``train_step`` and of JAX ``make_train_step`` on the same ragged batch, with
a zero-weight fill row and EMA on: MAS durations equal, every loss,
``grad_norm``, every parameter, running statistic and EMA tensor within
max-abs 1e-4. Clip, AdamW, Noam and freeze_components against the optax
chain on random trees. In bf16 two steps give finite losses; with dropout
on, the same seed gives identical parameters twice."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models import FastSpeech2 as JFastSpeech2
from fastspeech2_lightning_tpu.training.state import create_train_state, make_optimizer
from fastspeech2_lightning_tpu.training.step import make_train_step
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.convert import state_dict_from_jax
from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_lightning_tpu_torch.training.state import (
    AdamWNoam,
    noam_lr,
)
from fastspeech2_lightning_tpu_torch.training.step import (
    batch_to_device,
    step_generator,
    train_step,
)

from helpers import synthetic_batch, tiny_config, tiny_stats

torch.set_num_threads(2)
N_SYMBOLS = 30
EPOCH = 50
ATOL = 1e-4
LR = 1e-3
# The key third of each in_proj_bias, and the depthwise conv bias that a
# BatchNorm with batch statistics follows (and so that BatchNorm's running
# mean), have a gradient that is zero in exact arithmetic. Adam turns its
# float noise into steps of up to about the learning rate, different in the
# two frameworks, so those entries are held to 2 x 3 steps x LR.
NOISE_ATOL = 6 * LR


def _no_dropout_config(**model):
    cfg = tiny_config(dtype="float32", use_postnet=False, **model)
    for conf in (cfg.model.encoder, cfg.model.decoder):
        conf.dropout = 0.0
    vp = cfg.model.variance_predictors
    for conf in (vp.pitch, vp.energy, vp.duration):
        conf.dropout = 0.0
    cfg.training.ema_decay = 0.9
    cfg.training.optimizer.warmup_steps = 1  # LR from the first step
    cfg.training.optimizer.learning_rate = LR
    return cfg


def _batch(seed=0):
    batch = synthetic_batch(np.random.default_rng(seed), B=3, L=12, T=48)
    batch["sample_weight"] = np.array([1.0, 1.0, 0.0], np.float32)
    return batch


def _port_state(jstate, jcfg, stats):
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                             jax.tree_util.tree_map(np.asarray, jstate.batch_stats),
                             jax.tree_util.tree_map(np.asarray, jstate.constants), jcfg, stats)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_run():
    cfg, stats = _no_dropout_config(), tiny_stats()
    model = JFastSpeech2(config=cfg, stats=stats, n_symbols=N_SYMBOLS)
    batch = _batch()
    state = create_train_state(cfg, model, jax.random.PRNGKey(0), batch)
    vp = cfg.model.variance_predictors
    state = state.replace(constants={"variance_adaptor": {
        "pitch_bins": jnp.linspace(stats.pitch.norm_min, stats.pitch.norm_max,
                                   vp.pitch.n_bins - 1),
        "energy_bins": jnp.linspace(stats.energy.norm_min, stats.energy.norm_max,
                                    vp.energy.n_bins - 1),
    }})
    start = _port_state(state, cfg, stats)
    out = model.apply({"params": state.params, "batch_stats": state.batch_stats,
                       "constants": state.constants}, batch, deterministic=False,
                      rngs={"dropout": jax.random.PRNGKey(9)}, mutable=["batch_stats"])[0]
    durations = np.asarray(out["duration_target"])
    step = make_train_step(cfg, model)
    losses = []
    for _ in range(3):
        state, l = step(state, batch, jax.random.PRNGKey(1), EPOCH)
        losses.append({k: float(v) for k, v in l.items()})
    ema = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.ema_params),
                              None, None, cfg, stats)
    return dict(cfg=cfg, start=start, durations=durations, losses=losses,
                end=_port_state(state, cfg, stats), ema=ema)


def _port_model(jcfg, state_dict):
    cfg = FastSpeech2Config.from_dict(jcfg.model_checkpoint_dump())
    model = FastSpeech2(cfg, n_symbols=N_SYMBOLS)
    model.load_state_dict(state_dict, strict=True)
    return cfg, model


def test_three_train_steps_match_jax(jax_run):
    cfg, model = _port_model(jax_run["cfg"], jax_run["start"])
    db = batch_to_device(_batch(), "cpu")
    out = copy.deepcopy(model).forward_train(db, step_generator(0, 0, "cpu"))
    np.testing.assert_array_equal(out["duration_target"].numpy(), jax_run["durations"])
    params = list(model.named_parameters())
    opt = AdamWNoam(params, cfg.training)
    ema = [p.detach().clone() for _, p in params]
    for k, want in enumerate(jax_run["losses"]):
        got = train_step(model, opt, cfg, db, k, EPOCH, ema)
        assert set(got) == set(want)
        for name, value in want.items():
            assert abs(float(got[name]) - value) <= ATOL, (k, name, float(got[name]), value)
    assert jax_run["losses"][0]["attn_bin"] > 0
    for name, value in model.state_dict().items():
        _assert_close(name, value, jax_run["end"][name])
    for (name, _), e in zip(params, ema):
        _assert_close(name, e, torch.from_numpy(jax_run["ema"][name]))


def _assert_close(name, got, want):
    err = (got.float() - want.float()).abs()
    if name.endswith("in_proj_bias"):
        d = err.shape[0] // 3
        assert float(err[d: 2 * d].max()) <= NOISE_ATOL, name
        err = torch.cat([err[:d], err[2 * d:]])
    noisy = (".conv_module.sequential.2.bias", ".conv_module.sequential.3.running_mean")
    limit = NOISE_ATOL if name.endswith(noisy) else ATOL
    assert float(err.max()) <= limit, (name, float(err.max()))


def test_optimizer_matches_the_optax_chain_with_freezing():
    cfg = tiny_config()
    cfg.training.optimizer.warmup_steps = 2
    cfg.training.freeze_components = ["decoder"]
    cfg.training.gradient_clip_val = 0.5
    rng = np.random.default_rng(3)
    tree = {"encoder": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                        "b": rng.standard_normal(3).astype(np.float32)},
            "decoder": {"w": rng.standard_normal((2, 5)).astype(np.float32)}}
    tx = make_optimizer(cfg, fused=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(jparams)
    named = [(f"{top}.{leaf}", torch.nn.Parameter(torch.from_numpy(v.copy())))
             for top, sub in tree.items() for leaf, v in sub.items()]
    opt = AdamWNoam(named, FastSpeech2Config.from_dict(cfg.model_checkpoint_dump()).training)
    for step in range(5):
        scale = 0.1 if step % 2 else 3.0  # clipped and unclipped steps
        grads = jax.tree_util.tree_map(
            lambda v: (rng.standard_normal(v.shape) * scale).astype(np.float32), tree)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                                       jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        norm = opt.step([torch.from_numpy(grads[n.split(".")[0]][n.split(".")[1]])
                         for n, _ in named])
        np.testing.assert_allclose(float(norm), float(jnp.sqrt(sum(
            jnp.sum(jnp.asarray(g) ** 2) for g in jax.tree_util.tree_leaves(grads)))),
            rtol=1e-6)
        for name, p in named:
            top, leaf = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[top][leaf]),
                                       rtol=0, atol=1e-6)
    np.testing.assert_array_equal(named[2][1].detach().numpy(), tree["decoder"]["w"])
    cfg.training.freeze_components = ["decoderr"]
    with pytest.raises(ValueError, match="not found"):
        AdamWNoam(named, FastSpeech2Config.from_dict(cfg.model_checkpoint_dump()).training)
    assert noam_lr(1e-3, 1000, 0) == noam_lr(1e-3, 1000, 1) == pytest.approx(1e-6)
    assert noam_lr(1e-3, 2, 4) == pytest.approx(1e-3 * 2 ** 0.5 * 4 ** -0.5)


def _port_training_model(dtype, dropout):
    jcfg = tiny_config(dtype=dtype) if dropout else _no_dropout_config()
    if not dropout:
        jcfg.model.dtype = dtype
    cfg = FastSpeech2Config.from_dict(jcfg.model_checkpoint_dump())
    torch.manual_seed(0)
    model = FastSpeech2(cfg, n_symbols=N_SYMBOLS)
    with torch.no_grad():
        for kind in ("pitch", "energy"):
            getattr(model.variance_adaptor, f"{kind}_bins").copy_(torch.linspace(-2, 2, 15))
    return cfg, model


def test_bf16_steps_give_finite_losses():
    cfg, model = _port_training_model("bfloat16", dropout=True)
    opt = AdamWNoam(list(model.named_parameters()), cfg.training)
    db = batch_to_device(_batch(1), "cpu")
    for k in range(2):
        losses = train_step(model, opt, cfg, db, k, EPOCH)
        assert all(torch.isfinite(v) for v in losses.values()), losses


def test_same_seed_with_dropout_gives_identical_parameters():
    results = []
    for _ in range(2):
        cfg, model = _port_training_model("float32", dropout=True)
        opt = AdamWNoam(list(model.named_parameters()), cfg.training)
        db = batch_to_device(_batch(2), "cpu")
        for k in range(2):
            train_step(model, opt, cfg, db, k, EPOCH)
        results.append({k: v.clone() for k, v in model.state_dict().items()})
    for name, value in results[0].items():
        assert torch.equal(value, results[1][name]), name
    gen_a, gen_b = step_generator(0, 1, "cpu"), step_generator(0, 2, "cpu")
    assert not torch.equal(torch.rand(8, generator=gen_a), torch.rand(8, generator=gen_b))
