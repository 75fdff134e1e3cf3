"""The port's data- and tensor-parallel training (``parallel/``) on the CPU:
ranks are spawned processes of a gloo process group
(``parallel.launch.run_local``, one torch thread each), held against the
port's one process on the global batch and against the JAX package's mesh.

- Rank r is data rank r // 2 and model rank r % 2 of a 2 x 2 world, the
  collectives stay in their groups, and ``layout()`` in a group of 2 ranks
  with no layout installed raises.
- The port's parameter rules select exactly the tensors JAX's
  ``param_pspec_tree`` shards, mapped through the reference layout, and a
  state_dict split and gathered again is the one it was.
- The attention dropout mask at a rank's (row, head) offsets, and
  ``fast_dropout`` under a layout, are blocks of the global draws, at the
  data and the model boundaries.
- Synced BatchNorm in its three forms over 2 ranks equals one process on the
  global batch (output, running statistics, input gradient; f32, 1e-6).
- A train step over data=2, model=2 and data=2 x model=2 (4 processes), with
  dropout 0.2 and PostNet on, equals the port's one-process step on the
  global batch: losses, grad norm, every gradient and Adam moment after the
  update, gathered, f32, rtol 1e-5 / atol 1e-6. The steps run at a Noam rate
  of 1e-4, so each update is about a hundred times atol. Each step's update
  (the parameters after it minus before) is held tensor by tensor to one
  process's within rel-L2 1e-3, and the parameters within rtol 1e-5 /
  atol 1e-6, on the elements whose gradient the two runs agree on to 1e-3
  relative (``parallel.launch.settled``): a gradient that is zero to
  rounding (a bias a BatchNorm follows, the key bias) has a sign that
  summation order decides, which Adam turns into a step of the full rate.
  At most 1 % of the elements are left out (0.13-0.34 % here). At dropout 0 the
  2-rank step
  matches JAX ``make_train_step`` on an 8-device ``make_mesh(8)`` within
  ``tests/test_parallel.py``'s tolerances, and the model=2 step JAX's single
  device within the port-vs-JAX tolerance of ``test_torch_train_step.py``
  (1e-4).
- ZeRO-1 (``fused_optimizer``) over 2 data ranks equals the per-parameter
  optimizer, and each rank holds half the moments. A ZeRO-1 that leaves its
  parameters as they were (its moments updated) fails that comparison.

The worker functions import no JAX: spawned ranks import this module by
name. JAX runs in the parent through one module-scoped fixture."""

import math

import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_lightning_tpu_torch.models.layers import BatchNorm1d, fast_dropout
from fastspeech2_lightning_tpu_torch.ops.attention import (
    attention_dropout_reference,
    dropout_keep_mask,
)
from fastspeech2_lightning_tpu_torch.parallel import (
    ParallelLayout,
    batch_rows,
    gather_state_dict,
    make_layout,
    param_rule,
    set_layout,
    shard_model,
    shard_plan,
    shard_state_dict,
    use_layout,
)
from fastspeech2_lightning_tpu_torch.parallel.launch import run_local, settled, update_errors
from fastspeech2_lightning_tpu_torch.parallel.mesh import (
    ShardSpec,
    shard_tensor,
    unshard_tensor,
)
from fastspeech2_lightning_tpu_torch.training.state import (
    AdamWNoam,
    init_like_flax,
    make_optimizer,
)
from fastspeech2_lightning_tpu_torch.training.step import train_step

torch.set_num_threads(2)
N_SYMBOLS = 30
EPOCH = 50  # the binarization loss is on
RTOL, ATOL = 1e-5, 1e-6
UPDATE_RTOL = 1e-3  # rel-L2 of a step's update, tensor by tensor
LEFT_OUT = 1e-2  # the share of elements whose gradient is zero to rounding
TIMEOUT_S = 150.0


# --- the ranks' work (no JAX here) ---

def _model(cfg: FastSpeech2Config, state: dict) -> FastSpeech2:
    model = FastSpeech2(cfg, n_symbols=N_SYMBOLS)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=True)
    return model


def _skip_update(opt):
    """A planted fault: the optimizer updates its moments and leaves the
    parameters as they were."""
    opt._adam = lambda *a: torch.zeros_like(AdamWNoam._adam(opt, *a))


def _train(cfg_dict, state, batch, steps, fault=None):
    """`steps` train steps from `state` on this rank's rows of the global
    `batch` under the installed layout; each step's losses, and the
    gathered parameters, gradients (summed over the data group) and
    moments after it."""
    cfg = FastSpeech2Config.from_dict(cfg_dict)
    model = _model(cfg, state)
    plan = shard_model(model)
    opt = make_optimizer(model, cfg.training)
    if fault == "skip_update":
        _skip_update(opt)
    db = batch_rows({k: torch.from_numpy(v) for k, v in batch.items()})
    out = {"losses": [], "state": [], "grad": [], "mu": [], "nu": []}

    def host(tensors):  # copies: the step after updates these tensors in place
        return {n: t.detach().numpy().copy() for n, t in tensors.items()}

    for k in range(steps):
        got = train_step(model, opt, cfg, db, k, EPOCH)
        out["losses"].append({n: float(v) for n, v in got.items()})
        out["state"].append(host(gather_state_dict(model.state_dict(), plan)))
        out["grad"].append(host(gather_state_dict(
            {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in zip(opt.names, opt.params)}, plan)))
        mu, nu = opt.moments()
        out["mu"].append(host(mu))
        out["nu"].append(host(nu))
    out.update(moment_numel=sum(m.numel() for m in opt.mu), plan=sorted(plan))
    return out


def _train_worker(rank, world, model_parallel, cfg_dict, state, batch, steps, fault=None):
    set_layout(make_layout(model_parallel))
    out = _train(cfg_dict, state, batch, steps, fault)
    # the full state split and gathered again is itself
    plan = shard_plan(_model(FastSpeech2Config.from_dict(cfg_dict), state), model_parallel)
    full = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    back = gather_state_dict(shard_state_dict(full, plan), plan)
    out["roundtrip"] = all(torch.equal(back[k], full[k]) for k in full)
    return out


def _bn_forms(x3, mask, x4, r3, r4):
    """The three batch-statistics forms of BatchNorm1d on these rows: the
    outputs, the running statistics after each, and the input gradients of
    sum(y * r)."""
    out = {}
    for name, x, m, r in (("masked", x3, mask, r3), ("plain", x3, None, r3),
                          ("nhwc", x4, None, r4)):
        torch.manual_seed(0)
        bn = BatchNorm1d(x.shape[-1])
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
        xg = torch.from_numpy(x).requires_grad_(True)
        y = bn(xg, mask=None if m is None else torch.from_numpy(m), use_running_average=False)
        (grad,) = torch.autograd.grad((y * torch.from_numpy(r)).sum(), xg)
        out[name] = {"y": y.detach(), "grad": grad, "mean": bn.running_mean.clone(),
                     "var": bn.running_var.clone()}
    return out


def _collectives_worker(rank, world):
    """The layout of rank `rank` in a (2, 2) world and the collectives over
    its groups."""
    from fastspeech2_lightning_tpu_torch.parallel import (
        all_gather, all_reduce, barrier, broadcast,
    )

    lay = make_layout(2)
    set_layout(lay)
    x = torch.tensor([float(rank)])
    batch = {"text": np.arange(8)[:, None], "names": list("abcdefgh"), "n_real_global": 7}
    out = {"layout": (lay.data_size, lay.data_rank, lay.model_size, lay.model_rank),
           "data_sum": float(all_reduce(x.clone(), lay.data_group)),
           "model_gather": [float(t) for t in all_gather(x, lay.model_group)],
           "from_3": float(broadcast(x.clone(), 3)),
           "rows": batch_rows(batch)}
    barrier()
    return out


def _unset_layout_worker(rank, world):
    """layout() in a group of 2 ranks before any layout is installed."""
    from fastspeech2_lightning_tpu_torch.parallel import layout

    try:
        layout()
    except RuntimeError as e:
        return str(e)
    return None


def _bn_worker(rank, world, x3, mask, x4, r3, r4):
    set_layout(make_layout(1))
    per = x3.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    return _bn_forms(x3[rows], mask[rows], x4[rows], r3[rows], r4[rows])


# --- inputs ---

def _cfg_dict(dropout=0.2, postnet=True, fused=False):
    from helpers import tiny_config

    cfg = tiny_config(dtype="float32", use_postnet=postnet)
    for conf in (cfg.model.encoder, cfg.model.decoder):
        conf.dropout = dropout
    vp = cfg.model.variance_predictors
    for conf in (vp.pitch, vp.energy, vp.duration):
        conf.dropout = dropout
    cfg.training.optimizer.warmup_steps = 10  # the first steps' Noam rate: 1e-4
    d = cfg.model_checkpoint_dump()
    d["training"]["fused_optimizer"] = fused
    return d


def _batch(B=8):
    from helpers import synthetic_batch

    batch = synthetic_batch(np.random.default_rng(0), B=B, L=16, T=32)
    batch["sample_weight"] = np.ones(B, np.float32)
    batch["sample_weight"][-1] = 0.0  # a loader's zero-weight fill row
    return {k: np.asarray(v) for k, v in batch.items() if v is not None}


def _port_init(cfg_dict, seed=0):
    model = FastSpeech2(FastSpeech2Config.from_dict(cfg_dict), n_symbols=N_SYMBOLS)
    init_like_flax(model, seed)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _assert_same_run(got, want, steps, init):
    """Step by step: the losses, then the update (the step's parameters
    minus the previous step's, `init` before the first) on the settled
    elements, then the parameters there, the gradients and the moments."""
    grads = []
    for k in range(steps):
        assert set(got["losses"][k]) == set(want["losses"][k])
        for name, value in want["losses"][k].items():
            assert math.isclose(got["losses"][k][name], value, rel_tol=RTOL, abs_tol=ATOL), \
                (k, name, got["losses"][k][name], value)
        grads.append((got["grad"][k], want["grad"][k]))
        keep = settled(grads)
        before_got = init if k == 0 else got["state"][k - 1]
        before_want = init if k == 0 else want["state"][k - 1]
        u_got = {n: np.asarray(got["state"][k][n], np.float64)
                 - np.asarray(before_got[n], np.float64) for n in keep}
        u_want = {n: np.asarray(want["state"][k][n], np.float64)
                  - np.asarray(before_want[n], np.float64) for n in keep}
        errors = update_errors(u_got, u_want, keep)
        left = sum(e[1] for e in errors.values()) / sum(e[2] for e in errors.values())
        assert left <= LEFT_OUT, f"step {k}: {left:.3g} of the elements left out"
        bad = {n: e for n, e in errors.items() if e[0] > UPDATE_RTOL}
        assert not bad, f"step {k} update rel-L2 above {UPDATE_RTOL}: {bad}"
        for name, k_ in keep.items():
            np.testing.assert_allclose(np.asarray(got["state"][k][name], np.float32)[k_],
                                       np.asarray(want["state"][k][name], np.float32)[k_],
                                       rtol=RTOL, atol=ATOL, err_msg=f"step {k} {name}")
        for part in ("grad", "mu", "nu"):
            for name, value in want[part][k].items():
                np.testing.assert_allclose(np.asarray(got[part][k][name], np.float32),
                                           np.asarray(value, np.float32), rtol=RTOL,
                                           atol=ATOL, err_msg=f"step {k} {part} {name}")


@pytest.fixture(scope="module")
def port_runs():
    """One process and each layout, two steps each, dropout 0.2, PostNet."""
    cfg = _cfg_dict()
    state, batch = _port_init(cfg), _batch()
    runs = {"one": _train(cfg, state, batch, 2), "init": state}
    for name, world, mp in (("data2", 2, 1), ("model2", 2, 2), ("data2_model2", 4, 2)):
        runs[name] = run_local(_train_worker, world, mp, cfg, state, batch, 2,
                               timeout_s=TIMEOUT_S)
    zero = _cfg_dict(fused=True)
    runs["zero"] = run_local(_train_worker, 2, 1, zero, state, batch, 2, timeout_s=TIMEOUT_S)
    runs["zero_skips_update"] = run_local(_train_worker, 2, 1, zero, state, batch, 1,
                                          "skip_update", timeout_s=TIMEOUT_S)
    runs["numel"] = sum(v.size for k, v in state.items() if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked", "_bins", "inv_freq")))
    return runs


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX train step at dropout 0 without PostNet, on one device and on
    the 8-device mesh, from the JAX init; its weights in the reference
    layout; the JAX parameter specs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fastspeech2_lightning_tpu.models import FastSpeech2 as JFastSpeech2
    from fastspeech2_lightning_tpu.parallel import make_mesh, param_pspec_tree, shard_batch
    from fastspeech2_lightning_tpu.training.state import create_train_state
    from fastspeech2_lightning_tpu.training.step import make_train_step
    from fastspeech2_lightning_tpu_torch.convert import state_dict_from_jax
    from helpers import tiny_config, tiny_stats

    cfg = tiny_config(dtype="float32", use_postnet=False)
    for conf in (cfg.model.encoder, cfg.model.decoder):
        conf.dropout = 0.0
    vp = cfg.model.variance_predictors
    for conf in (vp.pitch, vp.energy, vp.duration):
        conf.dropout = 0.0
    stats = tiny_stats()
    model = JFastSpeech2(config=cfg, stats=stats, n_symbols=N_SYMBOLS)
    batch = _batch()

    def fresh():
        state = create_train_state(cfg, model, jax.random.PRNGKey(0), batch)
        return state.replace(constants={"variance_adaptor": {
            "pitch_bins": jnp.linspace(stats.pitch.norm_min, stats.pitch.norm_max,
                                       vp.pitch.n_bins - 1),
            "energy_bins": jnp.linspace(stats.energy.norm_min, stats.energy.norm_max,
                                        vp.energy.n_bins - 1)}})

    state = fresh()
    host = jax.tree_util.tree_map(np.asarray, dict(params=state.params,
                                                   batch_stats=state.batch_stats,
                                                   constants=state.constants))
    sd = state_dict_from_jax(host["params"], host["batch_stats"], host["constants"], cfg, stats)
    specs = param_pspec_tree(state.params)
    marks = jax.tree_util.tree_map(lambda x, s: np.full(x.shape, float(s != P()), np.float32),
                                   host["params"], specs)
    marked = state_dict_from_jax(marks, host["batch_stats"], host["constants"], cfg, stats)
    jax_sharded = {k for k, v in marked.items()
                   if k in sd and np.asarray(v).size and np.all(np.asarray(v) == 1.0)}

    step = make_train_step(cfg, model)
    _, one = step(state, batch, jax.random.PRNGKey(1), EPOCH)
    mesh = make_mesh(8)
    repl = NamedSharding(mesh, P())
    state8 = fresh()
    state8 = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, repl) if hasattr(x, "shape") else x, state8)
    with mesh:
        _, eight = step(state8, shard_batch(batch, mesh), jax.random.PRNGKey(1), EPOCH)
    return dict(cfg=cfg.model_checkpoint_dump(), state=sd, batch=batch,
                one={k: float(v) for k, v in one.items()},
                eight={k: float(v) for k, v in eight.items()}, jax_sharded=jax_sharded)


# --- the layout ---

def test_layout_and_collectives_of_a_two_by_two_world():
    """Rank r is data rank r // 2 and model rank r % 2 (JAX make_mesh's
    reshape(n // mp, mp)); sums, gathers and broadcasts stay in their
    groups; batch_rows gives each data rank its contiguous rows."""
    got = run_local(_collectives_worker, 4, timeout_s=TIMEOUT_S)
    for rank, out in enumerate(got):
        d, m = rank // 2, rank % 2
        assert out["layout"] == (2, d, 2, m)
        assert out["data_sum"] == m + (m + 2)  # ranks m and m + 2
        assert out["model_gather"] == [2 * d, 2 * d + 1]
        assert out["from_3"] == 3.0
        assert out["rows"]["text"].ravel().tolist() == list(range(4 * d, 4 * d + 4))
        assert out["rows"]["names"] == list("abcdefgh")[4 * d:4 * d + 4]
        assert out["rows"]["n_real_global"] == 7
    assert ParallelLayout() == make_layout(1)  # no process group: one process


def test_a_group_without_an_installed_layout_raises():
    """Which ranks split the batch and which the model is the caller's to
    say: layout() does not guess one for a process group."""
    for message in run_local(_unset_layout_worker, 2, timeout_s=TIMEOUT_S):
        assert message and "2 ranks and no layout installed" in message


# --- (a) the rules ---

def test_rules_select_the_tensors_jax_shards(jax_runs):
    model = _model(FastSpeech2Config.from_dict(jax_runs["cfg"]), jax_runs["state"])
    names = {n for n, _ in model.named_parameters()}
    jax_sharded = jax_runs["jax_sharded"] & names  # (running_var is all ones too)
    assert {n for n in names if param_rule(n)} == jax_sharded
    assert set(shard_plan(model, 2)) == jax_sharded
    assert len(jax_sharded) == 2 * 9 + 1  # 2 conformer layers x 9, and the embedding


def test_rules_leave_what_does_not_divide_replicated(jax_runs):
    cfg = FastSpeech2Config.from_dict(jax_runs["cfg"])
    model = _model(cfg, jax_runs["state"])
    assert shard_plan(model, 1) == {}
    three = shard_plan(model, 3)  # 2 heads, FFN 64, d 32: nothing divides by 3
    assert three == {}
    cfg4 = dict(jax_runs["cfg"])
    cfg4["model"] = {**cfg4["model"], "encoder": {**cfg4["model"]["encoder"], "heads": 1}}
    plan = shard_plan(FastSpeech2(FastSpeech2Config.from_dict(cfg4), n_symbols=N_SYMBOLS), 2)
    assert not any(k.startswith("encoder.") and "self_attn" in k for k in plan)
    assert any(k.startswith("encoder.") and "ffn1" in k for k in plan)


@pytest.mark.parametrize("kind,shape", [("rows", (8, 6)), ("cols", (6, 8)),
                                        ("heads", (12, 5)), ("heads", (12,))])
def test_shard_and_unshard_are_inverse(kind, shape):
    full = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    spec = ShardSpec(kind, shape)
    parts = [shard_tensor(full, spec, r, 2) for r in range(2)]
    assert torch.equal(unshard_tensor(parts, spec), full)
    if kind == "heads":  # rank 1 holds the second half of each of q, k, v
        third = shape[0] // 3
        want = torch.cat([full[i * third + third // 2:(i + 1) * third] for i in range(3)])
        assert torch.equal(parts[1], want)


def test_split_and_gathered_state_is_the_full_state(port_runs):
    for name in ("model2", "data2_model2"):
        assert all(r["roundtrip"] for r in port_runs[name])
        assert port_runs[name][0]["plan"] == port_runs[name][1]["plan"] != []


# --- (b) global-row dropout ---

@pytest.mark.parametrize("row_offset,head_offset", [(0, 0), (0, 2), (2, 0), (2, 2)])
def test_keep_mask_at_offsets_is_a_block_of_the_global_mask(row_offset, head_offset):
    whole = dropout_keep_mask(-7, 4, 4, 24, 0.2)
    block = dropout_keep_mask(-7, 2, 2, 24, 0.2, row_offset=row_offset,
                              head_offset=head_offset, heads_total=4)
    assert torch.equal(block, whole[row_offset:row_offset + 2, head_offset:head_offset + 2])
    assert torch.equal(dropout_keep_mask(-7, 4, 4, 24, 0.2, heads_total=4), whole)


def test_attention_at_offsets_is_a_block_of_the_global_attention():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 4, 20, 16, generator=g) for _ in range(3))
    bias = torch.zeros(4, 20)
    bias[1, 15:] = -1e9
    seed = torch.tensor([123], dtype=torch.int32)
    whole = attention_dropout_reference(q, k, v, bias, seed, 0.2, 0.25)
    for r0 in (0, 2):
        for h0 in (0, 2):
            rows, heads = slice(r0, r0 + 2), slice(h0, h0 + 2)
            part = attention_dropout_reference(q[rows, heads], k[rows, heads], v[rows, heads],
                                               bias[rows], seed, 0.2, 0.25, r0, h0, 4)
            torch.testing.assert_close(part, whole[rows, heads], rtol=0, atol=1e-6)


@pytest.mark.parametrize("data_rank,model_rank", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_fast_dropout_of_a_rank_is_its_block_of_the_global_draw(data_rank, model_rank):
    x = torch.randn(4, 5, 12, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(9)
    whole = fast_dropout(x, 0.2, gen)
    whole_rows = fast_dropout(x, 0.5, gen)  # a second draw: the generators stay in step
    lay = ParallelLayout(world_size=4, rank=2 * data_rank + model_rank, data_size=2,
                         data_rank=data_rank, model_size=2, model_rank=model_rank)
    rows, cols = slice(2 * data_rank, 2 * data_rank + 2), slice(6 * model_rank,
                                                                 6 * model_rank + 6)
    gen = torch.Generator().manual_seed(9)
    with use_layout(lay):
        part = fast_dropout(x[rows, :, cols], 0.2, gen, split_cols=True)
        part_rows = fast_dropout(x[rows], 0.5, gen)
    assert torch.equal(part, whole[rows, :, cols])
    assert torch.equal(part_rows, whole_rows[rows])


# --- (c) synced BatchNorm ---

def test_synced_batch_norm_equals_one_process_on_the_global_batch():
    rng = np.random.default_rng(3)
    x3 = rng.standard_normal((4, 7, 6)).astype(np.float32) * 2 + 1
    mask = np.ones((4, 7), bool)
    mask[1, 4:] = mask[3, 2:] = False
    x4 = rng.standard_normal((4, 5, 3, 6)).astype(np.float32)
    r3, r4 = rng.standard_normal(x3.shape).astype(np.float32), \
        rng.standard_normal(x4.shape).astype(np.float32)
    want = _bn_forms(x3, mask, x4, r3, r4)
    got = run_local(_bn_worker, 2, x3, mask, x4, r3, r4, timeout_s=TIMEOUT_S)
    for form, w in want.items():
        for rank, g in enumerate(got):
            rows = slice(2 * rank, 2 * rank + 2)
            for key in ("y", "grad"):
                np.testing.assert_allclose(g[form][key], w[key].numpy()[rows], rtol=0,
                                           atol=1e-6, err_msg=f"{form} {key} rank {rank}")
            for key in ("mean", "var"):
                np.testing.assert_allclose(g[form][key], w[key].numpy(), rtol=0, atol=1e-6,
                                           err_msg=f"{form} {key} rank {rank}")


# --- (d) train steps ---

@pytest.mark.parametrize("layout_name", ["data2", "model2", "data2_model2"])
def test_train_steps_over_ranks_equal_one_process(port_runs, layout_name):
    want = port_runs["one"]
    assert want["losses"][0]["postnet"] > 0 and want["losses"][0]["attn_bin"] > 0
    for got in port_runs[layout_name]:
        _assert_same_run(got, want, 2, port_runs["init"])


def test_two_data_ranks_match_jax_on_the_eight_device_mesh(jax_runs):
    got = run_local(_train_worker, 2, 1, jax_runs["cfg"], jax_runs["state"], jax_runs["batch"],
                    1, timeout_s=TIMEOUT_S)
    for rank in got:
        for k, want in jax_runs["eight"].items():
            rtol = 2e-3 if k == "grad_norm" else 2e-4
            assert math.isclose(rank["losses"][0][k], want, rel_tol=rtol, abs_tol=2e-5), \
                (k, rank["losses"][0][k], want)


def test_two_model_ranks_match_jax_on_one_device(jax_runs):
    got = run_local(_train_worker, 2, 2, jax_runs["cfg"], jax_runs["state"], jax_runs["batch"],
                    1, timeout_s=TIMEOUT_S)
    for rank in got:
        assert rank["plan"]
        for k, want in jax_runs["one"].items():
            assert abs(rank["losses"][0][k] - want) <= 1e-4, (k, rank["losses"][0][k], want)


# --- (e) ZeRO-1 ---

def test_zero1_equals_the_per_parameter_optimizer(port_runs):
    for got, want in zip(port_runs["zero"], port_runs["data2"]):
        _assert_same_run(got, want, 2, port_runs["init"])


def test_zero1_that_skips_its_update_fails_the_comparison(port_runs):
    """The planted fault: moments and gradients as they should be, the
    parameters left as they were. The update comparison fails on it."""
    for got, want in zip(port_runs["zero_skips_update"], port_runs["data2"]):
        with pytest.raises(AssertionError, match="update rel-L2"):
            _assert_same_run(got, want, 1, port_runs["init"])


def test_zero1_holds_half_the_moments_on_each_rank(port_runs):
    n = port_runs["numel"]
    for rank in port_runs["zero"]:
        assert rank["moment_numel"] == -(-n // 2)
    for rank in port_runs["data2"]:
        assert rank["moment_numel"] == n
