"""The PyTorch port's attention (ops/attention.py) against the JAX package.

``attention_reference`` is the plain version of the CUDA kernel
``csrc/attention_fwd.cu``: it must equal the JAX Pallas kernel
``attention_with_dropout`` at p = 0 (run in interpret mode, as
tests/test_attention_dropout.py runs it) and the eval conformer's einsum
path (``models/conformer.py:177-186``), in f32 within max-abs 1e-5 (the
two sum in different orders). The kernel itself is held against this plain
version on the card by tests/test_torch_kernels.py.

``attention_fwd`` runs the op ``fs2t::attention_fwd``: it passes
``torch.library.opcheck`` on the CPU at p 0 and p > 0, with and without the
log-sum-exp; its fake gives the kernel's strides; ``count_flops`` of an eval
Conformer counts it once, at its formula, for the same total as the plain
version's products; and the training Function's gradients equal autograd
through the plain version. With dropout (p > 0) every entry refuses T
past 65536 before any work (the mask hash packs (row, col) into 32 bits);
at p 0 the launch's checks take any T."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.ops.attention_dropout import NEG_INF, attention_with_dropout
from fastspeech2_lightning_tpu_torch.ops import attention
from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd, attention_reference

torch.set_num_threads(2)

CASES = [(37, 64), (37, 128), (160, 64), (160, 128)]


def _inputs(T, dh, B=3, H=2, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(3))
    lens = np.array([T, T - 11, 5])[:B]  # ragged key masks
    key_bias = np.where(np.arange(T)[None, :] < lens[:, None], 0.0, NEG_INF).astype(np.float32)
    return q, k, v, key_bias


def _einsum_path(q, k, v, key_bias):
    """The JAX eval conformer's non-flash attention (conformer.py:177-186) on
    [B, H, T, dh] inputs."""
    dh = q.shape[-1]
    qt, kt, vt = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v))
    scores = jnp.einsum("bqhd,bkhd->bhqk", qt, kt, preferred_element_type=jnp.float32)
    scores = scores / jnp.sqrt(dh)
    weights = jax.nn.softmax(scores + jnp.asarray(key_bias)[:, None, None, :], axis=-1)
    out = jnp.einsum("bhqk,bkhd->bqhd", weights.astype(vt.dtype), vt)
    return np.asarray(out.transpose(0, 2, 1, 3))


def _port(q, k, v, key_bias):
    t = [torch.as_tensor(a) for a in (q, k, v, key_bias)]
    return attention_reference(*t, 1.0 / np.sqrt(q.shape[-1])).numpy()


@pytest.mark.parametrize("T,dh", CASES)
def test_reference_matches_jax_kernel_p0(T, dh):
    q, k, v, key_bias = _inputs(T, dh)
    want = attention_with_dropout(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(key_bias),
        jnp.asarray([7], jnp.int32), 0.0, float(1.0 / np.sqrt(dh)),
    )
    np.testing.assert_allclose(_port(q, k, v, key_bias), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("T,dh", CASES)
def test_reference_matches_jax_einsum_path(T, dh):
    q, k, v, key_bias = _inputs(T, dh, seed=1)
    np.testing.assert_allclose(
        _port(q, k, v, key_bias), _einsum_path(q, k, v, key_bias), rtol=0, atol=1e-5
    )


def test_all_masked_row_is_uniform_average():
    """A batch row whose keys are all masked averages V uniformly, as the
    -1e9 bias gives in f32 (the kernel keeps the same finite bias)."""
    q, k, v, key_bias = _inputs(40, 64, B=2)
    key_bias[1] = NEG_INF
    got = _port(q, k, v, key_bias)
    np.testing.assert_allclose(
        got[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True), got[1].shape), atol=1e-5
    )
    np.testing.assert_allclose(got, _einsum_path(q, k, v, key_bias), atol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v, key_bias = _inputs(37, 64)
    before = attention_fwd.launches
    t = [torch.as_tensor(a) for a in (q, k, v, key_bias)]
    out = attention_fwd(*t, 0.125)
    assert attention_fwd.launches == before
    np.testing.assert_array_equal(out.numpy(), attention_reference(*t, 0.125).numpy())


# -- kernel A as the op fs2t::attention_fwd ---------------------------------------


def _op_args(p, with_lse, T=37, dh=64):
    q, k, v, key_bias = (torch.as_tensor(a) for a in _inputs(T, dh, seed=2))
    seed = torch.tensor([11], dtype=torch.int32) if p > 0 else None
    return q, k, v, key_bias, 1.0 / np.sqrt(dh), p, seed, with_lse


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_op_passes_opcheck_on_the_cpu(p, with_lse):
    torch.library.opcheck(torch.ops.fs2t.attention_fwd.default, _op_args(p, with_lse))


@pytest.mark.parametrize("with_lse", [False, True])
def test_fake_strides_equal_the_real_ones(with_lse):
    """The fake gives the kernel's layout: o [B, T, H, dh] in memory, lse
    [B, H, T] f32 (empty when not asked for); the CPU implementation copies
    its result into the same layout."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _op_args(0.2, with_lse)
    real = torch.ops.fs2t.attention_fwd(*args)
    with FakeTensorMode() as mode:
        fake = torch.ops.fs2t.attention_fwd(
            *(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    B, H, T, dh = args[0].shape
    assert real[0].stride() == fake[0].stride() == (T * H * dh, dh, H * dh, 1)
    assert real[1].shape == fake[1].shape == ((B, H, T) if with_lse else (0,))
    assert real[1].stride() == fake[1].stride() and real[1].dtype == fake[1].dtype
    o = attention_fwd(*args[:4], args[4], p=0.2, seed=args[6])
    np.testing.assert_array_equal(o.numpy(), real[0].numpy())


def test_count_flops_of_the_eval_forward_is_unchanged(monkeypatch):
    """The op is counted once, at its formula, where the plain version's two
    products were counted before it was an op; the total is the same."""
    from torch.utils.flop_counter import FlopCounterMode

    from fastspeech2_lightning_tpu_torch.models import conformer
    from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd_flops
    from fastspeech2_lightning_tpu_torch.utils.benchmarking import count_flops

    torch.manual_seed(0)
    B, T, d, H, layers = 2, 40, 64, 2, 2
    block = conformer.Conformer(d, layers, H, 128, 3).eval()
    x = torch.randn(B, T, d)
    mask = torch.arange(T)[None] < torch.tensor([[T], [25]])
    with torch.no_grad():
        with FlopCounterMode(display=False) as counter:
            block(x, mask)
        via_op = count_flops(block, x, mask)
        share = counter.get_flop_counts()["Global"][torch.ops.fs2t.attention_fwd]
        assert share == layers * attention_fwd_flops(B, H, T, d // H)
        monkeypatch.setattr(conformer, "attention_fwd", attention_reference)
        before = count_flops(block, x, mask)
    assert via_op == before > share


@pytest.mark.parametrize("p", [0.0, 0.2])
def test_attention_function_gradients_are_unchanged(p):
    """The training Function's forward reaches A through the op; on CPU
    tensors its gradients equal autograd through the plain version."""
    from fastspeech2_lightning_tpu_torch.ops.attention import (
        _AttentionWithDropout,
        attention_dropout_reference,
    )

    q, k, v, key_bias, scale, _, _, _ = _op_args(p, False)
    seed = torch.tensor([5], dtype=torch.int32)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    grads = []
    for fn in (_AttentionWithDropout.apply, attention_dropout_reference):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, key_bias, seed, p, scale)
        grads.append([g.numpy() for g in torch.autograd.grad(out, leaves, do)])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


DROPOUT_ENTRIES = {
    "attention_fwd": lambda q, b, s: attention.attention_fwd(q, q, q, b, 0.125, p=0.2, seed=s),
    "attention_with_dropout": lambda q, b, s: attention.attention_with_dropout(
        q, q, q, b, s, 0.2, 0.125),
    "attention_bwd": lambda q, b, s: attention.attention_bwd(
        q, q, q, b, s, 0.2, 0.125, q, torch.zeros(q.shape[:3]), q),
    "dropout_keep_mask": lambda q, b, s: attention.dropout_keep_mask(3, 1, 1, q.shape[2], 0.2),
}


@pytest.mark.parametrize("entry", list(DROPOUT_ENTRIES))
def test_dropout_past_65536_keys_raises_before_any_work(entry, monkeypatch):
    """p > 0 at T 65537: the mask hash packs (query row, key column) into 32
    bits (``csrc/common.cuh`` dropout_bits), so every entry refuses before it
    computes anything, with a message that names the limit and its cause."""
    def no_work(*args, **kwargs):
        raise AssertionError("work started")

    for name in ("attention_dropout_reference", "attention_bwd_reference", "_mix32"):
        monkeypatch.setattr(attention, name, no_work)
    T = (1 << 16) + 1
    q = torch.zeros(1, 1, T, 8)
    seed = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"T <= 65536: its mask hashes \(query row, key column\) "
                                         r"packed into 32 bits; T = 65537"):
        DROPOUT_ENTRIES[entry](q, torch.zeros(1, T), seed)


def test_no_dropout_past_65536_keys_passes_the_wrappers_checks():
    """At p 0 no bit is drawn, so T is not bounded: the launch's checks pass
    at T 65537 (what the kernels do there is held on the card,
    tests/test_torch_kernels.py), and the refusal starts at p > 0 above 65536
    keys only."""
    T = (1 << 16) + 1
    q = torch.zeros(1, 2, T, 64, dtype=torch.bfloat16)
    bias = torch.zeros(1, T)
    strides = attention._check("attention_fwd", q, q, q, bias, 0.0)
    assert strides == list(q.stride()[:3]) * 3
    attention.check_dropout_length("attention_fwd", T, 0.0)
    attention.check_dropout_length("attention_fwd", 1 << 16, 0.2)
    with pytest.raises(ValueError, match="T <= 65536"):
        attention._check("attention_fwd", q, q, q, bias, 0.2)
