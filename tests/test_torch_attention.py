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
through the plain version. No entry refuses a length, with dropout or
without: the mask hash keys on the full (query row, key column). At T <=
65536 its mask equals, cell for cell, the one the hash drew when it packed
(row, col) into 32 bits (a copy of that formula here); past 65536 the cells
that packing aliased draw bits of their own, kept at the rate 1 - p;
``dropout_keep_mask`` draws a block of rows and columns alone, equal to
that block of the whole mask."""

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


class WorkStarted(Exception):
    """Raised by the monkeypatched work: the entry got past its checks."""


@pytest.mark.parametrize("entry", list(DROPOUT_ENTRIES))
def test_dropout_past_65536_keys_reaches_its_work(entry, monkeypatch):
    """p > 0 at T 65537: the mask hash keys on the full (query row, key
    column) (``csrc/common.cuh`` dropout_bits), so no entry refuses the
    length; each goes on to its work (monkeypatched here to stop it)."""
    def work(*args, **kwargs):
        raise WorkStarted

    for name in ("attention_dropout_reference", "attention_bwd_reference", "_mix32"):
        monkeypatch.setattr(attention, name, work)
    T = (1 << 16) + 1
    q = torch.zeros(1, 1, T, 8)
    seed = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(WorkStarted):
        DROPOUT_ENTRIES[entry](q, torch.zeros(1, T), seed)


def test_dropout_past_65536_keys_passes_the_wrappers_checks():
    """The launch's checks pass at T 65537 whatever p (what the kernels do
    there is held on the card, tests/test_torch_kernels.py): no length is
    refused with dropout or without."""
    T = (1 << 16) + 1
    q = torch.zeros(1, 2, T, 64, dtype=torch.bfloat16)
    bias = torch.zeros(1, T)
    strides = attention._check("attention_fwd", q, q, q, bias)
    assert strides == list(q.stride()[:3]) * 3
    assert not hasattr(attention, "check_dropout_length")
    assert attention.dropout_threshold(0.2) > 0


def _old_keep_mask(seed, B, H, rows, cols, p):
    """The keep mask of the hash before it keyed on the full (row, col):
    (row << 16) | col packed into 32 bits, the cells past 65536 wrapping
    onto others."""
    bh = attention._stream_index(B, H, 0, 0, None, None)
    key = attention._mix32((seed & attention._M32) ^ attention._mix32(
        (attention._mul32(bh, 0x9E3779B9) + 0x632BE5AB) & attention._M32))
    cell = ((rows[:, None] << 16) | cols[None, :]) & attention._M32
    bits = attention._mix32(cell[None] ^ key[:, None, None])
    return (bits >= attention.dropout_threshold(p)).view(B, H, len(rows), len(cols))


OLD_HASH_CELLS = {
    "every_cell_T_300": ((0, 300), (0, 300), 300),
    "rows_near_65535": ((65280, 65536), (0, 256), 1 << 16),
    "columns_near_65535": ((0, 256), (65280, 65536), 1 << 16),
    "both_near_65535": ((65400, 65536), (65400, 65536), 1 << 16),
}


@pytest.mark.parametrize("case", list(OLD_HASH_CELLS))
def test_dropout_mask_below_65536_equals_the_old_packing(case):
    """At T <= 65536 the full-(row, col) hash draws the mask the 32-bit
    packing drew: every cell of T 300, and the blocks next to 65535."""
    (r0, r1), (c0, c1), T = OLD_HASH_CELLS[case]
    for seed, p in ((-99, 0.2), (12345, 0.5)):
        got = attention.dropout_keep_mask(seed, 2, 3, T, p, rows=(r0, r1), cols=(c0, c1))
        want = _old_keep_mask(seed, 2, 3, torch.arange(r0, r1), torch.arange(c0, c1), p)
        assert torch.equal(got, want)


def test_dropout_mask_past_65536_draws_the_cells_the_packing_aliased():
    """At T 65600 the rows and columns past 65536, which the 32-bit packing
    folded onto rows and columns below it (row 65536 + i drew row i's
    bits), draw bits of their own: a block past 65536 differs from the
    block it aliased and from the old packing's, and its keep rate is 1 - p
    within 0.01 (about nine standard deviations of the 4 x 64 x 1000 cells'
    binomial)."""
    T, p = 65600, 0.2
    past = attention.dropout_keep_mask(7, 2, 2, T, p, rows=(65536, T), cols=(0, 1000))
    aliased = attention.dropout_keep_mask(7, 2, 2, T, p, rows=(0, 64), cols=(0, 1000))
    old = _old_keep_mask(7, 2, 2, torch.arange(65536, T), torch.arange(0, 1000), p)
    assert torch.equal(old, aliased)  # the old packing wrapped row 65536 + i onto row i
    assert not torch.equal(past, aliased)
    assert abs(float(past.float().mean()) - (1 - p)) <= 0.01
    cols = attention.dropout_keep_mask(7, 2, 2, T, p, rows=(0, 1000), cols=(65536, T))
    assert not torch.equal(cols, _old_keep_mask(7, 2, 2, torch.arange(0, 1000),
                                                torch.arange(65536, T), p))
    assert abs(float(cols.float().mean()) - (1 - p)) <= 0.01


def test_dropout_mask_block_equals_that_block_of_the_whole():
    """``dropout_keep_mask`` with rows and cols draws that block of the
    whole [T, T] mask, at a rank's offsets too; a block outside [0, T]
    raises."""
    whole = attention.dropout_keep_mask(3, 2, 2, 100, 0.3, row_offset=1, heads_total=4)
    block = attention.dropout_keep_mask(3, 2, 2, 100, 0.3, row_offset=1, heads_total=4,
                                        rows=(10, 57), cols=(5, 91))
    assert torch.equal(block, whole[:, :, 10:57, 5:91])
    with pytest.raises(ValueError, match="must lie in"):
        attention.dropout_keep_mask(3, 2, 2, 100, 0.3, rows=(90, 101))
