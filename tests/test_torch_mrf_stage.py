"""The whole-stage MRF route (``ops/vocoder_resblocks.py mrf_stage``) on the CPU.

- ``mrf_stage_plain``, the plain version of ``csrc/mrf_stage.cu``, reached
  through ``fused_mrf_stage`` on the prepared weights, against the JAX
  package's golden ``_np_reference_stage`` (float64) and its Pallas stage
  (``fused_mrf_stage(..., interpret=True)``) at C 4, 8, 12 and 16 (C 4 and
  12 on zero channels at 8 and 16), T 37, 255, 300 and 1000, kernels
  (3, 7, 11) at dilations (1, 3, 5), in f32: rel-L2 at most 1e-5 (the limit
  of ``test_torch_widths.py``'s even-k stage; the prepared weights are split
  bf16 pairs, 2^-16 from the f32 weights). Stages of other shapes (k 1, an
  even k within the halo, k 65, resblocks of unequal dilation counts)
  against the golden alone: JAX's fused kernel shifts an even k's taps
  otherwise than SAME padding (``test_torch_widths.py``).
- The route of every stage of C 1 to 16 on ``test_torch_widths.py``'s
  dilation sets, for odd and even k, against a direct count of the chain's
  SAME extents: "stage" where the deepest chain reads at most 64 rows to
  either side, "conv" where the gate admits the stage but the chain reaches
  further, "unfused" where the gate refuses it; and the width each runs at.
- ``kernel_channels(8)`` is 8 and the weights of a C 8 stage are prepared
  at 8; ``mrf_stage`` on the CPU is its plain version, raises under
  autograd and on a device without a kernel; bf16 within 2e-2.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.ops import vocoder_resblocks as jax_mrf
from fastspeech2_lightning_tpu_torch.ops import vocoder_resblocks as port_mrf

torch.set_num_threads(2)

KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3
DILATION_SETS = ([tuple(d) for d in itertools.product((1, 2, 3, 5, 7, 9), repeat=3)]
                 + [(d,) for d in range(1, 64)])
REL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_blocks(C, ks, dils, seed):
    """Resblocks in the JAX layout (convs [k, Cin, Cout])."""
    rng = np.random.default_rng(seed)
    blocks = []
    for k, ds in zip(ks, dils):
        p = {}
        for i in range(len(ds)):
            for name in ("convs1", "convs2"):
                p[f"{name}_{i}_w"] = (rng.standard_normal((k, C, C))
                                      / math.sqrt(k * C)).astype(np.float32)
                p[f"{name}_{i}_b"] = (0.1 * rng.standard_normal(C)).astype(np.float32)
        blocks.append(p)
    return blocks


def _port_blocks(blocks):
    """The same resblocks in torch Conv1d layout ([Cout, Cin, k])."""
    out = []
    for p in blocks:
        q = {}
        for key, val in p.items():
            name, i, kind = key.split("_")
            if kind == "w":
                q[f"{name}.{i}.weight"] = torch.from_numpy(val.transpose(2, 1, 0).copy())
            else:
                q[f"{name}.{i}.bias"] = torch.from_numpy(val)
        out.append(q)
    return out


def _port_stage(x, blocks, ks, dils):
    flat = port_mrf.prepare_stage_weights(_port_blocks(blocks), ks, dils, torch.float32)
    return port_mrf.fused_mrf_stage(torch.from_numpy(x), flat, ks, dils).numpy()


CASES = list(itertools.product((4, 8, 12, 16), (37, 255, 300, 1000)))


@pytest.mark.parametrize("C,T", CASES)
def test_plain_stage_matches_jax_golden(C, T):
    assert port_mrf.mrf_route(C, KS, DILS) == "stage"
    blocks = _jax_blocks(C, KS, DILS, seed=C)
    x = np.random.default_rng(T).standard_normal((2, T, C)).astype(np.float32)
    before = port_mrf.mrf_stage.launches
    got = _port_stage(x, blocks, KS, DILS)
    assert port_mrf.mrf_stage.launches == before  # the CPU launches nothing
    assert got.shape == x.shape
    assert _rel(got, jax_mrf._np_reference_stage(x, blocks, KS, DILS)) <= REL


@pytest.mark.parametrize("C,T", CASES)
def test_plain_stage_matches_jax_pallas_stage(C, T):
    blocks = _jax_blocks(C, KS, DILS, seed=C + 1)
    x = np.random.default_rng(T + 1).standard_normal((1, T, C)).astype(np.float32)
    want = np.asarray(jax_mrf.fused_mrf_stage(
        jnp.asarray(x), jax_mrf.prepare_stage_weights(blocks, KS, DILS, jnp.float32),
        KS, DILS, block_t=256, interpret=True))
    assert _rel(_port_stage(x, blocks, KS, DILS), want) <= REL


OTHER_STAGES = [
    ((1, 5), ((1, 2), (3,))),     # k 1 (no reach) beside k 5; unequal dilation counts
    ((4,), ((1, 3, 5),)),         # an even k within the halo
    ((3, 7), ((1, 3, 5, 7), (1, 2))),
    ((13,), ((1, 3),)),           # reach (6 + 6) + (18 + 6) = 36
    ((65,), ((1,),)),             # the widest conv a reach of 64 admits
    ((2,), ((63,),)),             # even k 2: a span of 63 within the halo
]


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("ks,dils", OTHER_STAGES)
def test_plain_stage_of_other_shapes_matches_jax_golden(C, ks, dils):
    assert port_mrf.mrf_route(C, ks, dils) == "stage"
    blocks = _jax_blocks(C, ks, dils, seed=len(ks) * 7 + C)
    x = np.random.default_rng(3).standard_normal((2, 200, C)).astype(np.float32)
    got = _port_stage(x, blocks, ks, dils)
    assert _rel(got, jax_mrf._np_reference_stage(x, blocks, ks, dils)) <= REL


def _direct_reach(ks, dils) -> int:
    """The rows the deepest chain reads to either side of an output row,
    from the taps each conv reads: rows tap * d - (k - 1) * d // 2."""
    reach = 0
    for k, ds in zip(ks, dils):
        before = after = 0
        for d in ds:
            for dd in (d, 1):
                offsets = [tap * dd - (k - 1) * dd // 2 for tap in range(k)]
                before -= min(offsets)
                after += max(offsets)
        reach = max(reach, before, after)
    return reach


def _want_route(C, ks, dils) -> str:
    fused = (jax_mrf.mrf_stage_supported(C, ks, dils)
             and all((k - 1) * max(ds) <= 126 for k, ds in zip(ks, dils)))
    if not fused:
        return "unfused"
    if C <= 16 and _direct_reach(ks, dils) <= 64 and sum(len(d) for d in dils) <= 32:
        return "stage"
    return "conv"


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6, 7, 9, 11, 13])
def test_route_follows_the_chain_reach(k):
    """Stages of one resblock (k, dilations) and of three (k with 3 and 7
    beside it) over every C from 1 to 16."""
    seen = set()
    for ds in DILATION_SETS:
        stages = [((k,), (ds,))]
        if len(ds) == 3:
            stages.append(((3, k, 7), ((1, 3, 5), ds, (1, 2, 3))))
        for ks, dils in stages:
            assert port_mrf.stage_reach(ks, dils) == _direct_reach(ks, dils), (ks, dils)
            for C in range(1, 17):
                route = port_mrf.mrf_route(C, ks, dils)
                assert route == _want_route(C, ks, dils), (C, ks, dils)
                seen.add(route)
                if route != "unfused":
                    want = (8 if C <= 8 else 16) if route == "stage" else 16
                    assert port_mrf.stage_channels(C, ks, dils) == want, (C, ks, dils)
    assert "stage" in seen
    if k % 2:
        assert "conv" not in seen  # an odd k's reach is the gate's own count
    elif k > 2:
        assert "conv" in seen  # an even k can pass the gate and reach further


def test_a_narrow_stage_runs_at_its_own_width():
    assert port_mrf.kernel_channels(8) == 8 and port_mrf.kernel_channels(9) == 16
    assert port_mrf.conv_channels(8) == 16 and port_mrf.KERNEL_CHANNELS == (8, 16, 32, 64, 128)
    blocks = _port_blocks(_jax_blocks(8, KS, DILS, seed=0))
    flat = port_mrf.prepare_stage_weights(blocks, KS, DILS, torch.float32)
    assert [tuple(w.shape) for w in flat[:4]] == [(2, 3, 8, 8), (8,), (2, 3, 8, 8), (8,)]
    assert tuple(flat[-2].shape) == (2, 11, 8, 8)
    bf16 = port_mrf.prepare_stage_weights(blocks, KS, DILS, torch.bfloat16)
    assert tuple(bf16[0].shape) == (3, 8, 8) and bf16[1].dtype == torch.bfloat16
    # an even k whose chain reaches past 64 keeps the per-conv route, at 16
    even = ((4,), ((9, 9, 9, 9, 9),))
    assert port_mrf.mrf_route(8, *even) == "conv"
    even_blocks = _port_blocks(_jax_blocks(8, *even, seed=1))
    assert tuple(port_mrf.prepare_stage_weights(even_blocks, *even, torch.float32)[0].shape) \
        == (2, 4, 16, 16)


def test_even_kernel_stage_past_the_halo_takes_the_conv_chain_on_the_cpu():
    """(4, dilations 9 x 5): the gate counts 50, the chain reads 80 rows to
    one side; the per-conv route (each conv's plain version) still equals
    the golden."""
    ks, dils = (4,), ((9, 9, 9, 9, 9),)
    blocks = _jax_blocks(8, ks, dils, seed=2)
    x = np.random.default_rng(4).standard_normal((1, 300, 8)).astype(np.float32)
    assert _rel(_port_stage(x, blocks, ks, dils),
                jax_mrf._np_reference_stage(x, blocks, ks, dils)) <= REL


@pytest.mark.parametrize("C", [8, 16])
def test_mrf_stage_on_the_cpu_is_its_plain_version(C):
    blocks = _port_blocks(_jax_blocks(C, KS, DILS, seed=5))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 150, C)).astype(np.float32))
    for dtype, tol in ((torch.float32, 0.0), (torch.bfloat16, 2e-2)):
        flat = port_mrf.prepare_stage_weights(blocks, KS, DILS, dtype)
        got = port_mrf.mrf_stage(x.to(dtype), flat, KS, DILS)
        assert got.dtype == dtype and got.shape == x.shape
        want = port_mrf.mrf_stage_plain(x.to(dtype).float(), flat, KS, DILS)
        assert _rel(got.float(), want) <= tol
        ref_blocks = [{n: w.to(dtype).float() for n, w in p.items()} for p in blocks]
        assert _rel(got.float(), port_mrf.mrf_stage_reference(
            x.to(dtype).float(), ref_blocks, KS, DILS)) <= (1e-5 if tol == 0 else tol)


@pytest.mark.parametrize("grad_of", ["x", "weight"])
def test_mrf_stage_refuses_autograd(grad_of):
    blocks = _port_blocks(_jax_blocks(16, KS, DILS, seed=7))
    x = torch.randn(1, 40, 16, generator=torch.Generator().manual_seed(1))
    flat = port_mrf.prepare_stage_weights(blocks, KS, DILS, torch.float32)
    (x if grad_of == "x" else flat[0]).requires_grad_(True)
    for fn in (port_mrf.mrf_stage, port_mrf.fused_mrf_stage):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x, flat, KS, DILS)
    with torch.no_grad():
        assert not port_mrf.mrf_stage(x, flat, KS, DILS).requires_grad


def test_mrf_stage_raises_on_a_device_without_kernel():
    x = torch.empty(1, 64, 16, device="meta")
    flat = [torch.empty(2, k, 16, 16, device="meta", dtype=torch.bfloat16) if i % 2 == 0
            else torch.empty(16, device="meta")
            for k in KS for i in range(12)]
    with pytest.raises(ValueError, match="unsupported device"):
        port_mrf.mrf_stage(x, flat, KS, DILS)
