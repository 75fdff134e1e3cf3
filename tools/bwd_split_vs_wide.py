"""Kernel A′ in bf16 at head dims 192 and 256: the split kernel the C entry
runs there (``attention_bwd_tc_split``) against the wide kernel run as one
column group of the whole head dim (``attention_bwd_tc_wide<dh>``), on the
same inputs, in turns (split, wide, wide, split), device ms a call.

The wide build is ``csrc/attention_bwd.cu`` compiled once more with its C
entry renamed and a new ``attention_bwd`` in front of it that sends bf16
dh 192 and 256 to ``launch_tc_wide<dh>`` (one group) and every other call
to the renamed entry; it goes into ``_build/`` beside the package. Both
builds run through the same wrapper (``ops.attention.attention_bwd``:
padding, the f32 dQ buffer), so only the kernel differs. Also prints
whether the two give the same dK and dV, and dQ's rel-L2 between them.

    python tools/bwd_split_vs_wide.py [--json PATH]
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as c  # noqa: E402
from fastspeech2_lightning_tpu_torch.kernels import build  # noqa: E402
from fastspeech2_lightning_tpu_torch.ops import attention  # noqa: E402

SHAPES = ((16, 2, 2048, 192), (16, 2, 1024, 192), (16, 2, 2048, 256), (16, 2, 1024, 256))
P = 0.2

PARAMS = """int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* o, const void* key_bias, void* kv_end, const void* lse, void* dsum,
    const void* seed, void* dq_acc, void* dk, void* dv, int B, int H, int T_len, int dh,
    long long q_sb, long long q_sh, long long q_st, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st, long long d_sb,
    long long d_sh, long long d_st, long long o_sb, long long o_sh, long long o_st,
    float sm_scale, long long thresh, float keep_scale, int row_offset, int head_offset,
    int heads_total, void* stream"""

ARGS = """dtype, q, k, v, dout, o, key_bias, kv_end, lse, dsum, seed, dq_acc, dk, dv, B, H,
    T_len, dh, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, d_sb, d_sh, d_st, o_sb,
    o_sh, o_st, sm_scale, thresh, keep_scale, row_offset, head_offset, heads_total, stream"""

WIDE_ENTRY = f"""
#define attention_bwd attention_bwd_as_built
#include "attention_bwd.cu"
#undef attention_bwd

extern "C" int attention_bwd({PARAMS}) {{
  if (dtype != fs2::kBFloat16 || (dh != 192 && dh != 256))
    return attention_bwd_as_built({ARGS});
  const Args a{{q, k, v, dout, o, static_cast<const float*>(key_bias),
               static_cast<int*>(kv_end), static_cast<const float*>(lse),
               static_cast<float*>(dsum), static_cast<float*>(dq_acc), dk, dv, B, H,
               T_len, dh, Strides{{q_sb, q_sh, q_st}}, Strides{{k_sb, k_sh, k_st}},
               Strides{{v_sb, v_sh, v_st}}, Strides{{d_sb, d_sh, d_st}},
               Strides{{o_sb, o_sh, o_st}}, sm_scale,
               Dropout{{static_cast<const int*>(seed), static_cast<uint32_t>(thresh), keep_scale,
                       row_offset, head_offset, heads_total}},
               static_cast<cudaStream_t>(stream)}};
  const cudaError_t err = fs2::attn::launch_kv_end(a.bias, B, T_len, a.kv_end, a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool dropout = thresh > 0;
  if (dh == 192) return dropout ? launch_tc_wide<192, true>(a) : launch_tc_wide<192, false>(a);
  return dropout ? launch_tc_wide<256, true>(a) : launch_tc_wide<256, false>(a);
}}
"""


def build_wide() -> tuple:
    """Compile the one-group build: its library (the entry's argtypes set) and
    the ptxas lines of its kernels."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "attention_bwd_one_group.cu"
    lib = build.BUILD_DIR / "attention_bwd_one_group.so"
    src.write_text(WIDE_ENTRY)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(lib),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    ptxas, keep = [], False
    for x in proc.stderr.splitlines():
        if "Compiling entry function" in x:
            keep = "attention_bwd_tc_wide" in x
        if keep:
            ptxas.append(x.strip())
    out = ctypes.CDLL(str(lib))
    out.error_string.argtypes = [ctypes.c_int]
    out.error_string.restype = ctypes.c_char_p
    out.attention_bwd.argtypes = attention._BWD_ARGTYPES
    out.attention_bwd.restype = ctypes.c_int
    return out, ptxas


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", type=Path, help="also write the rows here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    split_lib = build.load("attention_bwd", attention._BWD_ENTRIES)
    wide_lib, ptxas = build_wide()
    libs = {"split": split_lib, "wide": wide_lib}
    g = torch.Generator(device="cuda").manual_seed(20)
    seed = torch.tensor([2020], dtype=torch.int32, device="cuda")
    rows = []
    for B, H, T, dh in SHAPES:
        bias, _ = c._ragged_bias(B, T, g)
        q, k, v, do = (torch.randn(B, H, T, dh, device="cuda", generator=g)
                       .to(torch.bfloat16) for _ in range(4))
        scale = 1.0 / math.sqrt(dh)
        out, lse = attention.attention_fwd(q, k, v, bias, scale, p=P, seed=seed, with_lse=True)

        def bwd():
            return attention.attention_bwd(q, k, v, bias, seed, P, scale, out, lse, do)

        times, grads = {"split": [], "wide": []}, {}
        for name in ("split", "wide", "wide", "split"):
            build._libs["attention_bwd"] = libs[name]
            grads[name] = bwd()
            times[name].append(c.device_ms(bwd))
        build._libs["attention_bwd"] = split_lib
        (dq_s, dk_s, dv_s), (dq_w, dk_w, dv_w) = grads["split"], grads["wide"]
        row = dict(shape=[B, H, T, dh], p=P, split_ms=times["split"], wide_ms=times["wide"],
                   wide_over_split=sum(times["wide"]) / sum(times["split"]),
                   dk_equal=bool(torch.equal(dk_s, dk_w)), dv_equal=bool(torch.equal(dv_s, dv_w)),
                   dq_rel_l2=float(torch.linalg.vector_norm(dq_w.float() - dq_s.float())
                                   / torch.linalg.vector_norm(dq_s.float())))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, do, out, lse, grads
        torch.cuda.empty_cache()
    result = dict(card=card, ptxas_one_group=ptxas, rows=rows)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
