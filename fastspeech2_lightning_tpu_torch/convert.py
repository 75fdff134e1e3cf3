"""Weight bridge: JAX parameter pytrees -> the port's torch state_dicts.

``state_dict_from_jax`` is the port's own copy of the mapping in the JAX
package's ``models/torch_export.py:34-243``: flax (params, batch_stats,
constants) -> the reference/torchaudio state_dict layout the port's modules
are named after (the global style tokens and the phonological-feature input
layer included), so the result loads with ``load_state_dict(strict=True)``.
``train_state_from_jax`` adds the optimizer's moments and count and the EMA
weights, so a JAX run continues in the port. ``hifigan_state_from_jax`` is
the inverse of ``models/hifigan.py::load_torch_hifigan`` and
``hifigan_state_to_jax`` its own inverse (what the port's ``vocoder.npz``
holds); ``discriminators_from_jax`` maps the vocoder trainer's MPD and MSD.
All take nested dicts of array-likes (numpy arrays, or anything
``np.asarray`` reads) and return numpy arrays."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _lin(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = _f32(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = _f32(p["bias"])


def _ln(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _conv1d(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = np.transpose(_f32(p["kernel"]), (2, 1, 0))
    if "bias" in p:
        out[f"{prefix}.bias"] = _f32(p["bias"])


def _bn(out: dict, prefix: str, p: dict, s: Optional[dict]) -> None:
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])
    n = _f32(p["scale"]).shape[0]
    out[f"{prefix}.running_mean"] = _f32(s["mean"] if s else np.zeros(n))
    out[f"{prefix}.running_var"] = _f32(s["var"] if s else np.ones(n))
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _conformer_layer(out: dict, prefix: str, p: dict, s: dict) -> None:
    def ffn(tp, fp):
        _ln(out, f"{tp}.sequential.0", fp["norm"])
        _lin(out, f"{tp}.sequential.1", fp["linear1"])
        _lin(out, f"{tp}.sequential.4", fp["linear2"])

    ffn(f"{prefix}.ffn1", p["ffn1"])
    _ln(out, f"{prefix}.self_attn_layer_norm", p["attn"]["norm"])
    out[f"{prefix}.self_attn.in_proj_weight"] = _f32(p["attn"]["qkv"]["kernel"]).T
    out[f"{prefix}.self_attn.in_proj_bias"] = _f32(p["attn"]["qkv"]["bias"])
    _lin(out, f"{prefix}.self_attn.out_proj", p["attn"]["out"])
    cm = f"{prefix}.conv_module"
    conv = p["conv"]
    _ln(out, f"{cm}.layer_norm", conv["norm"])
    # pointwise convs are Dense in the flax tree: kernel [in, out] -> [out, in, 1]
    out[f"{cm}.sequential.0.weight"] = _f32(conv["pointwise1"]["kernel"]).T[:, :, None]
    out[f"{cm}.sequential.0.bias"] = _f32(conv["pointwise1"]["bias"])
    out[f"{cm}.sequential.2.weight"] = np.transpose(_f32(conv["depthwise"]["kernel"]), (2, 1, 0))
    out[f"{cm}.sequential.2.bias"] = _f32(conv["depthwise"]["bias"])
    _bn(out, f"{cm}.sequential.3", conv["bn"], s.get("conv", {}).get("bn"))
    out[f"{cm}.sequential.5.weight"] = _f32(conv["pointwise2"]["kernel"]).T[:, :, None]
    out[f"{cm}.sequential.5.bias"] = _f32(conv["pointwise2"]["bias"])
    ffn(f"{prefix}.ffn2", p["ffn2"])
    _ln(out, f"{prefix}.final_layer_norm", p["final_norm"])


def _variance_predictor(out: dict, prefix: str, p: dict, depthwise: bool) -> None:
    i = 0
    while f"conv_{i}" in p:
        layer = p[f"conv_{i}"]
        lp = f"{prefix}.conv.{i}.layers"
        if depthwise:
            dsc = layer["DepthwiseSeparableConv1d_0"]
            _conv1d(out, f"{lp}.0.module.model.0", dsc["depthwise"])
            _conv1d(out, f"{lp}.0.module.model.1", dsc["pointwise"])
        else:
            _conv1d(out, f"{lp}.0.module", layer["Conv_0"])
        _ln(out, f"{lp}.2", layer["LayerNorm_0"])
        i += 1
    _lin(out, f"{prefix}.linear", p["linear"])


def _conv_attention(out: dict, prefix: str, p: dict) -> None:
    _conv1d(out, f"{prefix}.key_proj.0.conv", p["key_proj_0"]["Conv_0"])
    _conv1d(out, f"{prefix}.key_proj.2.conv", p["key_proj_1"]["Conv_0"])
    _conv1d(out, f"{prefix}.query_proj.0.conv", p["query_proj_0"]["Conv_0"])
    _conv1d(out, f"{prefix}.query_proj.2.conv", p["query_proj_1"]["Conv_0"])
    _conv1d(out, f"{prefix}.query_proj.4.conv", p["query_proj_2"]["Conv_0"])


def _gru(out: dict, prefix: str, p: dict) -> None:
    """flax GRUCell gates (ir, iz, in with biases; hr, hz without; hn with)
    -> torch GRU layer 0: the r and z biases go whole into ``bias_ih_l0`` and
    ``bias_hh_l0`` holds zeros there (``torch_export.py:118-133``)."""
    out[f"{prefix}.weight_ih_l0"] = np.concatenate(
        [_f32(p[g]["kernel"]).T for g in ("ir", "iz", "in")])
    out[f"{prefix}.weight_hh_l0"] = np.concatenate(
        [_f32(p[g]["kernel"]).T for g in ("hr", "hz", "hn")])
    H = _f32(p["hr"]["kernel"]).shape[0]
    out[f"{prefix}.bias_ih_l0"] = np.concatenate([_f32(p[g]["bias"]) for g in ("ir", "iz", "in")])
    out[f"{prefix}.bias_hh_l0"] = np.concatenate(
        [np.zeros(2 * H, np.float32), _f32(p["hn"]["bias"])])


def _gst(out: dict, prefix: str, p: dict, s: dict) -> None:
    """The style encoder (``torch_export.py:136-148``): conv kernels [kh, kw,
    in, out] -> [out, in, kh, kw], BatchNorms with their statistics."""
    ref_p, ref_s = p["ref_enc"], s.get("ref_enc", {})
    i = 0
    while f"conv_{i}" in ref_p:
        out[f"{prefix}.ref_enc.convs.{3 * i}.weight"] = np.ascontiguousarray(
            np.transpose(_f32(ref_p[f"conv_{i}"]["kernel"]), (3, 2, 0, 1)))
        _bn(out, f"{prefix}.ref_enc.convs.{3 * i + 1}", ref_p[f"bn_{i}"], ref_s.get(f"bn_{i}"))
        i += 1
    _gru(out, f"{prefix}.ref_enc.gru", ref_p["gru"])
    stl = p["stl"]
    out[f"{prefix}.stl.gst_embs"] = _f32(stl["gst_embs"])
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        _lin(out, f"{prefix}.stl.mha.{name}", stl[name])


def state_dict_from_jax(
    params: dict,
    batch_stats: Optional[dict],
    constants: Optional[dict],
    config,
    stats=None,
) -> Dict[str, np.ndarray]:
    """flax (params, batch_stats, constants) -> reference state_dict (numpy).

    Pitch/energy bins come from the 'constants' collection when present and
    from ``np.linspace`` over the stats' normalized range otherwise, as the
    JAX exporter writes them."""
    mcfg = config.model
    batch_stats = batch_stats or {}
    sd: Dict[str, np.ndarray] = {}

    tl = params["text_input_layer"]
    if "embedding" in tl:
        sd["text_input_layer.weight"] = _f32(tl["embedding"])
    else:  # phonological features: the bias-free Linear's kernel [in, out]
        sd["text_input_layer.weight"] = _f32(tl["kernel"]).T
    d = mcfg.encoder.input_dim
    sd["position_embedding.inv_freq"] = (
        1.0 / (10000.0 ** (np.arange(0.0, d, 2.0, dtype=np.float32) / d))
    ).astype(np.float32)

    for name, n_layers in (("encoder", mcfg.encoder.layers), ("decoder", mcfg.decoder.layers)):
        for i in range(n_layers):
            _conformer_layer(
                sd, f"{name}.conformer_layers.{i}", params[name][f"layer_{i}"],
                (batch_stats.get(name) or {}).get(f"layer_{i}", {}),
            )

    va = params["variance_adaptor"]
    vp = mcfg.variance_predictors
    for name, cfgv in (("duration", vp.duration), ("pitch", vp.pitch), ("energy", vp.energy)):
        _variance_predictor(
            sd, f"variance_adaptor.{name}_predictor", va[f"{name}_predictor"], cfgv.depthwise
        )
    sd["variance_adaptor.pitch_embedding.weight"] = _f32(va["pitch_embedding"]["embedding"])
    sd["variance_adaptor.energy_embedding.weight"] = _f32(va["energy_embedding"]["embedding"])
    cva = (constants or {}).get("variance_adaptor", {})
    for name, cfgv, st in (("pitch", vp.pitch, getattr(stats, "pitch", None)),
                           ("energy", vp.energy, getattr(stats, "energy", None))):
        if f"{name}_bins" in cva:
            sd[f"variance_adaptor.{name}_bins"] = _f32(cva[f"{name}_bins"])
        elif st is not None:
            sd[f"variance_adaptor.{name}_bins"] = np.linspace(
                st.norm_min, st.norm_max, cfgv.n_bins - 1, dtype=np.float32
            )
    if mcfg.learn_alignment:
        _conv_attention(sd, "variance_adaptor.attention", va["attention"])

    _lin(sd, "mel_linear", params["mel_linear"])
    if mcfg.use_postnet:
        pn = params["postnet"]
        pn_s = batch_stats.get("postnet", {})
        for i in range(5):
            _conv1d(sd, f"postnet.convolutions.{i}.0.conv", pn[f"conv_{i}"])
            _bn(sd, f"postnet.convolutions.{i}.1", pn[f"bn_{i}"], pn_s.get(f"bn_{i}"))
    if mcfg.multispeaker and "speaker_embedding" in params:
        sd["speaker_embedding.weight"] = _f32(params["speaker_embedding"]["embedding"])
    if mcfg.multilingual and "language_embedding" in params:
        sd["language_embedding.weight"] = _f32(params["language_embedding"]["embedding"])
    if mcfg.use_global_style_token_module and "gst" in params:
        _gst(sd, "gst", params["gst"], batch_stats.get("gst", {}))
    return sd


def hifigan_state_from_jax(params: dict, config) -> Dict[str, np.ndarray]:
    """JAX HiFiGAN generator pytree -> torch HiFiGAN state_dict (numpy):
    conv [K, Cin, Cout] -> [Cout, Cin, K], transposed conv [K, Cin, Cout] ->
    [Cin, Cout, K], ``res_{i}_{j}`` -> ``resblocks.{i * n + j}``."""
    sd: Dict[str, np.ndarray] = {}

    def conv(prefix, w, b):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(np.transpose(_f32(w), (2, 1, 0)))
        sd[f"{prefix}.bias"] = _f32(b)

    conv("conv_pre", params["conv_pre_w"], params["conv_pre_b"])
    n = len(config.resblock_kernel_sizes)
    for i in range(len(config.upsample_rates)):
        sd[f"ups.{i}.weight"] = np.ascontiguousarray(
            np.transpose(_f32(params[f"up_{i}_w"]), (1, 2, 0))
        )
        sd[f"ups.{i}.bias"] = _f32(params[f"up_{i}_b"])
        for j in range(n):
            block = params[f"res_{i}_{j}"]
            r = i * n + j
            for di in range(len(config.resblock_dilation_sizes[j])):
                if config.resblock == "1":
                    conv(f"resblocks.{r}.convs1.{di}", block[f"convs1_{di}_w"],
                         block[f"convs1_{di}_b"])
                    conv(f"resblocks.{r}.convs2.{di}", block[f"convs2_{di}_w"],
                         block[f"convs2_{di}_b"])
                else:
                    conv(f"resblocks.{r}.convs.{di}", block[f"convs_{di}_w"],
                         block[f"convs_{di}_b"])
    conv("conv_post", params["conv_post_w"], params["conv_post_b"])
    return sd


_BUFFER_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked", ".inv_freq",
                    "_bins")


def _parameters_only(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: v for k, v in sd.items() if not k.endswith(_BUFFER_SUFFIXES)}


def train_state_from_jax(
    params: dict,
    mu: dict,
    nu: dict,
    count,
    ema_params: Optional[dict],
    batch_stats: Optional[dict],
    constants: Optional[dict],
    config,
    stats=None,
):
    """A JAX TrainState's numpy trees -> (state_dict, train_state), so a run
    of the JAX package continues in the port: the state_dict as
    ``state_dict_from_jax`` gives it, and ``train_state.pt``'s content (the
    optax Adam moments `mu` and `nu` and update `count`, the EMA weights)
    keyed by parameter name. Moments and EMA are parameter-shaped trees and
    take the parameters' layout change."""
    sd = state_dict_from_jax(params, batch_stats, constants, config, stats)

    def by_name(tree):
        return _parameters_only(state_dict_from_jax(tree, None, None, config))

    train_state = {
        "mu": by_name(mu),
        "nu": by_name(nu),
        "count": int(np.asarray(count)),
        "ema": None if ema_params is None else by_name(ema_params),
    }
    return sd, train_state


def hifigan_state_to_jax(sd: Dict[str, np.ndarray], config) -> dict:
    """The inverse of ``hifigan_state_from_jax``: a torch HiFiGAN state_dict
    (weight norm folded) -> the JAX package's generator pytree, numpy f32
    leaves, the ``params`` of its ``vocoder.npz``."""
    sd = {k: _f32(v.detach().float().cpu() if hasattr(v, "detach") else v)
          for k, v in sd.items()}

    def conv(prefix):
        return (np.ascontiguousarray(np.transpose(sd[f"{prefix}.weight"], (2, 1, 0))),
                sd[f"{prefix}.bias"])

    params: dict = {}
    params["conv_pre_w"], params["conv_pre_b"] = conv("conv_pre")
    n = len(config.resblock_kernel_sizes)
    for i in range(len(config.upsample_rates)):
        params[f"up_{i}_w"] = np.ascontiguousarray(
            np.transpose(sd[f"ups.{i}.weight"], (2, 0, 1)))
        params[f"up_{i}_b"] = sd[f"ups.{i}.bias"]
        for j in range(n):
            block: dict = {}
            r = i * n + j
            names = ("convs1", "convs2") if config.resblock == "1" else ("convs",)
            for di in range(len(config.resblock_dilation_sizes[j])):
                for name in names:
                    block[f"{name}_{di}_w"], block[f"{name}_{di}_b"] = conv(
                        f"resblocks.{r}.{name}.{di}")
            params[f"res_{i}_{j}"] = block
    params["conv_post_w"], params["conv_post_b"] = conv("conv_post")
    return params


def discriminators_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """The JAX package's discriminator tree (``{"mpd": [...], "msd": [...]}``
    of ``{"layers": [{"v", "g", "b"}, ...], "post": {...}}``) -> the
    state_dict of ``models.hifigan_discriminators.Discriminators``: a Conv1d
    ``v`` [K, Cin/g, Cout] -> [Cout, Cin/g, K], a Conv2d ``v``
    [KH, KW, Cin, Cout] -> [Cout, Cin, KH, KW], ``g`` [1, ..., Cout] ->
    [Cout, 1, ...] by the same permutation."""
    sd: Dict[str, np.ndarray] = {}
    for kind in ("mpd", "msd"):
        for i, sub in enumerate(params[kind]):
            convs = [(f"layers.{j}", p) for j, p in enumerate(sub["layers"])]
            for name, p in convs + [("post", sub["post"])]:
                v = _f32(p["v"])
                perm = (2, 1, 0) if v.ndim == 3 else (3, 2, 0, 1)
                prefix = f"{kind}.{i}.{name}"
                sd[f"{prefix}.v"] = np.ascontiguousarray(np.transpose(v, perm))
                sd[f"{prefix}.g"] = np.ascontiguousarray(np.transpose(_f32(p["g"]), perm))
                sd[f"{prefix}.b"] = _f32(p["b"])
    return sd
