"""Global style tokens (GST-Tacotron): the counterpart of the JAX package's
``models/gst.py``.

The reference encoder runs six bias-free 3x3 stride-2 convolutions, each
with a BatchNorm and a ReLU, over the mel as an image [B, 1, T, n_mels]; the
result is flattened frequency-major ([B, T', F' * C], the flax NHWC reshape)
and fed to a GRU whose last step queries a bank of style tokens through
four-head attention. What follows the JAX package exactly, where the
reference's ESPnet encoder may differ:

- the convolutions pad as flax ``padding="SAME"`` does: (0, 1) on an axis of
  even size and (1, 1) on an odd one (a stride-2 kernel-3 window);
- the BatchNorms take flax's semantics (``layers.BatchNorm1d`` over NHWC
  channels, the padded frames included);
- the GRU runs over all T/64 padded steps and the style comes from its last
  step's output.

Parameter names follow the reference state_dict as ``torch_export._gst``
writes it (``ref_enc.convs.{3i, 3i+1}``, ``ref_enc.gru``, ``stl.gst_embs``,
``stl.mha.linear_{q,k,v,out}``). Flax's GRU cell has one bias on each of
the r and z gates where torch's has two (``bias_ih`` + ``bias_hh``), so the
r and z rows of ``bias_hh_l0`` take no gradient: they keep the value they
were loaded with (0 from the JAX exporter), and training updates the same
parameters as the JAX package's. The module computes in float32."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm1d


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """(low, high) padding of flax ``padding="SAME"`` on an axis of `size`:
    ceil(size / stride) outputs, the extra pad at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ReferenceEncoder(nn.Module):
    """[B, T, idim] mel -> [B, gru_units] (``gst.py:19-51``)."""

    def __init__(self, idim: int = 80, conv_layers: int = 6,
                 conv_chans_list: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 conv_kernel_size: int = 3, conv_stride: int = 2, gru_units: int = 128):
        super().__init__()
        self.kernel, self.stride = conv_kernel_size, conv_stride
        layers = []
        cin, f = 1, idim
        for i in range(conv_layers):
            cout = conv_chans_list[i]
            layers += [nn.Conv2d(cin, cout, conv_kernel_size, stride=conv_stride, bias=False),
                       BatchNorm1d(cout), nn.ReLU()]
            cin, f = cout, -(-f // conv_stride)
        self.convs = nn.Sequential(*layers)
        self.gru = nn.GRU(f * cin, gru_units, batch_first=True)
        self._frozen_bias = None  # id of the bias_hh_l0 whose r, z rows are held

    def _hold_summed_biases(self) -> None:
        """Zero the gradient of ``bias_hh_l0``'s r and z rows (registered
        once for each parameter object, so also on a copy of the module)."""
        bias = self.gru.bias_hh_l0
        if self._frozen_bias == id(bias) or not bias.requires_grad:
            return
        n = 2 * self.gru.hidden_size
        bias.register_hook(lambda g: torch.cat([torch.zeros_like(g[:n]), g[n:]]))
        self._frozen_bias = id(bias)

    def forward(self, speech: torch.Tensor, use_running_average: bool = True) -> torch.Tensor:
        if torch.is_grad_enabled():
            self._hold_summed_biases()
        x = speech.to(self.convs[0].weight.dtype)[:, None]  # [B, 1, T, F], in f32
        for i in range(0, len(self.convs), 3):
            conv, bn = self.convs[i], self.convs[i + 1]
            pad_t = same_padding(x.shape[2], self.kernel, self.stride)
            pad_f = same_padding(x.shape[3], self.kernel, self.stride)
            x = conv(F.pad(x, pad_f + pad_t))
            x = bn(x.permute(0, 2, 3, 1), use_running_average=use_running_average)
            x = torch.relu(x).permute(0, 3, 1, 2)
        B, C, T, Fq = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, T, Fq * C)  # frequency-major, as flax's NHWC
        outputs, _ = self.gru(x)
        return outputs[:, -1, :]


class _StyleAttention(nn.Module):
    """Multi-head attention from one query to the tokens (``gst.py:69-81``)."""

    def __init__(self, q_dim: int, kv_dim: int, n_feat: int, heads: int):
        super().__init__()
        self.heads = heads
        self.linear_q = nn.Linear(q_dim, n_feat)
        self.linear_k = nn.Linear(kv_dim, n_feat)
        self.linear_v = nn.Linear(kv_dim, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def forward(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        B, n_feat, h = q.shape[0], self.linear_out.out_features, self.heads
        dk = n_feat // h
        Q = self.linear_q(q).reshape(B, -1, h, dk)
        K = self.linear_k(kv).reshape(B, -1, h, dk)
        V = self.linear_v(kv).reshape(B, -1, h, dk)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", Q, K) / math.sqrt(dk), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, V).reshape(B, -1, n_feat)
        return self.linear_out(out)


class StyleTokenLayer(nn.Module):
    """[B, ref_embed_dim] -> [B, gst_token_dim]: attention over tanh of the
    learned tokens (``gst.py:54-99``)."""

    def __init__(self, ref_embed_dim: int = 128, gst_tokens: int = 10,
                 gst_token_dim: int = 256, gst_heads: int = 4):
        super().__init__()
        self.ref_embed_dim = ref_embed_dim
        self.gst_embs = nn.Parameter(torch.randn(gst_tokens, gst_token_dim // gst_heads))
        self.mha = _StyleAttention(ref_embed_dim, gst_token_dim // gst_heads, gst_token_dim,
                                   gst_heads)

    def forward(self, ref_embs: torch.Tensor) -> torch.Tensor:
        B = ref_embs.shape[0]
        tokens = torch.tanh(self.gst_embs)[None].expand(B, -1, -1)
        return self.mha(ref_embs[:, None, :], tokens)[:, 0, :]

    def condition_on_token(self, batch_size: int, index: int = 0) -> torch.Tensor:
        """Text-only inference: a zero query attends to token `index`."""
        token = torch.tanh(self.gst_embs)[index][None, None, :].expand(batch_size, 1, -1)
        query = token.new_zeros((batch_size, 1, self.ref_embed_dim))
        return self.mha(query, token)[:, 0, :]


class StyleEncoder(nn.Module):
    """Reference encoder + style token layer (``gst.py:102-127``)."""

    def __init__(self, idim: int = 80, gst_tokens: int = 10, gst_token_dim: int = 256,
                 gst_heads: int = 4):
        super().__init__()
        self.gst_tokens = gst_tokens
        self.ref_enc = ReferenceEncoder(idim=idim)
        self.stl = StyleTokenLayer(gst_tokens=gst_tokens, gst_token_dim=gst_token_dim,
                                   gst_heads=gst_heads)

    def forward(self, speech: torch.Tensor, use_running_average: bool = True) -> torch.Tensor:
        return self.stl(self.ref_enc(speech, use_running_average))

    def condition_on_gst_tokens(self, batch_size: int, index: int = 0) -> torch.Tensor:
        if index >= self.gst_tokens:
            raise ValueError(f"We can only synthesize by conditioning on one of "
                             f"{self.gst_tokens} GST tokens")
        return self.stl.condition_on_token(batch_size, index)
