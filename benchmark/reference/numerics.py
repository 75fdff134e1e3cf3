"""The arithmetic the plain references compute their products in.

``Numerics("float32")`` is the reference itself: every matmul and conv in
float32 with TF32 off. The other modes are the controls of "How `correct`
is decided": the same reference with the operands of every product rounded
to a lower precision before it is taken (accumulation stays float32, as on
tensor cores):

- ``"tf32"``: operands rounded to TF32 (10 mantissa bits);
- ``"bfloat16"``: operands rounded to bfloat16;
- ``"fp8"``: operands scaled per tensor into float8 e4m3's range and
  rounded to it (3 mantissa bits), then scaled back.

Nothing here imports the program."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("float32", "tf32", "bfloat16", "fp8")
E4M3_MAX = 448.0


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest-even on TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Numerics:
    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"unknown numerics {mode!r}; one of {MODES}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, rounded as the mode says (float32 out)."""
        if self.mode == "float32":
            return x.float()
        if self.mode == "tf32":
            return _round_tf32(x)
        if self.mode == "bfloat16":
            return x.to(torch.bfloat16).float()
        return _round_fp8(x)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def linear(self, x, w, b=None):
        y = torch.matmul(self.q(x), self.q(w).t())
        return y if b is None else y + b.float()

    def conv1d(self, x, w, b=None, **kw):
        return F.conv1d(self.q(x), self.q(w), None if b is None else b.float(), **kw)

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.q(x), self.q(w), None if b is None else b.float(), **kw)

    def conv_transpose1d(self, x, w, b=None, **kw):
        return F.conv_transpose1d(self.q(x), self.q(w), None if b is None else b.float(), **kw)


@contextlib.contextmanager
def strict_float32():
    """TF32 off for every float32 product taken inside, and the process's
    settings back after (the program keeps PyTorch's defaults)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
