"""The arithmetic the plain references run in.

``EXACT`` is float64 throughout: the reference.  ``TF32`` is the control of
the comparison that decides ``correct``: the same code in float32 with the
operands of every matrix product rounded to TF32's 10-bit mantissa (the
precision one step below IEEE float32 that a GPU's tensor cores offer),
accumulated in float32.  The rounding is done explicitly, so the control
reads the same on a CPU as on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to the nearest TF32 value (1 sign, 8 exponent,
    10 mantissa bits), ties away from zero, as the tensor cores read them."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


@dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype
    tf32: bool

    def t(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` in this precision."""
        if self.tf32:
            return round_tf32(a) @ round_tf32(b)
        return a.to(self.dtype) @ b.to(self.dtype)


EXACT = Precision("float64", torch.float64, False)
TF32 = Precision("tf32", torch.float32, True)
