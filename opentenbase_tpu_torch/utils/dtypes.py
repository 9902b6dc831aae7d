"""Device dtype policy of the PyTorch port: the x64 mode only.

The H100 has native f64 arithmetic, so the reference's f32-on-device
("tpu") mode has no counterpart here: FLOAT64 columns stage as f64,
float intermediates (AVG, float division) compute in f64, and DECIMAL
stays an exact scaled int64.  Integer/decimal arithmetic is exact, so
TPC-H money aggregates match the reference bit for bit; pure-float sums
differ only by summation order.
"""

from __future__ import annotations

import numpy as np
import torch

#: float compute dtype on the device path
DEVICE_FLOAT = torch.float64

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def device_float() -> torch.dtype:
    """torch dtype for float compute on device (always f64)."""
    return DEVICE_FLOAT


def torch_dtype(dt) -> torch.dtype:
    """numpy dtype -> torch dtype (storage and code dtypes only)."""
    return _NP_TO_TORCH[np.dtype(dt)]


def dev_dtype(t) -> torch.dtype:
    """Device tensor dtype for a SqlType (its storage dtype)."""
    return torch_dtype(t.np_dtype)


def float_to_bits(t: torch.Tensor) -> torch.Tensor:
    """f64 tensor -> int64 bit-pattern key (injective; for equality,
    not ordering)."""
    return t.to(torch.float64).view(torch.int64)


def bits_to_float(t: torch.Tensor) -> torch.Tensor:
    """Inverse of float_to_bits."""
    return t.view(torch.float64)


_INT64_MAX = (1 << 63) - 1


def float_word(t: torch.Tensor) -> torch.Tensor:
    """f64 tensor -> its canonical order word, an int64 key: -0.0 becomes
    +0.0 and every NaN the one +NaN, then the bits viewed as int64 with a
    negative pattern flipped (b ^ INT64_MAX).  Word order is the numeric
    order with NaN last and NaN equal to NaN (PostgreSQL's float8 order);
    equal words are equal values under float8eq.  The canonical NaN's
    word is 0x7FF8000000000000 and +inf's 0x7FF0000000000000, both below
    the join's reserved sentinels INT64_MAX (a NULL key) and
    INT64_MAX - 1 (an invalid probe row), so no f64 key collides with
    them."""
    x = t.to(torch.float64)
    x = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device),
                    x)
    x = torch.where(torch.isnan(x), torch.full((), float("nan"),
                                               dtype=x.dtype,
                                               device=x.device), x)
    b = x.view(torch.int64)
    return torch.where(b >= 0, b, b ^ _INT64_MAX)


def word_float(w: torch.Tensor) -> torch.Tensor:
    """Inverse of float_word on its image (canonical values)."""
    w = w.to(torch.int64)
    return torch.where(w >= 0, w, w ^ _INT64_MAX).view(torch.float64)
