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
