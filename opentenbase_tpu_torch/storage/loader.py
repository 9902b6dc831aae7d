"""Bulk-loader marker type.

The reference's native COPY loader is not ported yet; the store and the
Locator only need its marker for decimals that arrive already scaled.
"""

from __future__ import annotations

import numpy as np


class _PreScaled(np.ndarray):
    """Marker: decimal values already scaled to storage form."""
    def __new__(cls, arr):
        return np.asarray(arr).view(cls)
