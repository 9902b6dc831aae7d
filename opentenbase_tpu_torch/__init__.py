"""opentenbase_tpu_torch — the PyTorch/CUDA port of opentenbase_tpu.

Same layout as the reference package (each module's counterpart sits at
the same path), written for one NVIDIA H100: host-side modules (catalog,
sql, plan, tpch, locator, store, codec) are copies, and the device
kernels of the scan / aggregate / sort path are hand-written CUDA C++
(csrc/, built at first use by ops/build.py).

This package imports torch, numpy and the standard library only — never
jax, never opentenbase_tpu.  Its entry points run on the card unless the
caller asks for the CPU (`LocalNode(device="cpu")`, as the tests do).
"""
