"""Numeric kernels (XLA programs) — the analogue of the reference's
volk_gnsssdr SIMD module (``src/algorithms/libs/volk_gnsssdr_module``)."""
