"""Tracing/profiling utilities (SURVEY.md section 6).

- `trace(dir)` wraps `jax.profiler.trace` for Perfetto/TensorBoard captures.
- `flops_bytes_estimate(layout)` prints the roofline-style cost model for an
  encode of the given frame layout (the `pl.cost_estimate`-style accounting
  SURVEY.md section 6 asks the bench driver to expose).
"""
from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace viewable in TensorBoard/Perfetto."""
    with jax.profiler.trace(log_dir):
        yield


def flops_bytes_estimate(layout) -> dict:
    """Analytic cost model for one encode (SURVEY.md section 7 feasibility)."""
    n_blocks = sum(c.n_blocks for c in layout.comps)
    px = sum(c.plane_h * c.plane_w for c in layout.comps)
    return {
        "pixels": px,
        "blocks": n_blocks,
        "dct_flops": n_blocks * 64 * 64 * 2,        # [n,64]@[64,64]
        "color_flops": layout.height * layout.width * 12,
        "hbm_bytes_min": px * (1 + 4 + 4 + 4),      # u8 in, f32, i32 zz, out
        "entropy_slots": n_blocks * 64,
    }
