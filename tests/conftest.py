"""Test harness config.

Tests run on CPU with 8 virtual devices so all multi-device sharding logic
is exercised without accelerator hardware (SURVEY.md section 5 item 7).
These env vars must be set before jax is first imported anywhere.

JPGENC_GPU_LANE=1 selects the GPU lane instead (tests marked `gpu`,
tests/test_gpu_lane.py): the GPU and the CPU backend are both visible, and
the lane compares them. Without a GPU those tests skip.
"""
import os
import sys

GPU_LANE = os.environ.get("JPGENC_GPU_LANE") == "1"
if GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
else:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not GPU_LANE:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def pixel_parity():
    """Pixel comparison across DIFFERENT recon executables (batch vs
    single, packed vs sparse vs dense upload forms, sharded vs local).

    Quantized coefficients are bit-exact across all paths — that contract
    is tested at the coefficient layer. Decoded PIXELS, however, come out
    of separately compiled float-IDCT programs, and XLA may reassociate
    the matmul/rounding chain differently per (form, batch) executable:
    knife-edge pixels can legitimately differ by 1 (measured: ~1 pixel per
    several Mpix of noise content; rng-order dependent, which made exact
    asserts flaky under xdist). Same discipline as the GPU lane.
    Comparisons of the SAME executable's output stay exact."""
    def check(a, b, frac=1e-3):
        a = np.asarray(a).astype(np.int64)
        b = np.asarray(b).astype(np.int64)
        assert a.shape == b.shape, (a.shape, b.shape)
        d = np.abs(a - b)
        assert d.max() <= 1, f"maxdiff {d.max()}"
        lim = max(frac, 4.0 / d.size)       # tiny images: allow a few px
        bad = (d > 0).mean()
        assert bad <= lim, f"knife-edge fraction {bad:.2e} > {lim:.2e}"
    return check


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (run with JPGENC_GPU_LANE=1; skips "
        "without one)")


def _gradient_noise_image(rng, h, w, channels=None):
    """Deterministic structured test image: gradients + sinusoids + noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (
        96.0 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
        + 0.35 * xx + 0.2 * yy
    )
    if channels:
        chans = [base + 25.0 * c + rng.normal(0, 12, (h, w)) for c in range(channels)]
        img = np.stack(chans, axis=-1)
    else:
        img = base + rng.normal(0, 12, (h, w))
    return np.clip(img + 96.0, 0, 255).astype(np.uint8)


@pytest.fixture(scope="session")
def gray_image(rng):
    return _gradient_noise_image(rng, 128, 128)


@pytest.fixture(scope="session")
def rgb_image(rng):
    return _gradient_noise_image(rng, 120, 136, channels=3)


@pytest.fixture(scope="session")
def gray_image_512(rng):
    return _gradient_noise_image(rng, 512, 512)
