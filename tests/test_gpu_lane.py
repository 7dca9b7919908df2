"""GPU lane: the card's encode bytes and decode pixels vs the CPU backend's,
in one process.

    JPGENC_GPU_LANE=1 python -m pytest tests/test_gpu_lane.py -q

Both backends run the same program through parallel.mesh, each on a
one-device mesh of its own platform, so the GPU runs the Triton entropy
kernel and the CPU the XLA formulation. The integer (islow) pipeline must
give identical files. The float transform may flip a coefficient that sits
on a rounding boundary (|d| <= 1 on at most 1e-4 of them; a TF32 product
exceeds that at Q95, see tests/test_transform_stage.py), and a frame whose
coefficients agree must give identical bytes. Decoded pixels follow the
pixel_parity policy. Without a GPU every test here skips.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def meshes():
    import jax
    from jax.sharding import Mesh
    try:
        gpu = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible (run with JPGENC_GPU_LANE=1 on a GPU host)")
    cpu = jax.devices("cpu")[0]
    return {name: Mesh(np.array([d]), ("batch",))
            for name, d in (("gpu", gpu), ("cpu", cpu))}


@pytest.fixture(scope="module")
def frames():
    from jpgenc_tpu.utils.fixtures import synth_batch
    return synth_batch(256, 384, 4)


def _zz(frames, mesh, **kw):
    from jpgenc_tpu.config import EncodeConfig
    from jpgenc_tpu.engine import qtables_for_quality
    from jpgenc_tpu.parallel.mesh import _batch_setup, put_batch
    cfg = EncodeConfig(**kw)
    imgs, _, _, _, _, _, fns = _batch_setup(frames, cfg, mesh)
    _, qt = qtables_for_quality(cfg.quality)
    return np.asarray(fns["zz"](put_batch(imgs, fns["sharding_img"]), qt))


@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
def test_islow_files_identical(meshes, frames, mode):
    from jpgenc_tpu.parallel.mesh import encode_batch
    imgs = frames[..., 0].copy() if mode == "gray" else frames
    sub = "420" if mode == "gray" else mode
    out = {k: encode_batch(imgs, quality=75, subsampling=sub, mesh=m,
                           dct_method="islow") for k, m in meshes.items()}
    assert out["gpu"] == out["cpu"]


def test_islow_optimize_restart_identical(meshes, frames):
    from jpgenc_tpu.parallel.mesh import encode_batch
    out = {k: encode_batch(frames, quality=90, restart_interval=7,
                           optimize=True, mesh=m, dct_method="islow")
           for k, m in meshes.items()}
    assert out["gpu"] == out["cpu"]


@pytest.mark.parametrize("quality,dri", [(75, 0), (95, 120)])
def test_float_encode_vs_cpu(meshes, frames, quality, dri):
    from jpgenc_tpu.parallel.mesh import encode_batch
    kw = dict(quality=quality, restart_interval=dri)
    zz = {k: _zz(frames, m, **kw) for k, m in meshes.items()}
    d = np.abs(zz["gpu"].astype(np.int64) - zz["cpu"])
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4, \
        f"{int((d > 0).sum())} coefficients differ (max {d.max()})"
    files = {k: encode_batch(frames, mesh=m, **kw)
             for k, m in meshes.items()}
    for i in range(len(frames)):
        if not d[i].any():
            assert files["gpu"][i] == files["cpu"][i], f"frame {i}"


def test_decode_pixels_vs_cpu(meshes, frames, pixel_parity):
    from jpgenc_tpu.parallel.mesh import decode_batch, encode_batch
    files = encode_batch(frames, quality=80, mesh=meshes["cpu"])
    pix = {k: np.asarray(decode_batch(files, mesh=m))
           for k, m in meshes.items()}
    for a, b in zip(pix["gpu"], pix["cpu"]):
        pixel_parity(a, b)
