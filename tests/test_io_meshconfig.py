"""io module, MeshConfig, and file-driven batch tests."""
import json
import os

import numpy as np
import pytest

from jpgenc_tpu import io
from jpgenc_tpu.config import MeshConfig


def test_load_save_roundtrip(tmp_path, rgb_image, gray_image):
    p_rgb = str(tmp_path / "a.png")
    p_gray = str(tmp_path / "b.png")
    io.save(p_rgb, rgb_image)
    io.save(p_gray, gray_image)
    np.testing.assert_array_equal(io.load(p_rgb), rgb_image)
    np.testing.assert_array_equal(io.load(p_gray), gray_image)
    assert io.probe(p_rgb) == (rgb_image.shape[0], rgb_image.shape[1], 3)
    assert io.probe(p_gray) == (gray_image.shape[0], gray_image.shape[1], 1)


def test_find_images_and_load_batch(tmp_path, rng):
    imgs = [rng.integers(0, 255, (24, 16, 3), dtype=np.uint8) for _ in range(3)]
    for i, a in enumerate(imgs):
        io.save(str(tmp_path / f"img_{i}.png"), a)
    (tmp_path / "notes.txt").write_text("not an image")
    paths = io.find_images(str(tmp_path))
    assert len(paths) == 3 and all(p.endswith(".png") for p in paths)
    batch = io.load_batch(paths)
    assert batch.shape == (3, 24, 16, 3)
    np.testing.assert_array_equal(batch[1], imgs[1])


def test_load_batch_shape_mismatch(tmp_path, rng):
    io.save(str(tmp_path / "a.png"),
            rng.integers(0, 255, (8, 8, 3), dtype=np.uint8))
    io.save(str(tmp_path / "b.png"),
            rng.integers(0, 255, (16, 8, 3), dtype=np.uint8))
    with pytest.raises(ValueError, match="shape"):
        io.load_batch(io.find_images(str(tmp_path)))


def test_mesh_config():
    import jax
    from jpgenc_tpu.parallel.mesh import make_mesh
    n = len(jax.devices())
    m1 = make_mesh(MeshConfig())
    assert m1.axis_names == ("batch",) and m1.devices.size == n
    m2 = make_mesh(MeshConfig(stripe=2))
    assert m2.axis_names == ("batch", "stripe")
    assert m2.devices.shape == (n // 2, 2)
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(stripe=n + 1))
    with pytest.raises(ValueError):
        MeshConfig(batch_axis="x", stripe_axis="x")
    assert hash(MeshConfig()) == hash(MeshConfig())


def test_encode_batch_accepts_mesh_config(rng):
    from jpgenc_tpu.api import encode
    from jpgenc_tpu.parallel.mesh import encode_batch
    imgs = np.stack([rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)
                     for _ in range(2)])
    outs = encode_batch(imgs, quality=75, mesh=MeshConfig(batch=2))
    assert outs[0] == encode(imgs[0], quality=75)
    assert outs[1] == encode(imgs[1], quality=75)


def test_file_driven_batch_mixed_shapes(tmp_path, rng):
    """run_batch over file paths with two shape groups: lazy load + grouping."""
    from jpgenc_tpu.api import decode
    from jpgenc_tpu.batch import run_batch
    shapes = [(24, 16, 3), (24, 16, 3), (16, 24, 3), (24, 16, 3), (16, 24, 3)]
    paths, outs = [], []
    for i, s in enumerate(shapes):
        a = rng.integers(0, 255, s, dtype=np.uint8)
        p = str(tmp_path / f"in_{i}.png")
        io.save(p, a)
        paths.append(p)
        outs.append(str(tmp_path / f"out_{i}.jpg"))
    manifest = str(tmp_path / "manifest.jsonl")
    res = run_batch(paths, outs, manifest, quality=75, chunk_size=2)
    assert res.done == 5 and res.skipped == 0
    for p, o in zip(paths, outs):
        img = decode(open(o, "rb").read())
        assert img.shape == io.load(p).shape
    # resume is idempotent
    res2 = run_batch(paths, outs, manifest, quality=75, chunk_size=2)
    assert res2.done == 0 and res2.skipped == 5


def test_cli_batch_command(tmp_path, rng, capsys):
    from jpgenc_tpu.cli import main
    indir = tmp_path / "in"
    outdir = tmp_path / "out"
    indir.mkdir()
    for i in range(3):
        io.save(str(indir / f"f{i}.png"),
                rng.integers(0, 255, (16, 16, 3), dtype=np.uint8))
    rc = main(["batch", str(indir), str(outdir), "--quality", "80",
               "--chunk", "2"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["done"] == 3
    assert sorted(os.listdir(outdir)) == ["f0.jpg", "f1.jpg", "f2.jpg",
                                          "manifest.jsonl"]
