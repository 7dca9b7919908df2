"""Worker for the real 2-process jax.distributed CPU test (run as a script).

Each process owns 4 virtual CPU devices (8 global). The sharded encode paths
must produce byte-identical output to the single-device api paths, assembled
per-process from addressable shards and exchanged over the Gloo/DCN control
plane (SURVEY.md call stack 4.5).

Usage: python tests/_mp_worker.py <process_id> <num_processes> <port>
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

    import jax
    jax.config.update("jax_platforms", "cpu")

    from jpgenc_tpu.parallel import multihost
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=nproc, process_id=pid)
    assert multihost.process_count() == nproc, "distributed init failed"
    assert jax.device_count() == 4 * nproc

    from jax.sharding import Mesh

    from jpgenc_tpu.api import encode
    from jpgenc_tpu.parallel.mesh import encode_batch, encode_striped

    rng = np.random.default_rng(99)
    imgs = np.stack([
        np.clip(rng.normal(128, 40, (32, 48, 3)), 0, 255).astype(np.uint8)
        for _ in range(8)])
    mesh = Mesh(np.array(jax.devices()), ("batch",))

    # --- DP batch: every process must see the full, byte-identical result
    for optimize in (False, True):
        outs = encode_batch(imgs, quality=75, subsampling="420",
                            optimize=optimize, mesh=mesh)
        assert len(outs) == 8
        for i in range(8):
            ref = encode(imgs[i], quality=75, subsampling="420",
                         optimize=optimize)
            assert outs[i] == ref, \
                f"proc {pid}: batch image {i} mismatch (optimize={optimize})"

    # --- SP stripes: one 128-row image over 8 stripes, restart-aligned
    big = np.clip(rng.normal(128, 40, (128, 48, 3)), 0, 255).astype(np.uint8)
    smesh = Mesh(np.array(jax.devices()), ("stripe",))
    data = encode_striped(big, n_stripes=8, quality=75, subsampling="420",
                          mesh=smesh)
    ref = encode(big, quality=75, subsampling="420",
                 restart_interval=3)  # 48/16=3 MCUs per stripe row
    assert data == ref, f"proc {pid}: striped scan differs from single-device"

    # --- RAGGED stripes across processes: 15 MCU rows over 8 stripes
    # (2x7 + 1) — the tail stripe's padding-row segments drop, global RSTn
    # numbering spans only kept segments, blobs exchange over the control
    # plane; every process must see bytes identical to the unsharded encode
    big_r = np.clip(rng.normal(128, 40, (120, 64)), 0, 255).astype(np.uint8)
    data_r = encode_striped(big_r, n_stripes=8, quality=75,
                            restart_interval=8, mesh=smesh)
    assert data_r == encode(big_r, quality=75, restart_interval=8), \
        f"proc {pid}: ragged striped scan differs from single-device"

    # --- sharded decode: each process entropy-decodes only its owned rows;
    # pixels stay sharded; every process verifies its ADDRESSABLE shards
    # against the single-device decoder (global device_get would raise)
    from jpgenc_tpu.api import decode
    from jpgenc_tpu.parallel.mesh import decode_batch as decode_sharded
    files = [encode(imgs[i], quality=75, subsampling="420") for i in range(8)]
    out = decode_sharded(files, mesh=mesh)          # sharded [8, 32, 48, 3]
    checked = 0
    for sh in out.addressable_shards:
        start = sh.index[0].start or 0
        local = np.asarray(sh.data)
        for k in range(local.shape[0]):
            np.testing.assert_array_equal(local[k], decode(files[start + k]))
            checked += 1
    assert checked == 8 // nproc, \
        f"proc {pid}: expected {8 // nproc} local rows, got {checked}"

    print(f"MP_WORKER_OK {pid}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
