#!/usr/bin/env python
"""Device cost-model probe: the constants the design decisions rest on,
re-measured in one command and printed as ONE JSON object.

    python scripts/probe_platform.py           # transfer latency + rates
    python scripts/probe_platform.py --full    # + compiled probes: on-device
                                               # copy, gather ns/index, bf16
                                               # matmul, cumsum

The gather cost per data-dependent index decides whether Huffman decode
could move onto the device (ROADMAP S4). Every time is the median of a few
calls, each ended by block_until_ready (or a host fetch for D2H). Needs a
GPU: on any other platform it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _median_s(fn, reps: int = 5) -> float:
    fn()                                          # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def probe_transfers(jax, mb: int = 64) -> dict:
    """Tiny-put round trip, and H2D / D2H MB/s on an `mb` MB buffer."""
    small = np.zeros(4096, np.uint8)
    rt = _median_s(lambda: np.asarray(jax.device_put(small)), reps=8)
    host = np.arange(mb << 20, dtype=np.uint8)
    h2d = _median_s(lambda: jax.device_put(host).block_until_ready())
    dev = jax.device_put(host)
    # a fresh array per fetch: jax.Array caches its host copy
    d2h = _median_s(lambda: np.asarray(dev + np.uint8(0)))
    return {"rt_4kb_ms": rt * 1e3, "buffer_mb": mb,
            "h2d_mb_s": mb / h2d, "d2h_mb_s": mb / d2h}


def probe_compiled(jax) -> dict:
    import jax.numpy as jnp
    out = {}
    n = 256 << 20
    x = jax.device_put(np.zeros(n, np.uint8))
    f = jax.jit(lambda a: a + np.uint8(1))
    out["ondevice_copy_gb_s"] = 2 * n / _median_s(
        lambda: f(x).block_until_ready()) / 1e9

    m = 3_100_000
    idx = jax.device_put(np.random.default_rng(0).integers(
        0, 512, m, dtype=np.int32))
    tab = jax.device_put(np.arange(512, dtype=np.int32))
    g = jax.jit(lambda t, i: t[i])
    out["gather_ns_per_idx_512"] = _median_s(
        lambda: g(tab, idx).block_until_ready()) / m * 1e9

    k = 8192
    a = jax.device_put(np.ones((k, k), np.float32)).astype(jnp.bfloat16)
    mm = jax.jit(lambda p, q: p @ q)
    out["bf16_matmul_8192_tflop_s"] = 2 * k**3 / _median_s(
        lambda: mm(a, a).block_until_ready()) / 1e12

    v = jax.device_put(np.ones(m, np.int32))
    cs = jax.jit(jnp.cumsum)
    out["cumsum_3m1_ms"] = _median_s(
        lambda: cs(v).block_until_ready()) * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()

    from jpgenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"probe_platform: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = {"device_kind": dev.device_kind, "nvidia_smi": smi,
              "transfers": probe_transfers(jax)}
    if args.full:
        result["compiled"] = probe_compiled(jax)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
