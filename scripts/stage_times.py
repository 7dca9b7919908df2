#!/usr/bin/env python
"""Per-stage device times of the batched encode and decode on a GPU.

    python scripts/stage_times.py [--batch 64] [--reps 10]

Times each stage of the batched 1080p 4:2:0 encode as its own jitted,
vmapped step on device-resident inputs: transform (colour, subsample,
FDCT, quantize, zigzag), entropy pack (the XLA formulation and the Triton
kernel A), segment merge, word compaction, and the whole encode step with
either pack; plus the decode reconstruction (dequantize, IDCT, upsample,
colour). Two cells: Q75 without restarts and Q95 with DRI 120. Each time
is the median of `--reps` calls, each ended by block_until_ready; each
encode step's compiled memory analysis is reported beside its time. Prints
one line per cell and writes chiprun_out/stage_times.json. Needs a GPU.

`cell()` also takes a frame size and runs kernel A in interpret mode, so
tests/test_stage_times.py runs both cells at a tiny size on the CPU.
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


def _median_ms(fn, args, reps: int) -> float:
    import jax
    jax.block_until_ready(fn(*args))             # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def _memory(fn, args) -> dict:
    """Compiled memory analysis of a jitted step, in bytes."""
    ma = fn.lower(*args).compile().memory_analysis()
    return {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes") if ma is not None and hasattr(ma, k)}


def cell(batch: int, quality: int, dri: int, reps: int,
         hw: tuple = (1080, 1920), interpret: bool = False) -> dict:
    """One cell's stage times at frame size `hw`; `interpret` runs kernel A
    in Pallas interpret mode (the CPU test)."""
    import jax
    import jax.numpy as jnp

    from jpgenc_tpu.decoder import pixel_fn
    from jpgenc_tpu.engine import (get_plan, luts_from_tables,
                                   pixels_to_scan, qtables_for_quality,
                                   scan_caps, scan_to_segments_blocked)
    from jpgenc_tpu.layout import make_layout
    from jpgenc_tpu.ops.entropy import make_pieces
    from jpgenc_tpu.ops.pack import (block_pack, segments_from_blocks,
                                     w_blk_for_quality, walign_for,
                                     wcompact_unstuffed)
    from jpgenc_tpu.ops.pallas.block_pack import (fused_block_pack,
                                                  slot_metadata)
    from jpgenc_tpu.ref.encoder import standard_tables
    from jpgenc_tpu.utils.fixtures import synth_batch

    h, w = hw
    lay = make_layout(h, w, "420", dri)
    plan = get_plan(lay)
    sp = plan.plan
    n_seg = lay.n_segments
    w_blk = w_blk_for_quality(quality)
    w_seg = lay.blocks_per_segment * w_blk + 2
    cap_w = scan_caps(lay, quality, "tight")[0] // 4
    wal = walign_for(lay.blocks_per_segment)
    _, qt = qtables_for_quality(quality)
    luts = luts_from_tables(*standard_tables())
    imgs = jax.device_put(synth_batch(h, w, batch))

    def vj(f):
        return jax.jit(jax.vmap(f))

    transform = vj(lambda im: pixels_to_scan(im, lay, qt))
    pack_xla = vj(lambda zz: block_pack(*make_pieces(zz, sp, luts), w_blk))
    pack_kernel = vj(lambda zz: fused_block_pack(
        zz, *slot_metadata(sp, zz), luts=luts, w_blk=w_blk,
        interpret=interpret))
    merge = vj(lambda buf, bits: segments_from_blocks(buf, bits, n_seg,
                                                      w_seg))
    compact = vj(lambda sw, sb: wcompact_unstuffed(sw, sb, cap_w, wal))

    def step(kernel):
        def one(im):
            zz = pixels_to_scan(im, lay, qt)
            sw, sb, ovf = scan_to_segments_blocked(zz, sp, luts, n_seg,
                                                   w_blk, kernel=kernel,
                                                   interpret=interpret)
            return wcompact_unstuffed(sw, sb, cap_w, wal) + (ovf,)
        return vj(one)

    n_total = sum(c.n_blocks for c in lay.comps)
    scan_flat = np.asarray(lay.scan_flat)
    inv = np.empty(n_total, np.int32)
    inv[scan_flat] = np.arange(lay.n_scan)
    pix = pixel_fn(lay)
    qts = [jnp.asarray(qt[c.qtab]) for c in lay.comps]
    recon = vj(lambda zz: pix(zz[inv].astype(jnp.int16), qts))

    zz = transform(imgs)
    buf_x, bits_x = pack_xla(zz)
    buf_k, bits_k = pack_kernel(zz)
    same = bool(jnp.array_equal(buf_x, buf_k)) and \
        bool(jnp.array_equal(bits_x, bits_k))
    sw, sb = merge(buf_k, bits_k)
    step_xla, step_kernel = step(False), step(True)
    out = {
        "batch": batch, "quality": quality, "dri": dri, "w_blk": w_blk,
        "kernel_equals_xla": same,
        "max_block_bits": int(jnp.max(bits_k)),
        "ms": {
            "transform": _median_ms(transform, (imgs,), reps),
            "pack_xla": _median_ms(pack_xla, (zz,), reps),
            "pack_kernel": _median_ms(pack_kernel, (zz,), reps),
            "segment_merge": _median_ms(merge, (buf_k, bits_k), reps),
            "compaction": _median_ms(compact, (sw, sb), reps),
            "encode_step_xla": _median_ms(step_xla, (imgs,), reps),
            "encode_step_kernel": _median_ms(step_kernel, (imgs,), reps),
            "reconstruction": _median_ms(recon, (zz,), reps),
        },
        "memory": {"encode_step_xla": _memory(step_xla, (imgs,)),
                   "encode_step_kernel": _memory(step_kernel, (imgs,))},
    }
    mpix = batch * h * w / 1e6
    out["encode_step_mpix_s"] = {
        k: mpix / (out["ms"][f"encode_step_{k}"] / 1e3)
        for k in ("xla", "kernel")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    from jpgenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"stage_times: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"device_kind": dev.device_kind, "nvidia_smi": smi, "cells": []}
    print(f"nvidia-smi: {smi}", flush=True)
    for q, dri in ((75, 0), (95, 120)):
        c = cell(args.batch, q, dri, args.reps)
        res["cells"].append(c)
        print(json.dumps(c), flush=True)
    res["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
        "peak_bytes_in_use")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "stage_times.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(f"peak_bytes_in_use: {res['peak_bytes_in_use']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
