#!/usr/bin/env python
"""Flagship BASELINE.json:11 config at full scale: 1024 distinct 1080p
frames from files through `batch.run_batch`, checkpoint manifest on, with
a real SIGKILL + resume exercised mid-run. Prints one JSON object and,
with --out, writes it to that file.

The batch runs as sequential worker processes, one slice each with its own
checkpoint manifest, so that one of them can be killed and relaunched: the
kill lane SIGKILLs one worker (exact PID — never a pattern kill) once its
manifest shows progress, relaunches it, and asserts the relaunch skipped
the finished images and completed the rest — the manifest resume contract
at scale. Only the workers use the device, one at a time; this parent
process never imports JAX (the closing spot decode runs in a worker too).

Usage:
    python scripts/run_batch1024.py [--n 1024] [--root DIR]
        [--slice-size 160] [--kill-slice 2] [--out result.json]
    (--root defaults to a fresh directory under the temp dir, $TMPDIR)
    (worker modes are internal: --worker --i0 --i1 --manifest ..., --spot)
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

H, W = 1080, 1920
N_BASE = 32          # distinct synthetic bases; the rest are cheap
                     # roll/flip derivations (still 1024 distinct files)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _in_path(root, i):
    return os.path.join(root, "in", f"{i:04d}.ppm")


def _out_path(root, i):
    return os.path.join(root, "out", f"{i:04d}.jpg")


def gen_inputs(root: str, n: int) -> float:
    """Write n distinct 1080p PPMs (skipped if already present)."""
    from PIL import Image

    from jpgenc_tpu.utils.fixtures import synth_frame
    os.makedirs(os.path.join(root, "in"), exist_ok=True)
    if all(os.path.exists(_in_path(root, i)) for i in range(n)):
        return 0.0
    t0 = time.perf_counter()
    bases = [synth_frame(H, W, seed=100 + b) for b in range(N_BASE)]
    for i in range(n):
        img = bases[i % N_BASE]
        k = i // N_BASE
        if k:
            img = np.roll(img, (33 * k) % H, axis=0)
            if k % 2:
                img = img[:, ::-1]
        Image.fromarray(np.ascontiguousarray(img)).save(_in_path(root, i))
        if i % 128 == 0:
            _log(f"gen {i}/{n}")
    return time.perf_counter() - t0


def worker(root: str, i0: int, i1: int, manifest: str) -> None:
    from jpgenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from jpgenc_tpu.batch import run_batch
    imgs = [_in_path(root, i) for i in range(i0, i1)]
    outs = [_out_path(root, i) for i in range(i0, i1)]
    os.makedirs(os.path.join(root, "out"), exist_ok=True)
    res = run_batch(imgs, outs, manifest, quality=75, subsampling="420",
                    chunk_size=16)
    print(json.dumps({"done": res.done, "skipped": res.skipped,
                      "mpix_per_s": round(res.mpix_per_s, 2)}), flush=True)


def spot_decode(root: str, n: int) -> None:
    """Worker mode: our decoder + Pillow agree on a spread of the emitted
    files, and both reconstruct the source (the round-trip quality gate)."""
    import io as _io

    from PIL import Image

    from jpgenc_tpu.api import decode
    from jpgenc_tpu.utils.metrics import psnr
    spots = []
    for i in range(0, n, max(1, n // 8))[:8]:
        with open(_out_path(root, i), "rb") as f:
            d = f.read()
        src = np.asarray(Image.open(_in_path(root, i)))
        own = decode(d)
        pil = np.asarray(Image.open(_io.BytesIO(d)).convert("RGB"))
        spots.append({"i": i, "psnr_own": round(float(psnr(own, src)), 2),
                      "psnr_pil": round(float(psnr(pil, src)), 2),
                      "own_vs_pil_maxdiff": int(np.abs(
                          own.astype(np.int16) - pil.astype(np.int16)).max())})
    print(json.dumps(spots), flush=True)


def _spawn(root, i0, i1, manifest):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         "--root", root, "--i0", str(i0), "--i1", str(i1),
         "--manifest", manifest],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def _manifest_lines(path):
    try:
        with open(path) as f:
            return sum(1 for _ in f)
    except FileNotFoundError:
        return 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--spot", action="store_true")
    ap.add_argument("--root", default="")
    ap.add_argument("--i0", type=int, default=0)
    ap.add_argument("--i1", type=int, default=0)
    ap.add_argument("--manifest", default="")
    ap.add_argument("--n", type=int, default=1024)
    # default 160 = 10 whole 16-frame chunks — keeping every chunk the same
    # shape avoids a remainder-batch executable compile in each worker
    ap.add_argument("--slice-size", type=int, default=160)
    ap.add_argument("--kill-slice", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    if args.worker:
        worker(args.root, args.i0, args.i1, args.manifest)
        return
    if args.spot:
        spot_decode(args.root, args.n)
        return
    if not args.root:
        args.root = tempfile.mkdtemp(prefix="batch1024-")

    gen_s = gen_inputs(args.root, args.n)
    _log(f"inputs ready ({gen_s:.0f} s generation)")
    # fresh run: stale manifests/outputs from an earlier invocation would
    # corrupt both the kill-lane assertions and the wall-clock claim
    # (resume-across-invocations is exercised INSIDE the run, by the kill
    # lane). Inputs are kept.
    import glob
    for f in glob.glob(os.path.join(args.root, "manifest_*.jsonl")) + \
            glob.glob(os.path.join(args.root, "out", "*.jpg")):
        os.remove(f)
    slices = [(i, min(i + args.slice_size, args.n))
              for i in range(0, args.n, args.slice_size)]
    kill_info = None
    t0 = time.perf_counter()
    for s, (i0, i1) in enumerate(slices):
        manifest = os.path.join(args.root, f"manifest_{s}.jsonl")
        if s == args.kill_slice:
            # fault-injection lane: SIGKILL the worker (exact PID) once its
            # manifest shows real progress, then relaunch and require the
            # resume to skip everything the manifest recorded
            thresh = max(1, min(48, max(8, (i1 - i0) // 3), i1 - i0))
            p = _spawn(args.root, i0, i1, manifest)
            while _manifest_lines(manifest) < thresh:
                if p.poll() is not None:
                    raise RuntimeError("kill-lane worker exited early")
                time.sleep(0.5)
            os.kill(p.pid, signal.SIGKILL)
            p.wait()
            lines_at_kill = _manifest_lines(manifest)
            _log(f"slice {s}: SIGKILLed pid {p.pid} at "
                 f"{lines_at_kill} manifest lines")
            p = _spawn(args.root, i0, i1, manifest)
            out, _ = p.communicate()
            if p.returncode != 0 or not out.strip():
                raise RuntimeError(
                    f"kill-lane resume worker failed rc={p.returncode} "
                    f"out={out[:200]!r}")
            res = json.loads(out.strip().splitlines()[-1])
            assert res["skipped"] >= min(thresh, lines_at_kill) and \
                res["done"] + res["skipped"] == i1 - i0, res
            kill_info = {"slice": s, "pid_killed": True,
                         "manifest_lines_at_kill": lines_at_kill,
                         "resume_skipped": res["skipped"],
                         "resume_done": res["done"]}
            _log(f"slice {s}: resume skipped {res['skipped']}, "
                 f"completed {res['done']}")
        else:
            p = _spawn(args.root, i0, i1, manifest)
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"slice {s} failed rc={p.returncode}")
            res = json.loads(out.strip().splitlines()[-1])
            _log(f"slice {s} [{i0}:{i1}]: {res}")
    wall = time.perf_counter() - t0

    # integrity: every file present, structurally a JPEG, manifests complete
    missing, bad, sizes = [], [], []
    for i in range(args.n):
        if not os.path.exists(_out_path(args.root, i)):
            missing.append(i)
            continue
        with open(_out_path(args.root, i), "rb") as f:
            d = f.read()
        sizes.append(len(d))
        if d[:2] != b"\xff\xd8" or d[-2:] != b"\xff\xd9":
            bad.append(i)
    man_total = sum(_manifest_lines(os.path.join(
        args.root, f"manifest_{s}.jsonl")) for s in range(len(slices)))

    spot = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--spot",
         "--root", args.root, "--n", str(args.n)],
        capture_output=True, text=True, check=True)
    spots = json.loads(spot.stdout.strip().splitlines()[-1])

    result = {
        "config": "BASELINE.json:11 — 1024 x 1080p RGB 4:2:0 Q75 through "
                  "batch.run_batch (manifest checkpointing, chunk 16, "
                  "double-buffered staging)",
        "n_images": args.n,
        "wall_s": round(wall, 1),
        "mpix_per_s": round(args.n * H * W / 1e6 / wall, 2),
        "slices": len(slices),
        "slice_size": args.slice_size,
        "process_note": "one worker process per slice; wall-clock "
                        "includes every worker's start-up and compile",
        "kill_resume": kill_info,
        "integrity": {"files_missing": len(missing), "files_bad": bad,
                      "manifest_lines_total": man_total,
                      "bytes_total": int(sum(sizes)),
                      "bpp_mean": round(8 * float(np.mean(sizes))
                                        / (H * W), 4)},
        "spot_decode": spots,
        "input_note": f"{N_BASE} distinct synthetic bases + roll/flip "
                      f"derivations -> {args.n} distinct PPM files on disk, "
                      f"loaded lazily per chunk (io.load)",
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
