"""Launch a REAL 2-process jax.distributed CPU job.

Unlike the 8-virtual-device single-process sim, this exercises the actual
multi-host code paths: jax.distributed.initialize, non-addressable global
arrays (device_get would raise), per-process addressable-shard assembly, and
the host byte-blob exchange in parallel.multihost.gather_bytes.
"""
import os
import socket
import subprocess
import sys

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_kill_one_process_resume(tmp_path):
    """REAL process-kill fault injection (SURVEY.md section 6): worker 1
    SIGKILLs itself mid-`run_batch` (after chunk 1 of 3 is flushed), the
    harness tears down the hung survivor like a gang scheduler would, then
    relaunches the job — the manifest resume must complete every file with
    byte-correct output and actually skip the finished work."""
    import time

    _FAULT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_mp_fault_worker.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    outdir = str(tmp_path)

    # --- run 1: worker 1 dies after its first chunk -----------------------
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, _FAULT, str(i), "2", str(port), outdir]
        + (["1"] if i == 1 else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for i in range(2)]
    try:
        out1, _ = procs[1].communicate(timeout=540)
        assert procs[1].returncode == -9, \
            f"worker 1 should die by SIGKILL, got {procs[1].returncode}:" \
            f"\n{out1[-2000:]}"
        # the survivor blocks in the dead peer's collective; give it a
        # moment to prove it does NOT finish, then kill the exact pid
        t0 = time.monotonic()
        while time.monotonic() - t0 < 20 and procs[0].poll() is None:
            time.sleep(0.5)
        assert procs[0].poll() is None or procs[0].returncode != 0, \
            "worker 0 completed despite its peer dying mid-batch"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()                      # exact pid, never a pattern
                p.communicate(timeout=60)

    # chunk 1 landed before the kill: both manifests must show progress
    for i in range(2):
        mpath = os.path.join(outdir, f"manifest_p{i}.jsonl")
        assert os.path.exists(mpath), f"no manifest from worker {i}"
        assert sum(1 for _ in open(mpath)) >= 1

    # --- run 2: relaunch, resume from the manifests -----------------------
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, _FAULT, str(i), "2", str(port), outdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-25:])
        assert p.returncode == 0, f"relaunched worker {i} failed:\n{tail}"
        assert f"MP_FAULT_OK {i}" in out, f"worker {i} incomplete:\n{tail}"
    # worker 1 finished chunk 1 (4 images) before dying — the relaunch must
    # have SKIPPED at least those, proving resume rather than redo
    import re
    skipped1 = int(re.search(r"MP_FAULT_OK 1 done=\d+ skipped=(\d+)",
                             outs[1]).group(1))
    assert skipped1 >= 4, f"worker 1 resumed nothing (skipped={skipped1})"


def test_two_process_distributed_encode():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)       # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-25:])
        assert p.returncode == 0, f"worker {i} failed:\n{tail}"
        assert f"MP_WORKER_OK {i}" in out, f"worker {i} incomplete:\n{tail}"
