"""Distribution layer (SURVEY.md layer G, call stack 4.5).

Two parallelism strategies over a `jax.sharding.Mesh` (SURVEY.md section 3
"Parallelism strategies"):

- **DP / batch**: a batch of same-shape images is sharded over the 'batch'
  mesh axis with `NamedSharding(P('batch', ...))`; the per-image pipeline is
  vmapped and jitted with input shardings, so each chip encodes its shard and
  XLA inserts no cross-chip traffic until the host gathers packed segments.

- **SP analog / stripe**: one large image is split into MCU-row stripes, one
  per chip. Stripe boundaries are restart boundaries (the survey's key
  architectural insight): each stripe's entropy segments are byte-aligned and
  DC-reset, so stripes are encoded as independent sub-images and their
  segments concatenate into ONE valid scan, with RSTn numbering derived from
  the *global* segment index. The result is byte-identical to a single-device
  encode of the whole image at the same restart interval (tested).

Collectives: the optimized-Huffman two-pass mode psums symbol histograms
across the mesh (here: a jnp.sum over the stripe axis of sharded per-stripe
histograms) before the host builds one global table set.

Multi-host: under `jax.distributed` the same code runs SPMD per process; the
host-side byte assembly uses each image's owning process
(`multihost_utils.process_allgather` for striped scans). This module is
exercised on an N-virtual-device CPU mesh in CI (SURVEY.md section 5 item 7).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jpgenc_tpu.config import EncodeConfig, MeshConfig
from jpgenc_tpu.container.jfif import build_headers
from jpgenc_tpu.engine import (DevicePlan, finalize_host_w, get_plan,
                               luts_from_tables, qtables_for_quality,
                               scan_caps, scan_to_segments_blocked)
from jpgenc_tpu.ops.pack import (seg_nwords_aligned, w_blk_for_quality,
                                walign_for, wcompact_unstuffed)
from jpgenc_tpu.huffman import build_codes, optimize_tables
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ops.entropy import symbol_histogram
from jpgenc_tpu.engine import (blocks_to_scan, pack_kernel_default,
                               pixels_to_blocks, pixels_to_scan,
                               scan_to_segments)
from jpgenc_tpu.ref.encoder import standard_tables


def default_mesh(axis: str = "batch") -> Mesh:
    return Mesh(np.array(jax.devices()), (axis,))


def make_mesh(cfg: MeshConfig) -> Mesh:
    """Resolve a declarative MeshConfig to a jax Mesh over this slice.

    stripe == 1 builds the 1-D data-parallel mesh (no degenerate axis, so
    batched executables cache-key identically to the default mesh); stripe > 1
    builds the 2-D ('batch', 'stripe') mesh of call stack 4.5.
    """
    devs = jax.devices()
    n = len(devs)
    b, s = cfg.batch, cfg.stripe
    if s > n:
        raise ValueError(f"stripe={s} exceeds {n} available devices")
    if b == 0:
        b = n // s
    if b * s > n:
        raise ValueError(f"mesh {b}x{s} exceeds {n} available devices")
    if s == 1:
        return Mesh(np.array(devs[:b]), (cfg.batch_axis,))
    return Mesh(np.array(devs[:b * s]).reshape(b, s),
                (cfg.batch_axis, cfg.stripe_axis))


def _as_mesh(mesh) -> Mesh | None:
    return make_mesh(mesh) if isinstance(mesh, MeshConfig) else mesh


def _local_rows(*arrays) -> dict[int, tuple]:
    """Locally-addressable rows of batch-sharded arrays, keyed by global row.

    On a multi-host mesh `jax.device_get` of a globally-sharded array raises
    (non-addressable shards); every host instead fetches only the shards on
    its own devices and assembles the rows it owns (SURVEY.md call stack 4.5:
    "per-image bytes assembled on owning host"). Single-process runs see every
    row. All arrays must share the same batch sharding.
    """
    rows: dict[int, tuple] = {}
    shards_per_array = [a.addressable_shards for a in arrays]
    for shs in zip(*shards_per_array):
        sl = shs[0].index[0] if shs[0].index else slice(None)
        start = sl.start or 0
        datas = [np.asarray(sh.data) for sh in shs]
        for k in range(datas[0].shape[0]):
            rows.setdefault(start + k, tuple(d[k] for d in datas))
    return rows


def put_batch(arr: np.ndarray, sharding) -> jax.Array:
    """Batch-sharded host->device placement via one plain per-device
    transfer per shard, assembled zero-copy. Multi-host safe: each process
    uploads only its addressable shards.
    """
    idx_map = sharding.addressable_devices_indices_map(arr.shape)
    shards = [jax.device_put(np.ascontiguousarray(arr[idx]), d)
              for d, idx in idx_map.items()]
    return jax.make_array_from_single_device_arrays(
        arr.shape, sharding, shards)


from jpgenc_tpu.utils.lru import LRUCache  # noqa: E402

_PREFIX_GUESS = LRUCache(64)


def _fetch_scan_rows(u, nbits, ovf, cap_u: int, guess_key: tuple,
                     walign: int) -> dict[int, tuple]:
    """Locally-addressable (u_prefix, nbits, ovf) rows of the batch-sharded
    finalize outputs, with ONE speculative device_get per shard: metadata
    plus an adaptively-guessed stream prefix fetched together (each extra
    sync costs a full dispatch; the capacity buffer is mostly empty at
    typical bitrates, so only real bytes should cross the link). Refetches
    only when the guess fell short. Multi-host safe (addressable shards)."""
    from jpgenc_tpu.engine import combined_fetch, fetch_prefix, split_fetch
    rows: dict[int, tuple] = {}
    guess = _PREFIX_GUESS.get(guess_key, 1024)       # u32 words
    # phase 1: enqueue every shard's combined fetch (combined_fetch issues
    # the D2H eagerly) BEFORE consuming any — shard i+1's transfer overlaps
    # shard i's host-side unpack on multi-device meshes
    pend = []
    for su, sn, so in zip(u.addressable_shards, nbits.addressable_shards,
                          ovf.addressable_shards):
        sl = su.index[0] if su.index else slice(None)
        start = sl.start or 0
        handle, k = combined_fetch(su.data, sn.data, so.data, guess)
        pend.append((start, su, sn, handle, k))
    for start, su, sn, handle, k in pend:
        up, nb, ov = split_fetch(np.asarray(handle), k, sn.data.shape[-1])
        t = int(seg_nwords_aligned(nb, walign).sum(axis=-1).max()) \
            if nb.size else 0
        t = min(t, cap_u // 4)
        if t > up.shape[-1]:
            up = fetch_prefix(su.data, t)
        guess = max(guess, t, 1024)
        for j in range(nb.shape[0]):
            rows.setdefault(start + j, (up[j], nb[j], ov[j]))
    _PREFIX_GUESS[guess_key] = guess
    return rows


def _exchange_rows(rows: dict[int, bytes]) -> dict[int, bytes]:
    """All-gather per-row host byte blobs across processes (DCN, host side)."""
    from jpgenc_tpu.parallel import multihost
    if multihost.process_count() == 1:
        return rows
    import pickle
    blobs = multihost.gather_bytes(pickle.dumps(rows))
    merged: dict[int, bytes] = {}
    for blob in blobs:
        merged.update(pickle.loads(blob))
    return merged


# ---------------------------------------------------------------------------
# Batched executables, cached per (layout, batch size, mesh)
# ---------------------------------------------------------------------------

#: bounded LRU (verdict r2 weak #7): long-lived services over heterogeneous
#: layouts/meshes must not accumulate executable sets forever. Keys use
#: plan.key (layout identity), never id(plan) — an evicted plan's id can be
#: reused by the allocator and would alias a stale entry.
_BATCHED = LRUCache(16)


def _batched_fns(plan: DevicePlan, batch: int, mesh: Mesh,
                 caps: tuple[int, int]) -> dict:
    key = (plan.key, batch, tuple(d.id for d in mesh.devices.flat),
           mesh.axis_names, caps)
    hit = _BATCHED.get(key)
    if hit is not None:
        return hit
    cap_u, w_blk = caps
    kernel = pack_kernel_default(list(mesh.devices.flat))

    lay = plan.layout
    wal = walign_for(lay.blocks_per_segment)
    n_seg, words = plan.n_seg, plan.words
    ax = mesh.axis_names[0]
    img_rank = 2 if lay.is_gray else 3
    sh_img = NamedSharding(mesh, P(ax, *([None] * img_rank)))
    rep = NamedSharding(mesh, P())

    def _enc1(img, qtabs, splan, scan_flat, luts):
        blocks = pixels_to_blocks(img, lay, qtabs)
        zz = blocks_to_scan(blocks, scan_flat)
        return scan_to_segments(zz, splan, luts, n_seg, words)

    def _enc1_bytes(img, qtabs, splan, scan_flat, luts):
        zz = pixels_to_scan(img, lay, qtabs)
        w, b, ovf = scan_to_segments_blocked(zz, splan, luts, n_seg, w_blk,
                                             kernel=kernel)
        return wcompact_unstuffed(w, b, cap_u // 4, wal) + (ovf,)

    # optimize-mode pass 1 caches the SCAN-ORDERED zigzag tensor: neither
    # pass pays the raster->scan gather, and pass 2 feeds the entropy stage
    # directly (SURVEY.md call stack 4.3)
    def _zz1(img, qtabs):
        return pixels_to_scan(img, lay, qtabs)

    def _zz1_islow(img, qtabs):
        # libjpeg-exact integer pipeline (conformance mode); scan_flat is a
        # layout-static constant, so the gather folds into the jit
        from jpgenc_tpu.ops.islow import image_to_zigzag_islow
        return image_to_zigzag_islow(img, lay, qtabs)[plan.scan_flat]

    def _hist1(zz, splan):
        return symbol_histogram(zz.astype(jnp.int32), splan)

    def _entropy1_bytes(zz, splan, luts):
        w, b, ovf = scan_to_segments_blocked(zz, splan, luts, n_seg, w_blk,
                                             kernel=kernel)
        return wcompact_unstuffed(w, b, cap_u // 4, wal) + (ovf,)

    sh_blk = NamedSharding(mesh, P(ax, None, None))

    fns = {
        "encode": jax.jit(
            jax.vmap(_enc1, in_axes=(0, None, None, None, None)),
            in_shardings=(sh_img, rep, rep, rep, rep)),
        "encode_bytes": jax.jit(
            jax.vmap(_enc1_bytes, in_axes=(0, None, None, None, None)),
            in_shardings=(sh_img, rep, rep, rep, rep)),
        "zz": jax.jit(
            jax.vmap(_zz1, in_axes=(0, None)),
            in_shardings=(sh_img, rep)),
        # optimize pass 1 in one dispatch: K1 + per-image histograms
        "zz_hist": jax.jit(
            jax.vmap(lambda img, qtabs, splan:
                     (lambda zz: (zz, _hist1(zz, splan)))(_zz1(img, qtabs)),
                     in_axes=(0, None, None)),
            in_shardings=(sh_img, rep, rep)),
        # stripe variant: K1 + GLOBAL histogram (summed over the mesh)
        "zz_hist_sum": jax.jit(
            lambda imgs, qtabs, splan:
            (lambda zz: (zz, jax.vmap(_hist1, in_axes=(0, None))(
                zz, splan).sum(axis=0)))(
                jax.vmap(_zz1, in_axes=(0, None))(imgs, qtabs)),
            in_shardings=(sh_img, rep, rep),
            out_shardings=(sh_blk, rep)),
        # libjpeg-exact integer mode (dct_method='islow')
        "zz_islow": jax.jit(
            jax.vmap(_zz1_islow, in_axes=(0, None)),
            in_shardings=(sh_img, rep)),
        "zz_hist_islow": jax.jit(
            jax.vmap(lambda img, qtabs, splan:
                     (lambda zz: (zz, _hist1(zz, splan)))(
                         _zz1_islow(img, qtabs)),
                     in_axes=(0, None, None)),
            in_shardings=(sh_img, rep, rep)),
        "zz_hist_islow_sum": jax.jit(
            lambda imgs, qtabs, splan:
            (lambda zz: (zz, jax.vmap(_hist1, in_axes=(0, None))(
                zz, splan).sum(axis=0)))(
                jax.vmap(_zz1_islow, in_axes=(0, None))(imgs, qtabs)),
            in_shardings=(sh_img, rep, rep),
            out_shardings=(sh_blk, rep)),
        # per-image custom LUTs (optimize mode): luts batched over axis 0
        "entropy_bytes_perimg": jax.jit(
            jax.vmap(_entropy1_bytes, in_axes=(0, None, 0)),
            in_shardings=(sh_blk, rep, sh_blk)),
        # shared LUTs (striped single image): replicated tables
        "entropy_bytes_shared": jax.jit(
            jax.vmap(_entropy1_bytes, in_axes=(0, None, None)),
            in_shardings=(sh_blk, rep, rep)),
        "hist": jax.jit(
            jax.vmap(_hist1, in_axes=(0, None)),
            in_shardings=(sh_blk, rep)),
        # global histogram reduction: out_shardings pins the psum result to
        # fully-replicated so every host can fetch it (multi-host safe)
        "hist_sum": jax.jit(
            lambda zz, splan: jax.vmap(
                _hist1, in_axes=(0, None))(zz, splan).sum(axis=0),
            in_shardings=(sh_blk, rep), out_shardings=rep),
        "sharding_img": sh_img,
        "caps": caps,
    }
    _BATCHED[key] = fns
    return fns


def _build_tables_from_freq(freq: np.ndarray, n_tabs: int):
    dc = [build_codes(*optimize_tables(freq[0, t].astype(np.int64)))
          for t in range(n_tabs)]
    ac = [build_codes(*optimize_tables(freq[1, t].astype(np.int64)))
          for t in range(n_tabs)]
    return dc, ac


def _batch_setup(imgs, cfg: EncodeConfig, mesh):
    """Shared prologue: mesh resolution, batch padding, plan + executables.

    `imgs` may be a host [B, H, W(, 3)] uint8 array OR a device-resident
    jax.Array (the producer interface: frames already in HBM — e.g.
    decode_batch(to_device=True) output or a data-pipeline tensor — skip
    the host staging entirely)."""
    is_dev = isinstance(imgs, jax.Array)
    if not is_dev:
        imgs = np.ascontiguousarray(imgs)
    mesh = _as_mesh(mesh)
    if mesh is None:
        mesh = default_mesh()
    n_dev = mesh.devices.size
    b = imgs.shape[0]
    pad = (-b) % n_dev
    if pad and is_dev:
        raise ValueError(
            f"device-resident batch of {b} must be a multiple of the mesh's "
            f"{n_dev} devices (host batches are padded automatically)")
    if pad:  # round the batch up to the mesh size; padded outputs are dropped
        imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)], axis=0)
    mode = "gray" if imgs.ndim == 3 else cfg.subsampling
    layout = make_layout(imgs.shape[1], imgs.shape[2], mode,
                         cfg.restart_interval)
    plan = get_plan(layout)
    caps = (scan_caps(layout, cfg.quality, "tight")[0],
            w_blk_for_quality(cfg.quality))
    fns = _batched_fns(plan, imgs.shape[0], mesh, caps)
    return imgs, b, pad, layout, plan, caps, fns


def stage_batch(imgs: np.ndarray, quality: int = 75, subsampling: str = "420",
                restart_interval: int = 0, mesh: Mesh | None = None):
    """Start the async host->device transfer for a batch and return the
    staged handle to pass as encode_batch(..., staged=...).

    device_put returns immediately (PJRT transfers run in the background), so
    staging batch k+1 while batch k encodes overlaps upload with compute —
    the double-buffered input pipeline (batch.run_batch uses this)."""
    cfg = EncodeConfig(quality=quality, subsampling=subsampling,
                       restart_interval=restart_interval)
    imgs, b, pad, layout, plan, caps, fns = _batch_setup(imgs, cfg, mesh)
    return imgs, put_batch(imgs, fns["sharding_img"])


def encode_batch(imgs: np.ndarray, quality: int = 75, subsampling: str = "420",
                 restart_interval: int = 0, optimize: bool = False,
                 mesh: Mesh | None = None, staged=None,
                 dct_method: str = "float") -> list[bytes]:
    """Encode a [B, H, W(, 3)] uint8 batch, sharded over the mesh batch axis.

    Returns one JFIF bytestring per image, identical to per-image `api.encode`.
    `staged` accepts the result of stage_batch(imgs, ...) to reuse an upload
    already in flight. dct_method='islow' selects the libjpeg-exact integer
    pipeline (files byte-identical to libjpeg-turbo per image).

    `imgs` may also be a DEVICE-RESIDENT [B, H, W(, 3)] uint8 jax.Array
    (the producer interface): frames already in HBM — decode_batch(
    to_device=True) output, a training-pipeline tensor — encode without any
    host pixel staging (device-to-device reshard only if the sharding
    differs). B must divide the mesh size.
    """
    cfg = EncodeConfig(quality=quality, subsampling=subsampling,
                       restart_interval=restart_interval,
                       optimize_huffman=optimize, dct_method=dct_method)
    imgs, b, pad, layout, plan, caps, fns = _batch_setup(imgs, cfg, mesh)
    qt_host, qt_dev = qtables_for_quality(cfg.quality)
    if staged is not None:
        imgs, imgs_dev = staged
    elif isinstance(imgs, jax.Array):
        imgs_dev = imgs if imgs.sharding == fns["sharding_img"] else \
            jax.device_put(imgs, fns["sharding_img"])
    else:
        imgs_dev = put_batch(imgs, fns["sharding_img"])

    n_tabs = 1 if layout.is_gray else 2
    islow = cfg.dct_method == "islow"
    if cfg.optimize_huffman:
        zz, hist = (fns["zz_hist_islow"] if islow
                    else fns["zz_hist"])(imgs_dev, qt_dev, plan.plan)
        # per-image histograms live sharded across hosts: each host builds
        # tables for its own rows, then the table blobs are exchanged so
        # every process traces the same replicated luts_b (SPMD requirement)
        local_freq = {i: f[0] for i, f in _local_rows(hist).items()}
        freqs = _exchange_rows(local_freq)
        per_img_tables = [_build_tables_from_freq(freqs[i], n_tabs)
                          for i in range(b)]
        per_img_tables += [per_img_tables[b - 1]] * pad  # padding rows
        luts_list = [luts_from_tables(dc, ac) for dc, ac in per_img_tables]
        luts_b = jax.tree.map(lambda *xs: jnp.stack(xs), *luts_list)
        u, nbytes, ovf = fns["entropy_bytes_perimg"](zz, plan.plan, luts_b)
    else:
        dc_tables, ac_tables = standard_tables()
        luts = luts_from_tables(dc_tables, ac_tables)
        if islow:
            zz = fns["zz_islow"](imgs_dev, qt_dev)
            u, nbytes, ovf = fns["entropy_bytes_shared"](zz, plan.plan, luts)
        else:
            zz = None
            u, nbytes, ovf = fns["encode_bytes"](
                imgs_dev, qt_dev, plan.plan, plan.scan_flat, luts)

    # per-process assembly over addressable shards only (multi-host safe),
    # then host-side exchange so every process returns the full result list
    wal = walign_for(layout.blocks_per_segment)
    rows = _fetch_scan_rows(u, nbytes, ovf, caps[0],
                            ("batch", plan.key, caps), wal)
    zz_rows = None
    local: dict[int, bytes] = {}
    shared_hdr = None if cfg.optimize_huffman else \
        build_headers(layout, list(qt_host), dc_tables, ac_tables)
    for i in sorted(rows):
        if i >= b:
            continue  # batch padding
        ui, nb, ov = rows[i]
        if cfg.optimize_huffman:
            dc_tables, ac_tables = per_img_tables[i]
            hdr = build_headers(layout, list(qt_host), dc_tables, ac_tables)
        else:
            hdr = shared_hdr
        if bool(ov) or int(seg_nwords_aligned(nb, wal).sum()) > caps[0] // 4:
            # rare (noise-like content overflowing the tight tier): re-run
            # only the device finalize for this image at the never-overflowing
            # worst tier, on this process's own devices — the batch stays on
            # the device pipeline (no host word path)
            cap_u3 = scan_caps(layout, cfg.quality, "worst")[0]
            if zz is not None:           # optimize and/or islow: zz cached
                if zz_rows is None:
                    zz_rows = _local_rows(zz)
                luts_i = (luts_from_tables(dc_tables, ac_tables)
                          if cfg.optimize_huffman else luts)
                scan, ok = plan.entropy_scan_bytes_zz(zz_rows[i][0], luts_i,
                                                      cap_u3, 56)
            else:
                if isinstance(imgs, jax.Array):
                    # device-resident input: fetch only the owned row
                    # (global indexing raises on multi-host shardings)
                    img_i = _local_rows(imgs)[i][0]
                else:
                    img_i = np.asarray(imgs[i])
                scan, ok = plan.encode_scan_bytes(img_i, qt_dev,
                                                  luts, cap_u3, 56)
            assert ok, "worst-tier device finalize cannot overflow"
            local[i] = hdr + scan + b"\xff\xd9"
        else:
            local[i] = (hdr + finalize_host_w(ui, nb, 0, len(nb) - 1, wal)
                        + b"\xff\xd9")
    full = _exchange_rows(local)
    return [full[i] for i in range(b)]


# ---------------------------------------------------------------------------
# Stripe mode: one large image across chips
# ---------------------------------------------------------------------------

def _owns_stripe(arr, s: int) -> bool:
    """True when stripe row `s` of the stripe-sharded array lives on one of
    this process's devices."""
    return any((sh.index[0].start or 0) <= s
               < (arr.shape[0] if sh.index[0].stop is None
                  else sh.index[0].stop)
               for sh in arr.addressable_shards)


def _stripe_geometry(layout_h: int, mcu_h: int, n_stripes: int) -> int:
    """Rows of MCUs per stripe (ceil — the tail stripe may be ragged)."""
    mcu_rows = layout_h // mcu_h
    if n_stripes > mcu_rows:
        raise ValueError(
            f"{n_stripes} stripes exceed the image's {mcu_rows} MCU rows")
    return -(-mcu_rows // n_stripes)


def encode_striped(img: np.ndarray, n_stripes: int, quality: int = 75,
                   subsampling: str = "420", restart_interval: int = 0,
                   optimize: bool = False, mesh: Mesh | None = None,
                   dct_method: str = "float") -> bytes:
    """Encode ONE image with its MCU-row stripes sharded over the mesh.

    The emitted file carries restart markers at (at least) stripe boundaries:
    `restart_interval` of 0 selects one segment per stripe-row boundary, i.e.
    DRI = MCUs per stripe; otherwise `restart_interval` must divide the MCU
    count of a stripe so stripe boundaries land on segment boundaries
    (SURVEY.md hard part 5).

    Any image/mesh pair works: when the MCU rows don't divide evenly into
    `n_stripes` (the RAGGED case) every stripe still gets the same padded
    sub-image shape (SPMD needs one shape), the tail stripe's padding-row
    segments are dropped from the emitted scan, and the default DRI becomes
    one MCU row so every kept segment covers whole real rows. An explicit
    `restart_interval` must then divide the MCUs per row. Ragged `optimize`
    histograms are corrected for the padding rows the SPMD pass counted
    (owner-computed deltas, allgathered), so the custom tables equal the
    unsharded encode's.

    dct_method='islow' uses the libjpeg-exact integer pipeline per stripe;
    the striped file is byte-identical to libjpeg-turbo's (image + same
    DRI) for ALL dims: stripe layouts carry the TRUE image width (so
    ops/islow's dummy-column rule applies uniformly), and when the image
    height is not an MCU multiple the last live stripe is re-encoded
    locally under its true-height layout (libjpeg's dummy-row chains),
    replacing its SPMD result — the same local-redo shape as the
    capacity-overflow retry. With optimize=True the SPMD histogram's
    padding-row counts are corrected by an exchanged delta first, so the
    custom tables also match the unsharded encode's.
    """
    img = np.ascontiguousarray(img)
    if isinstance(mesh, MeshConfig):
        # a single image only uses the stripe axis: build a 1-D stripe mesh
        devs = jax.devices()
        ns = mesh.stripe if mesh.stripe > 1 else min(len(devs), n_stripes)
        while n_stripes % ns:
            ns -= 1
        mesh = Mesh(np.array(devs[:ns]), (mesh.stripe_axis,))
    if mesh is None:
        # largest device count dividing n_stripes, so stripes shard evenly
        devs = jax.devices()
        n = len(devs)
        while n_stripes % n:
            n -= 1
        mesh = Mesh(np.array(devs[:n]), ("stripe",))
    mode = "gray" if img.ndim == 2 else subsampling
    h, w = img.shape[0], img.shape[1]
    full = make_layout(h, w, mode, 1)  # probe for MCU geometry/padding
    mcu_h = full.mcu_h
    ph, pw = full.comps[0].plane_h, full.comps[0].plane_w
    mcu_rows = ph // mcu_h
    rows_per_stripe = _stripe_geometry(ph, mcu_h, n_stripes)
    ragged = mcu_rows % n_stripes != 0
    mcus_per_stripe = rows_per_stripe * full.mcus_x
    if ragged:
        # kept segments must cover whole REAL MCU rows so the tail stripe's
        # padding rows form droppable whole segments
        r = restart_interval if restart_interval else full.mcus_x
        if full.mcus_x % r:
            raise ValueError(
                "ragged stripe split: restart_interval must divide the "
                f"{full.mcus_x} MCUs per row")
    else:
        r = restart_interval if restart_interval else mcus_per_stripe
        if mcus_per_stripe % r:
            raise ValueError("restart_interval must divide MCUs per stripe")
    # real MCU rows covered by stripe s (the ragged tail keeps fewer; a
    # stripe past the image keeps none and is dropped entirely)
    rows_kept = [min(rows_per_stripe, max(0, mcu_rows - s * rows_per_stripe))
                 for s in range(n_stripes)]
    segs_kept = [rk * full.mcus_x // r for rk in rows_kept]
    seg_off = np.concatenate([[0], np.cumsum(segs_kept)])
    last_live = max(s for s in range(n_stripes) if segs_kept[s] > 0)

    # replicate-pad on host (ragged: out to the equal-stripe height — SPMD
    # needs one sub-image shape), then view as a batch of stripe sub-images.
    # Width stays the TRUE image width: each stripe's layout then applies
    # the same horizontal edge convention as api.encode (for islow, the
    # libjpeg dummy-column rule) instead of seeing pre-padded pixels.
    ph_s = n_stripes * rows_per_stripe * mcu_h
    pad_spec = [(0, ph_s - h), (0, 0)] + \
        ([(0, 0)] if img.ndim == 3 else [])
    padded = np.pad(img, pad_spec, mode="edge")
    stripes = padded.reshape((n_stripes, rows_per_stripe * mcu_h, w)
                             + ((3,) if img.ndim == 3 else ()))

    stripe_layout = make_layout(stripes.shape[1], w, mode, r)
    # libjpeg's vertical dummy-row geometry exists only where the TRUE
    # image bottom edge sits mid-MCU — the last live stripe; its scan is
    # re-encoded locally under the true-height layout below (islow only:
    # the float path's replicate-pad convention matches api.encode as-is)
    tail_fix = (dct_method == "islow") and (h % mcu_h != 0)
    tail_h = h - last_live * rows_per_stripe * mcu_h
    tail_img = img[last_live * rows_per_stripe * mcu_h:h]
    tail_layout = make_layout(tail_h, w, mode, r) if tail_fix else None
    if tail_fix:
        assert tail_layout.n_segments == segs_kept[last_live]
    plan = get_plan(stripe_layout)
    caps = (scan_caps(stripe_layout, quality, "tight")[0],
            w_blk_for_quality(quality))
    fns = _batched_fns(plan, n_stripes, mesh, caps)
    qt_host, qt_dev = qtables_for_quality(quality)
    stripes_dev = put_batch(stripes, fns["sharding_img"])
    n_tabs = 1 if stripe_layout.is_gray else 2
    assert stripe_layout.n_segments == mcus_per_stripe // r

    islow = dct_method == "islow"
    if islow:
        EncodeConfig(quality=quality, subsampling=subsampling,
                     dct_method=dct_method)   # validate
    tail_zz = None
    if optimize:
        # transform + global histogram in one dispatch (a psum over the
        # stripe axis)
        zz, freq_dev = (fns["zz_hist_islow_sum"] if islow
                        else fns["zz_hist_sum"])(stripes_dev, qt_dev,
                                                 plan.plan)
        freq = np.asarray(freq_dev)
        # Stripes containing rows the unsharded encode never histograms
        # (ragged padding rows, or the islow tail whose dummy-row geometry
        # differs from replicate-pad) get their SPMD contribution swapped
        # for the true one, so the custom tables equal the unsharded
        # encode's for ALL dims. Owners compute the deltas locally; every
        # process calls the allgather (uniform collective).
        fix = {s for s in range(n_stripes)
               if rows_kept[s] < rows_per_stripe}
        if tail_fix:
            fix.add(last_live)
        if fix:
            def _hist(p, im):
                f = (p.zz_islow_and_histogram if islow
                     else p.zz_and_histogram)
                return f(jnp.asarray(np.ascontiguousarray(im)), qt_dev)

            delta = np.zeros_like(freq)
            for s in sorted(fix):
                if not _owns_stripe(stripes_dev, s):
                    continue
                delta = delta - np.asarray(_hist(plan, stripes[s])[1])
                if rows_kept[s]:
                    # only the boundary stripe keeps rows; its true
                    # contribution uses the tail layout (libjpeg dummy
                    # rows for islow, replicate-pad for float)
                    tlay = make_layout(tail_h, w, mode, r)
                    zz_s, f_true = _hist(get_plan(tlay), tail_img)
                    delta = delta + np.asarray(f_true)
                    if tail_fix:
                        tail_zz = zz_s
            from jpgenc_tpu.parallel import multihost
            if multihost.process_count() > 1:
                from jax.experimental import multihost_utils
                delta = np.sum(multihost_utils.process_allgather(delta),
                               axis=0)
            freq = freq + delta
        dc_tables, ac_tables = _build_tables_from_freq(freq, n_tabs)
        luts = luts_from_tables(dc_tables, ac_tables)
        u, nbytes, ovf = fns["entropy_bytes_shared"](zz, plan.plan, luts)
    else:
        dc_tables, ac_tables = standard_tables()
        luts = luts_from_tables(dc_tables, ac_tables)
        if islow:
            zz = fns["zz_islow"](stripes_dev, qt_dev)
            u, nbytes, ovf = fns["entropy_bytes_shared"](zz, plan.plan, luts)
        else:
            zz = None
            u, nbytes, ovf = fns["encode_bytes"](
                stripes_dev, qt_dev, plan.plan, plan.scan_flat, luts)

    # per-process assembly: each host finalizes its own stripes' bytes with
    # GLOBAL RSTn numbering (addressable shards only — multi-host safe), then
    # the per-stripe blobs are exchanged over DCN and concatenated into ONE
    # scan on every process (SURVEY.md hard part 5 / call stack 4.5)
    wal = walign_for(stripe_layout.blocks_per_segment)
    rows = _fetch_scan_rows(u, nbytes, ovf, caps[0],
                            ("stripe", plan.key, caps), wal)
    zz_rows = None
    local: dict[int, bytes] = {}
    for s in sorted(rows):
        if segs_kept[s] == 0:
            local[s] = b""        # pure-padding stripe past the image
            continue
        us, nb, ov = rows[s]
        g0 = int(seg_off[s])
        # trailing RSTn after every kept segment except the scan's last
        n_rst_s = segs_kept[s] - (1 if s == last_live else 0)
        if s == last_live and tail_fix:
            # libjpeg dummy-row geometry: re-encode the tail stripe locally
            # under its TRUE-height layout (same local-redo shape as the
            # overflow retry below), discarding its SPMD result
            tplan = get_plan(tail_layout)
            cap_u3 = scan_caps(tail_layout, quality, "worst")[0]
            if tail_zz is None:
                tail_zz = tplan.zz_scan_islow(jnp.asarray(tail_img), qt_dev)
            part, ok = tplan.entropy_scan_bytes_zz(
                tail_zz, luts, cap_u3, 56,
                first_rst=g0, n_rst=n_rst_s, n_seg_keep=segs_kept[s])
            assert ok, "worst-tier device finalize cannot overflow"
            local[s] = part
            continue
        if bool(ov) or int(seg_nwords_aligned(nb, wal).sum()) > caps[0] // 4:
            # rare: redo only this stripe's device finalize at the
            # never-overflowing worst tier on this process's devices
            cap_u3 = scan_caps(stripe_layout, quality, "worst")[0]
            if zz is not None:           # optimize and/or islow: zz cached
                if zz_rows is None:
                    zz_rows = _local_rows(zz)
                part, ok = plan.entropy_scan_bytes_zz(
                    zz_rows[s][0], luts, cap_u3, 56,
                    first_rst=g0, n_rst=n_rst_s, n_seg_keep=segs_kept[s])
            else:
                part, ok = plan.encode_scan_bytes(
                    stripes[s], qt_dev, luts, cap_u3, 56,
                    first_rst=g0, n_rst=n_rst_s, n_seg_keep=segs_kept[s])
            assert ok, "worst-tier device finalize cannot overflow"
            local[s] = part
        else:
            local[s] = finalize_host_w(us, nb[:segs_kept[s]], g0, n_rst_s,
                                       wal)
    full = _exchange_rows(local)
    scan = b"".join(full[s] for s in range(n_stripes))

    # headers describe the FULL image with DRI = r
    file_layout = make_layout(h, w, mode, r)
    assert file_layout.n_segments == int(seg_off[-1]), \
        "stripe segment accounting disagrees with the file layout"
    hdr = build_headers(file_layout, list(qt_host), dc_tables, ac_tables)
    return hdr + scan + b"\xff\xd9"


# ---------------------------------------------------------------------------
# Sharded batch DECODE (layer G, the inverse of encode_batch): JPEG files ->
# pixels sharded over the mesh batch axis. The production shape is
# to_device=True — decoded pixels stay in HBM as one sharded [B, H, W(,3)]
# array feeding a training-input pipeline; nothing crosses back to hosts.
# ---------------------------------------------------------------------------

_DEC_FNS = LRUCache(16)


def decode_batch(datas: list[bytes], mesh: Mesh | None = None,
                 to_device: bool = True):
    """Decode same-geometry baseline JPEGs sharded over the mesh batch axis.

    Host side: each process parses headers for every file but
    entropy-decodes (native C++ under a thread pool) ONLY the images whose
    batch rows live on its own devices; coefficients cross the link in the
    sparse [3, cap] int16 form (decoder._sparsify) and are densified inside
    the single vmapped reconstruction dispatch.

    to_device=True (default) returns the sharded [B, H, W(,3)] uint8
    jax.Array. to_device=False downloads and returns a per-image list —
    single-process meshes only (decoded pixels are deliberately never
    gathered across hosts; fetch shards from the returned array instead).
    """
    from concurrent.futures import ThreadPoolExecutor

    from jpgenc_tpu.container.parser import parse_jpeg
    from jpgenc_tpu.decoder import (_densify, _densify_packed, _exc_cap,
                                    _pad_packed, _packed_wins, _qts_of,
                                    _rows_from_pairs, _sparse_cap,
                                    _sparse_wins, layout_from_parsed,
                                    pixel_fn, scan_packed, scan_pairs)
    from jpgenc_tpu.parallel import multihost

    if not datas:
        return []
    mesh = _as_mesh(mesh) or default_mesh()
    if mesh.devices.ndim != 1:
        raise ValueError("decode_batch expects a 1-D ('batch',) mesh")
    if not to_device and multihost.process_count() > 1:
        raise ValueError("to_device=False on a multi-host mesh: pixels are "
                         "not gathered across hosts — use to_device=True "
                         "and read your process's addressable shards")

    parsed = [parse_jpeg(d) for d in datas]

    def _geom(p):
        # the segment layout drives the scan decode, so the restart
        # interval is part of the geometry
        return (p.height, p.width, p.subsampling, p.restart_interval)

    if any(_geom(p) != _geom(parsed[0]) for p in parsed):
        raise ValueError("decode_batch requires same-geometry inputs "
                         "(height, width, subsampling, restart interval)")
    layout = layout_from_parsed(parsed[0])
    n_total = sum(c.n_blocks for c in layout.comps)
    n_comps = len(layout.comps)

    b = len(datas)
    n_dev = mesh.devices.size
    pad = (-b) % n_dev
    B = b + pad
    parsed = parsed + [parsed[-1]] * pad

    # rows this process owns (contiguous batch sharding)
    rows_per = B // n_dev
    owned = sorted(
        {d_i * rows_per + k
         for d_i, dev in enumerate(mesh.devices.flat)
         if dev.process_index == jax.process_index()
         for k in range(rows_per)})

    # batch-padding rows duplicate the last image: decode each distinct
    # image once and alias the pad rows to its pairs
    uniq = sorted({min(i, b - 1) for i in owned})
    # across-image parallelism via the pool; within-image segment threading
    # (auto) only when this process owns a single distinct image
    nth = 1 if len(uniq) > 1 else 0
    n64 = n_total * 64

    # preferred form: packed 2-byte (delta, val) streams (3x fewer upload
    # bytes than pair rows — the H2D link is the decode bottleneck);
    # per-frame cap buckets keep the vmapped SPMD structure
    with ThreadPoolExecutor(max_workers=min(8, max(len(uniq), 1))) as ex:
        upk = dict(zip(uniq, ex.map(
            lambda i: scan_packed(parsed[i], layout, n_threads=nth), uniq)))
    packed = {i: upk[min(i, b - 1)] for i in owned}
    # SPMD: the form gate must AGREE across processes — a process whose
    # image hit the packed fallback (or whose native build failed) must not
    # enter a different branch and issue mismatched collectives/jits, so
    # the agreement bit rides the SAME allgather as the capacity maxima.
    ok = int(all(p is not None for p in packed.values()))
    nm = max((p[0].shape[0] for p in packed.values() if p is not None),
             default=1)
    ne = max((p[1].size for p in packed.values() if p is not None),
             default=0)
    if multihost.process_count() > 1:
        from jax.experimental import multihost_utils
        agg = multihost_utils.process_allgather(
            np.array([ok, nm, ne], np.int64))
        ok = int(np.min(agg[..., 0]))
        nm, ne = int(np.max(agg[..., 1])), int(np.max(agg[..., 2]))
    form = None
    if ok:
        cap_m, cap_e = _sparse_cap(nm), _exc_cap(ne)
        if _packed_wins(cap_m, cap_e, n64):
            form = "packed"
    if not form:
        # pairs fallback: reuse any already-decoded packed stream instead of
        # entropy-decoding its scan a second time; only frames whose packed
        # form was unavailable re-decode
        from jpgenc_tpu.decoder import _pairs_from_packed
        redo = [i for i in uniq if upk[i] is None]
        upairs = {i: _pairs_from_packed(upk[i], layout)
                  for i in uniq if upk[i] is not None}
        if redo:
            with ThreadPoolExecutor(max_workers=min(8, len(redo))) as ex:
                upairs.update(zip(redo, ex.map(
                    lambda i: scan_pairs(parsed[i], layout, n_threads=nth),
                    redo)))
        pairs = {i: upairs[min(i, b - 1)] for i in owned}
        nnz = max((i.size for i, _ in pairs.values()), default=1)
        if multihost.process_count() > 1:
            from jax.experimental import multihost_utils
            nnz = int(np.max(multihost_utils.process_allgather(
                np.int64(nnz))))
        cap = _sparse_cap(nnz)
        form = "pairs" if _sparse_wins(cap, n64) else "dense"

    qt = np.zeros((B, n_comps, 64), np.int32)
    if form == "packed":
        mains = np.zeros((B, cap_m, 2), np.uint8)
        mains[..., 0] = 255                    # phantom pads for unowned rows
        excs = np.zeros((B, 3, cap_e), np.int16)
        excs[:, :2, :] = np.int16(-1)          # idx -1: dropped by scatter
        for i in owned:
            m_i, e_i, v_i = packed[i]
            mains[i], excs[i] = _pad_packed(m_i, e_i, v_i, cap_m, cap_e, n64)
        ins = (mains, excs)
        sh_in = (NamedSharding(mesh, P("batch", None, None)),) * 2
    elif form == "pairs":
        sp = np.zeros((B, 3, cap), np.int16)
        for i in owned:
            sp[i] = _rows_from_pairs(*pairs[i], n64, cap)
        ins = (sp,)
        sh_in = (NamedSharding(mesh, P("batch", None, None)),)
    else:
        sp = np.zeros((B, n_total, 64), np.int16)
        for i in owned:
            sp[i].reshape(-1)[pairs[i][0]] = pairs[i][1]
        ins = (sp,)
        sh_in = (NamedSharding(mesh, P("batch", None, None)),)
    for i in owned:
        for ci, q in enumerate(_qts_of(parsed[i])):
            qt[i, ci] = np.asarray(q).reshape(64)

    sh_qt = NamedSharding(mesh, P("batch", None, None))
    sh_img = NamedSharding(
        mesh, P("batch", *([None] * (2 if layout.is_gray else 3))))

    fkey = (layout.height, layout.width, layout.subsampling, mesh, B, form)
    fn = _DEC_FNS.get(fkey)
    if fn is None:
        _pix = pixel_fn(layout)

        if form == "packed":
            sf_ext = jnp.asarray(np.append(
                np.asarray(layout.scan_flat, np.int64),
                n_total).astype(np.int32))

            def _dec1(m1, e1, qt1):
                return _pix(_densify_packed(m1, e1, sf_ext, n_total),
                            [qt1[i] for i in range(n_comps)])
        elif form == "pairs":
            def _dec1(sp1, qt1):
                return _pix(_densify(sp1, n_total),
                            [qt1[i] for i in range(n_comps)])
        else:
            def _dec1(sp1, qt1):
                return _pix(sp1, [qt1[i] for i in range(n_comps)])

        fn = jax.jit(jax.vmap(_dec1), in_shardings=(*sh_in, sh_qt),
                     out_shardings=sh_img)
        _DEC_FNS[fkey] = fn

    out = fn(*(put_batch(a, s) for a, s in zip(ins, sh_in)),
             put_batch(qt, sh_qt))
    if to_device:
        return out[:b] if pad else out
    arr = np.asarray(out)
    return [arr[i] for i in range(b)]
