"""Bounded process-wide executable caches (round-2 verdict weak #7).

The engine/mesh/decoder modules cache compiled pipelines keyed by layout,
mesh, and capacity tuples; a long-lived service over heterogeneous image
sizes must see those caches stay bounded, and an evicted entry must be
rebuilt correctly (identical bytes/pixels) on the next use.
"""
import numpy as np
import pytest

from jpgenc_tpu.utils.lru import LRUCache


def test_lru_semantics():
    c = LRUCache(2)
    c["a"] = 1
    c["b"] = 2
    assert c.get("a") == 1            # refreshes "a"
    c["c"] = 3                        # evicts the stale "b"
    assert "b" not in c and "a" in c and "c" in c and len(c) == 2
    assert c.get("missing") is None
    assert c.get("missing", 7) == 7
    c["a"] = 10                       # overwrite refreshes, no growth
    assert c["a"] == 10 and len(c) == 2
    with pytest.raises(ValueError):
        LRUCache(0)


def _img(h, w, chans=3, seed=0):
    rng = np.random.default_rng(seed)
    # low-entropy content keeps the tight capacity tier (fewest compiles)
    base = np.zeros((h, w, chans) if chans else (h, w), np.uint8)
    base[::4, ::4] = rng.integers(0, 64)
    return base


def test_plan_and_recon_caches_bounded(monkeypatch):
    """Churn more layouts than the (shrunk) caps; sizes stay bounded and an
    evicted layout re-encodes/decodes to identical results."""
    from jpgenc_tpu import api, decoder, engine

    monkeypatch.setattr(engine._PLANS, "maxsize", 2)
    monkeypatch.setattr(decoder._RECON, "maxsize", 2)

    img = _img(24, 24)
    ref = api.encode(img, quality=75)
    ref_px = api.decode(ref)

    for h in (8, 16, 32):             # 3 distinct layouts > cap of 2
        f = api.encode(_img(h, 8, chans=0), quality=75)
        api.decode(f)
        assert len(engine._PLANS) <= 2
        assert len(decoder._RECON) <= 2

    # the 24x24 plan/recon entries were evicted above; rebuilding them must
    # reproduce the exact same bytes and pixels
    assert api.encode(img, quality=75) == ref
    np.testing.assert_array_equal(api.decode(ref), ref_px)


def test_batched_cache_bounded(monkeypatch):
    """_BATCHED eviction + rebuild: keys use the layout identity (plan.key),
    never id(plan), so an evicted-and-reallocated DevicePlan can't alias a
    stale executable set."""
    import jax
    from jax.sharding import Mesh

    from jpgenc_tpu import engine
    from jpgenc_tpu.parallel import mesh as M

    monkeypatch.setattr(M._BATCHED, "maxsize", 1)
    monkeypatch.setattr(engine._PLANS, "maxsize", 1)
    mesh = Mesh(np.array(jax.devices()[:2]), ("batch",))

    a16 = np.stack([_img(16, 16, seed=s) for s in range(2)])
    a8 = np.stack([_img(8, 8, seed=s) for s in range(2)])
    ref = M.encode_batch(a16, quality=75, mesh=mesh)
    M.encode_batch(a8, quality=75, mesh=mesh)      # evicts the 16x16 entry
    assert len(M._BATCHED) <= 1
    assert M.encode_batch(a16, quality=75, mesh=mesh) == ref


def test_compile_cache_location(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache goes to <checkout>/.jax_cache."""
    import os

    import jax

    from jpgenc_tpu.utils import compile_cache as CC
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert CC.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert CC.enable_compile_cache() == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir",
                      os.path.join(root, ".jax_cache"))]
