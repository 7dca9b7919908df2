"""scripts/stage_times.py at a tiny size on the CPU: both cells run every
stage, kernel A (interpret mode) matches the XLA pack, and each encode
step reports its memory analysis."""
import importlib.util
import os

import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "stage_times.py")
_spec = importlib.util.spec_from_file_location("stage_times", _PATH)
stage_times = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(stage_times)


@pytest.mark.parametrize("quality,dri,w_blk", [(75, 0, 8), (95, 120, 16)])
def test_cell_tiny(quality, dri, w_blk):
    out = stage_times.cell(2, quality, dri, 1, hw=(48, 64), interpret=True)
    assert out["kernel_equals_xla"]
    assert out["w_blk"] == w_blk
    assert 0 < out["max_block_bits"] <= 32 * w_blk
    assert set(out["ms"]) == {
        "transform", "pack_xla", "pack_kernel", "segment_merge",
        "compaction", "encode_step_xla", "encode_step_kernel",
        "reconstruction"}
    assert all(t > 0 for t in out["ms"].values())
    for step in ("encode_step_xla", "encode_step_kernel"):
        assert out["memory"][step]["argument_size_in_bytes"] > 0
