"""Every chip_smoke.py phase at a tiny size on the CPU: the same calls and
comparisons the GPU run makes, so a wrong path or argument shows here
first."""
import json

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import chip_smoke as S


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("batch",))


@pytest.fixture(scope="module")
def flagship(mesh):
    return S.phase_flagship(mesh, 48, 64, 3)


def test_phase_flagship(flagship):
    frames, files = flagship
    assert len(files) == 3
    assert all(f[:2] == b"\xff\xd8" and f[-2:] == b"\xff\xd9" for f in files)


def test_phase_tiers(mesh):
    S.phase_tiers(mesh, 48, 64, 2)


def test_phase_islow(mesh):
    S.phase_islow(mesh, 40, 56, 2)


def test_phase_optimize(mesh):
    S.phase_optimize(mesh, (64, 96), 48, 64, 2)


def test_phase_decode(flagship):
    S.phase_decode(flagship[1], chunk=2)


def test_phase_cards():
    S.phase_cards(jax.devices()[:4], (48, 64), 4, (64, 96), n_stripes=4)


def test_check_close_tolerances():
    a = np.zeros(10_000, np.int32)
    b = a.copy()
    b[0] = 1
    assert S.check_close(b, a, 1e-4, "x")["n_diff"] == 1
    with pytest.raises(AssertionError):
        S.check_close(b, a, 0.0, "exact")
    b[0] = 2
    with pytest.raises(AssertionError):
        S.check_close(b, a, 1e-4, "max diff")


def test_main_refuses_cpu(capsys):
    assert S.main([]) == 2
    out = capsys.readouterr().out.strip().splitlines()
    for line in out:
        with pytest.raises(ValueError):
            json.loads(line)
