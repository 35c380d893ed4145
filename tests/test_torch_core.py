"""Port parity: core (types, environment, Grid, DistMatrix).

Each input is made with numpy from a seed and given to the JAX package and
to its PyTorch port; results are compared on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import elementalx_torch as Et
from elementalx_torch.core import types as ttypes
from elementalx_torch.core.dmatrix import DistMatrix, padded_extent

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers at once: keep torch to one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cpu_grid():
    return Et.Grid("cpu")


def test_import_leaves_jax_out():
    """The port imports torch and never jax, even indirectly."""
    code = ("import sys, elementalx_torch, elementalx_torch.entry; "
            "sys.exit(1 if any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules) else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", [
    "Dist", "DistWrap", "UpperOrLower", "Orientation", "LeftOrRight",
    "UnitOrNonUnit", "ForwardOrBackward", "Conjugation",
    "VerticalOrHorizontal", "SortType", "GemmAlgorithm"])
def test_enums_match_reference(name):
    """Same members with the same values, so tags map across by name."""
    from elementalx.core import types as jtypes

    ref = {m.name: int(m) for m in getattr(jtypes, name)}
    port = {m.name: int(m) for m in getattr(ttypes, name)}
    assert port == ref


def test_dist_helpers_match_reference():
    from elementalx.core import types as jtypes

    for U in jtypes.Dist:
        Ut = ttypes.Dist[U.name]
        assert jtypes.Collect(U).name == ttypes.Collect(Ut).name
        assert jtypes.Partial(U).name == ttypes.Partial(Ut).name
    for U, V in ((jtypes.MC, jtypes.MR), (jtypes.MR, jtypes.MC),
                 (jtypes.STAR, jtypes.STAR), (jtypes.VC, jtypes.STAR)):
        Ut, Vt = ttypes.Dist[U.name], ttypes.Dist[V.name]
        assert jtypes.DiagCol(U, V).name == ttypes.DiagCol(Ut, Vt).name
        assert jtypes.DiagRow(U, V).name == ttypes.DiagRow(Ut, Vt).name
    assert [tuple(d.name for d in p) for p in jtypes.ALL_DISTS] == \
        [tuple(d.name for d in p) for p in ttypes.ALL_DISTS]


def test_grid_is_one_device(cpu_grid):
    assert (cpu_grid.height, cpu_grid.width, cpu_grid.size) == (1, 1, 1)
    assert cpu_grid.device == torch.device("cpu")
    assert cpu_grid == Et.Grid(torch.device("cpu"))
    assert Et.Grid.default() is Et.Grid.default()


def test_blocksize_stack():
    base = Et.Blocksize()
    with Et.blocksize(7):
        assert Et.Blocksize() == 7
        with Et.blocksize(3):
            assert Et.Blocksize() == 3
        assert Et.Blocksize() == 7
    assert Et.Blocksize() == base
    with pytest.raises(Et.LogicError):
        Et.PopBlocksizeStack()


@pytest.mark.parametrize("shape", [(13, 7), (1, 1), (0, 5), (40, 40)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_from_global_round_trip(cpu_grid, shape, dtype):
    rng = np.random.default_rng(1)
    a = rng.standard_normal(shape).astype(dtype)
    A = DistMatrix.from_global(a, grid=cpu_grid)
    assert A.shape == shape
    assert A.padded_shape == (padded_extent(shape[0], cpu_grid),
                              padded_extent(shape[1], cpu_grid))
    A.check_valid()
    np.testing.assert_array_equal(A.global_array(), a)
    assert A.dist == (Et.MC, Et.MR)


@pytest.mark.parametrize("dist", [(ttypes.MC, ttypes.MR),
                                  (ttypes.STAR, ttypes.STAR),
                                  (ttypes.VC, ttypes.STAR)])
def test_from_reference_carries_state(cpu_grid, grid, dist):
    """A JAX DistMatrix on the 4x2 test grid (padded to multiples of 8)
    arrives in the port with the same logical contents and metadata."""
    from elementalx import DistMatrix as JDistMatrix
    from elementalx.core import types as jtypes

    rng = np.random.default_rng(2)
    a = rng.standard_normal((13, 6))
    jd = tuple(getattr(jtypes, d.name) for d in dist)
    J = JDistMatrix.from_global(a, *jd, grid=grid)
    assert J.padded_shape != (13, 6)
    P = DistMatrix.from_reference(np.asarray(J.data), J.m, J.n, *dist,
                                  grid=cpu_grid)
    assert (P.m, P.n, P.dist) == (J.m, J.n, dist)
    assert P.padded_shape == (13, 6)
    np.testing.assert_array_equal(P.global_array(), J.global_array())
    P.check_valid()


def test_from_reference_rejects_dirty_padding(cpu_grid):
    data = np.zeros((8, 8))
    data[:5, :5] = 1.0
    data[6, 1] = 3.0
    with pytest.raises(AssertionError):
        DistMatrix.from_reference(data, 5, 5, grid=cpu_grid)


def test_padding_invariant_helpers(cpu_grid):
    """mask_padding / mask_like / canonical zero everything outside (m, n),
    as the JAX helpers do."""
    import jax
    import elementalx as El
    from elementalx import DistMatrix as JDistMatrix

    rng = np.random.default_rng(3)
    full = rng.standard_normal((9, 11))
    jgrid = El.Grid(devices=jax.devices()[:1])
    J = JDistMatrix.from_padded(full, 5, 7, grid=jgrid)
    P = DistMatrix(torch.as_tensor(full), 5, 7, grid=cpu_grid)
    np.testing.assert_array_equal(
        P.mask_padding(P.data).numpy(), np.asarray(J.mask_padding(J.data)))
    np.testing.assert_array_equal(
        P.mask_like(P.data).numpy(), np.asarray(J.mask_like(J.data)))
    np.testing.assert_array_equal(P.canonical().data.numpy(),
                                  np.asarray(J.canonical().data))
    with pytest.raises(AssertionError):
        P.check_valid()
    P.canonical().check_valid()
    np.testing.assert_array_equal(P.pad_mask().numpy(),
                                  np.asarray(J.pad_mask()))


def test_redistribute_only_retags(cpu_grid):
    A = DistMatrix.from_global(np.arange(12.0).reshape(3, 4), grid=cpu_grid)
    B = A.redistribute(ttypes.STAR, ttypes.VR)
    assert B.dist == (ttypes.STAR, ttypes.VR)
    assert B.data is A.data
    assert A.redistribute(ttypes.MC, ttypes.MR) is A


def test_with_data_and_bf16_host_copy(cpu_grid):
    a = np.linspace(-1, 1, 12).reshape(3, 4).astype(np.float32)
    A = DistMatrix.from_global(torch.as_tensor(a).to(torch.bfloat16),
                               grid=cpu_grid)
    assert A.dtype == torch.bfloat16
    out = A.global_array()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, a, atol=1e-2)   # bf16 keeps 8 bits
    B = A.with_data(A.data * 2)
    assert B.shape == A.shape and B.dist == A.dist
