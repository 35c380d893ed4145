"""Port parity: the grid of several positions, the sharded DistMatrix, the
redistributions and the collectives.

The port's grids here are virtual: every position on the CPU, as the JAX
tests' mesh is 8 virtual CPU devices (the ``grid`` fixture, 4x2, and
``square_grid``, 2x2). Each input is made with numpy from a seed and given
to both packages; layouts and redistributions are compared exactly.
"""

import numpy as np
import pytest
import torch

import elementalx as El
import elementalx_torch as Et
from elementalx_torch.core import collectives
from elementalx_torch.core import redistribute as tcopy
from elementalx_torch.core import types as T
from elementalx_torch.core.grid import default_grid_height

DIST_IDS = [f"{d[0].name}_{d[1].name}" for d in T.ALL_DISTS]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers at once: keep torch to one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tgrid():
    """The port's 4x2 grid, every position on the CPU."""
    return Et.Grid(["cpu"] * 8, height=4)


@pytest.fixture(scope="module")
def tsquare():
    return Et.Grid(["cpu"] * 4, height=2)


def _jd(dist):
    return tuple(getattr(El, d.name) for d in dist)


def _mk(rng, m, n, grid, dist, dtype=np.float64):
    a = rng.standard_normal((m, n)).astype(dtype)
    return a, Et.DistMatrix.from_global(a, *dist, grid=grid)


def _jax_blocks(J, jgrid):
    """The JAX array's shard on each mesh position, mc-major."""
    where = {d: q for q, d in enumerate(np.asarray(jgrid.mesh.devices).ravel())}
    out = [None] * jgrid.size
    for shard in J.data.addressable_shards:
        out[where[shard.device]] = np.asarray(shard.data)
    return out


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


def test_grid_raises_without_cuda(monkeypatch):
    """No silent CPU grid: Grid() and the default grid take cuda:0 and
    raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(Et.Grid, "_default", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Et.Grid()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Et.Grid.default()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Et.DistMatrix.from_global(np.eye(3))
    from elementalx_torch.entry import make_hpd_problem

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_hpd_problem(4, 1)
    cpu = Et.Grid("cpu")
    Et.Grid.set_default(cpu)
    assert Et.Grid.default() is cpu


def test_grid_properties(tgrid):
    """Reference: tests/core/test_distmatrix.py:99-105."""
    g = El.Grid(height=4)
    assert (tgrid.height, tgrid.width, tgrid.size) == (g.height, g.width,
                                                        g.size) == (4, 2, 8)
    assert (tgrid.lcm, tgrid.gcd) == (g.lcm, g.gcd) == (4, 2)
    for p in (8, 16, 7, 1, 12):
        assert default_grid_height(p) == El.default_grid_height(p)
    assert Et.Grid(["cpu"] * 8).height == El.Grid().height == 2
    assert Et.Grid("cpu").size == 1


def test_grid_equality_by_layout():
    a = Et.Grid(["cpu"] * 4, height=2)
    assert a == Et.Grid([torch.device("cpu")] * 4, height=2)
    assert hash(a) == hash(Et.Grid(["cpu"] * 4, height=2))
    assert a != Et.Grid(["cpu"] * 4, height=1)
    assert Et.Grid("cpu") == Et.Grid(["cpu"], height=1)
    with pytest.raises(ValueError):
        Et.Grid(["cpu"] * 6, height=4)


def test_grid_groups_are_the_mesh_axes(tgrid):
    """MC is a grid column, MR a grid row, VC mc-major, VR mr-major."""
    assert tgrid.group("mc", 3) == [1, 3, 5, 7]
    assert tgrid.group("mr", 3) == [2, 3]
    assert tgrid.group("vc", 0) == list(range(8))
    assert tgrid.group("vr", 0) == [0, 2, 4, 6, 1, 3, 5, 7]
    assert [tgrid.part(T.VR, q) for q in range(8)] == [0, 4, 1, 5, 2, 6, 3, 7]
    assert [tgrid.part(T.MD, q) for q in range(8)] == list(range(8))


def test_invalid_dist_pair(tgrid):
    """Reference: tests/core/test_distmatrix.py:108-112."""
    with pytest.raises(ValueError):
        tgrid.check_pair(T.MC, T.MC)
    with pytest.raises(ValueError):
        tgrid.check_pair(T.VC, T.MR)
    with pytest.raises(ValueError):
        Et.DistMatrix.from_global(np.eye(4), T.MC, T.MC, grid=tgrid)


# ---------------------------------------------------------------------------
# the layout: the port's block at each position is the JAX shard there
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dist", T.ALL_DISTS, ids=DIST_IDS)
def test_blocks_equal_jax_shards(grid, tgrid, dist):
    rng = np.random.default_rng(20)
    a = rng.standard_normal((13, 7))
    J = El.DistMatrix.from_global(a, *_jd(dist), grid=grid)
    P = Et.DistMatrix.from_global(a, *dist, grid=tgrid)
    assert P.padded_shape == tuple(J.padded_shape)
    for q, (jb, tb) in enumerate(zip(_jax_blocks(J, grid), P.blocks)):
        np.testing.assert_array_equal(tb.numpy(), jb, err_msg=f"position {q}")
    P.check_valid()
    np.testing.assert_array_equal(P.global_array(), a)


@pytest.mark.parametrize("dist", [(T.MC, T.MR), (T.VR, T.STAR),
                                  (T.STAR, T.MD)], ids=lambda d: d[0].name)
def test_from_reference_on_a_sharded_jax_matrix(grid, tgrid, dist):
    """A JAX DistMatrix sharded on the 4x2 mesh becomes the port's
    DistMatrix on a 4x2 grid with the same blocks."""
    rng = np.random.default_rng(21)
    a = rng.standard_normal((11, 9))
    J = El.DistMatrix.from_global(a, *_jd(dist), grid=grid)
    P = Et.DistMatrix.from_reference(np.asarray(J.data), J.m, J.n, *dist,
                                     grid=tgrid)
    assert P.sharded and (P.m, P.n, P.dist) == (J.m, J.n, dist)
    for jb, tb in zip(_jax_blocks(J, grid), P.blocks):
        np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(P.global_array(), J.global_array())


def test_sharded_matrix_has_no_global_tensor(tgrid):
    """No code reads a gathered tensor behind the caller's back: data, the
    masks and the level-1 operations outside the GEMM path raise."""
    _, A = _mk(np.random.default_rng(22), 6, 6, tgrid, (T.MC, T.MR))
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        A.data
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        A.pad_mask()
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        Et.Hadamard(A, A)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        Et.Cholesky(Et.LOWER, A)
    with pytest.raises(ValueError):
        Et.DistMatrix(torch.zeros(8, 8), 6, 6, grid=tgrid)


def test_check_valid_and_canonical_on_blocks(tgrid):
    a, A = _mk(np.random.default_rng(23), 13, 7, tgrid, (T.VC, T.STAR))
    A.check_valid()
    assert A.canonical() is A
    dirty = list(A.blocks)
    dirty[-1] = dirty[-1].clone()
    dirty[-1][-1, 0] = 1.0           # row 15 of 16 is padding
    with pytest.raises(AssertionError):
        A.with_blocks(dirty).check_valid()
    padded = np.zeros((20, 9))
    padded[:13, :7] = a
    B = Et.DistMatrix.from_padded(torch.tensor(padded), 13, 7, grid=tgrid)
    assert B.padded_shape == (16, 8)
    np.testing.assert_array_equal(B.global_array(), a)


# ---------------------------------------------------------------------------
# redistributions (reference: tests/core/test_distmatrix.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", T.ALL_DISTS, ids=DIST_IDS)
@pytest.mark.parametrize("dst", T.ALL_DISTS, ids=DIST_IDS)
def test_redistribution_conformance(tgrid, src, dst):
    """Every ordered pair: the global matrix is kept and the blocks are
    the ones the target layout cuts (:21-28)."""
    rng = np.random.default_rng(24)
    a, A = _mk(rng, 13, 7, tgrid, src)
    B = A.redistribute(*dst)
    assert B.dist == dst
    np.testing.assert_array_equal(B.global_array(), a)
    want = Et.DistMatrix.from_global(a, *dst, grid=tgrid)
    for b, w in zip(B.blocks, want.blocks):
        assert b.device == w.device
        np.testing.assert_array_equal(b.numpy(), w.numpy())
    B.check_valid()


def test_named_paths(tgrid):
    """Reference: tests/core/test_distmatrix.py:43-56."""
    a, A = _mk(np.random.default_rng(25), 12, 12, tgrid, (T.MC, T.MR))
    B = Et.copy.RowAllGather(A)
    assert B.dist == (T.MC, T.STAR)
    C = Et.copy.ColAllGather(B)
    assert C.dist == (T.STAR, T.STAR)
    D = Et.copy.Filter(C, T.VR, T.STAR)
    assert D.dist == (T.VR, T.STAR)
    E = Et.copy.PartialColAllGather(D)
    assert E.dist == (T.MR, T.STAR)
    F = Et.copy.Gather(E)
    assert F.dist == (T.CIRC, T.CIRC)
    G = Et.copy.Scatter(F)
    np.testing.assert_array_equal(G.global_array(), a)
    H = Et.copy.PartialColFilter(B, T.VC)
    assert H.dist == (T.VC, T.STAR)
    np.testing.assert_array_equal(H.global_array(), a)
    np.testing.assert_array_equal(Et.copy.RowFilter(B, T.MR).global_array(),
                                  a)
    assert Et.copy.PartialRowAllGather(
        Et.DistMatrix.from_global(a, T.STAR, T.VR, grid=tgrid)).dist == \
        (T.STAR, T.MR)
    assert Et.copy.TransposeDist(A).dist == (T.MR, T.MC)
    assert Et.copy.Translate(A) is A
    with pytest.raises(ValueError):
        Et.copy.ColFilter(A, T.VC)
    with pytest.raises(ValueError):
        Et.copy.RowFilter(A, T.VR)
    with pytest.raises(ValueError):
        Et.copy.Filter(A, T.VC, T.STAR)
    with pytest.raises(ValueError):
        Et.copy.Scatter(A)
    with pytest.raises(ValueError):
        Et.copy.PartialColFilter(A, T.VR)


def test_exchange_and_demote(tgrid):
    """Reference: tests/core/test_distmatrix.py:59-67."""
    a, A = _mk(np.random.default_rng(26), 10, 6, tgrid, (T.MC, T.MR))
    B = Et.copy.Exchange(A)
    assert B.dist == (T.MR, T.MC)
    C = Et.copy.ColAllToAllDemote(B)
    assert C.dist == (T.VR, T.STAR)
    D = Et.copy.ColAllToAllPromote(C)
    assert D.dist == (T.MR, T.MC)
    np.testing.assert_array_equal(D.global_array(), a)
    with pytest.raises(ValueError):
        Et.copy.Exchange(Et.copy.AllGather(A))
    with pytest.raises(ValueError):
        Et.copy.ColAllToAllPromote(A)
    with pytest.raises(ValueError):
        Et.copy.ColAllToAllDemote(C)


def test_translate_between_grids(tgrid, tsquare):
    """Reference: tests/core/test_distmatrix.py:70-78 (DifferentGrids.cpp),
    and onto and off a 1 x 1 grid."""
    a, A = _mk(np.random.default_rng(27), 9, 9, tgrid, (T.MC, T.MR))
    B = Et.TranslateBetweenGrids(A, tsquare)
    assert B.grid == tsquare and B.padded_shape == (12, 12)
    np.testing.assert_array_equal(B.global_array(), a)
    B.check_valid()
    C = Et.TranslateBetweenGrids(B, tgrid, T.VR, T.STAR)
    assert C.dist == (T.VR, T.STAR)
    np.testing.assert_array_equal(C.global_array(), a)
    one = Et.TranslateBetweenGrids(C, Et.Grid("cpu"))
    assert not one.sharded and one.padded_shape == (9, 9)
    np.testing.assert_array_equal(one.global_array(), a)
    back = Et.TranslateBetweenGrids(one, tsquare)
    np.testing.assert_array_equal(back.global_array(), a)


def test_dtype_preserved(tgrid):
    """Reference: tests/core/test_distmatrix.py:125-132."""
    rng = np.random.default_rng(28)
    for dt in (np.float32, np.float64, np.complex64, np.complex128):
        a = rng.standard_normal((8, 8)).astype(dt)
        A = Et.DistMatrix.from_global(a, T.MC, T.MR, grid=tgrid)
        B = A.redistribute(T.VR, T.STAR)
        assert B.dtype == getattr(torch, np.dtype(dt).name)
        np.testing.assert_array_equal(B.global_array(), a)


def test_redistribute_on_one_position_only_retags():
    A = Et.DistMatrix.from_global(np.eye(3), grid=Et.Grid("cpu"))
    B = Et.Copy(A, T.VC, T.STAR)
    assert B.data is A.data and B.dist == (T.VC, T.STAR)


# ---------------------------------------------------------------------------
# bytes moved, against their closed forms
# ---------------------------------------------------------------------------


def _moved(fn):
    collectives.reset()
    out = fn()
    return out, collectives.bytes_moved()


@pytest.mark.parametrize("shape", [(16, 8), (13, 7)])
def test_bytes_moved_closed_forms(tgrid, shape):
    """ColFilter, RowFilter, Filter, PartialColFilter and Scatter move 0
    bytes; [MC,MR] -> [*,MR] moves (r-1) P Q entries and [MC,MR] -> [*,*]
    (p-1) P Q, for a P x Q padded array on an r x c grid."""
    r, p = tgrid.height, tgrid.size
    _, A = _mk(np.random.default_rng(29), *shape, tgrid, (T.MC, T.MR))
    P, Q = A.padded_shape
    item = 8
    _, nbytes = _moved(lambda: tcopy.ColAllGather(A))
    assert nbytes == (r - 1) * P * Q * item
    assert dict(collectives.moved) == {"copy [MC,MR]->[STAR,MR]": nbytes}
    full, nbytes = _moved(lambda: tcopy.AllGather(A))
    assert nbytes == (p - 1) * P * Q * item
    gathered, circ = tcopy.ColAllGather(A), tcopy.Gather(A)
    mc_star = tcopy.Copy(full, T.MC, T.STAR)
    collectives.reset()
    outs = [tcopy.ColFilter(gathered, T.MC),
            tcopy.RowFilter(mc_star, T.MR),
            tcopy.Filter(full, T.VR, T.STAR),
            tcopy.PartialColFilter(mc_star, T.VC),
            tcopy.Scatter(circ)]
    assert collectives.bytes_moved() == 0 and not collectives.moved
    for out in outs:
        np.testing.assert_array_equal(out.global_array(),
                                      A.global_array())


def test_bytes_moved_by_exchange(tsquare):
    """[MC,MR] -> [MR,MC] on a 2x2 grid: the diagonal positions keep their
    block, the two off-diagonal ones swap: half the matrix moves."""
    _, A = _mk(np.random.default_rng(30), 8, 8, tsquare, (T.MC, T.MR))
    _, nbytes = _moved(lambda: tcopy.Exchange(A))
    assert nbytes == 8 * 8 * 8 // 2


# ---------------------------------------------------------------------------
# the collectives on grid-indexed blocks
# ---------------------------------------------------------------------------


def _blocks(grid, shape=(2, 3)):
    return [torch.full(shape, float(q + 1)) + torch.arange(
        shape[0] * shape[1], dtype=torch.float64).view(shape)
        for q in range(grid.size)]


def test_all_gather(tgrid):
    x = _blocks(tgrid)
    out, nbytes = _moved(lambda: collectives.all_gather(x, tgrid, "mc", 0))
    for q in range(8):
        want = torch.cat([x[g] for g in tgrid.group("mc", q)], 0)
        assert torch.equal(out[q], want)
    assert nbytes == 8 * 3 * x[0].numel() * 8
    out = collectives.all_gather(x, tgrid, "mr", 1)
    assert torch.equal(out[5], torch.cat([x[4], x[5]], 1))


def test_psum_and_psum_scatter(tgrid):
    x = _blocks(tgrid, (4, 6))
    out, nbytes = _moved(lambda: collectives.psum(x, tgrid, "vc"))
    total = sum(x)
    assert all(torch.equal(o, total) for o in out)
    assert nbytes == 8 * 7 * x[0].numel() * 8
    out, nbytes = _moved(lambda: collectives.psum_scatter(x, tgrid, "mr", 1))
    for q in range(8):
        i, j = tgrid.coords(q)
        want = (x[2 * i] + x[2 * i + 1])[:, 3 * j:3 * j + 3]
        assert torch.equal(out[q], want)
    assert nbytes == 8 * x[0].numel() // 2 * 8
    out = collectives.psum_scatter(x, tgrid, "mc", 0)
    want = sum(x[g] for g in tgrid.group("mc", 1))[1:2]
    assert torch.equal(out[3], want)


def test_ppermute_broadcast_and_permute(tgrid):
    x = _blocks(tgrid)
    out, nbytes = _moved(lambda: collectives.ppermute(x, tgrid, "mc", 1))
    assert torch.equal(out[0], x[2]) and torch.equal(out[6], x[0])
    assert nbytes == 8 * x[0].numel() * 8
    out, nbytes = _moved(lambda: collectives.broadcast(x, tgrid, "mr", 1))
    assert torch.equal(out[0], x[1]) and out[1] is x[1]
    assert nbytes == 4 * x[0].numel() * 8
    out = collectives.permute(x, tgrid, lambda q: (q + 3) % 8)
    assert torch.equal(out[7], x[2])
    assert out[0] is not x[3]          # a copy, as a transfer would be


# ---------------------------------------------------------------------------
# level 1 on a grid of several positions: Scale, Axpby, Nrm2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dist", [(T.MC, T.MR), (T.STAR, T.STAR),
                                  (T.VC, T.STAR), (T.MR, T.STAR)],
                         ids=lambda d: f"{d[0].name}_{d[1].name}")
def test_nrm2_scale_axpby_vs_jax(grid, tgrid, dist):
    """Nrm2 reduces each distinct block once (replicas counted once);
    Scale and Axpby act per position. float64: 1e-14 relative."""
    rng = np.random.default_rng(31)
    a, b = rng.standard_normal((13, 7)), rng.standard_normal((13, 7))
    JA = El.DistMatrix.from_global(a, *_jd(dist), grid=grid)
    JB = El.DistMatrix.from_global(b, grid=grid)
    A = Et.DistMatrix.from_global(a, *dist, grid=tgrid)
    B = Et.DistMatrix.from_global(b, grid=tgrid)
    ref = float(El.blas.Nrm2(JA))
    assert abs(Et.Nrm2(A).item() - ref) <= 1e-14 * ref
    np.testing.assert_allclose(Et.Scale(-0.5, A).global_array(),
                               El.blas.level1.Scale(-0.5, JA).global_array(),
                               rtol=1e-15)
    out = Et.Axpby(0.3, B, -1.7, A)
    assert out.dist == dist
    np.testing.assert_allclose(
        out.global_array(),
        El.blas.level1.Axpby(0.3, JB, -1.7, JA).global_array(), rtol=1e-14)
    zero = Et.DistMatrix.from_global(np.zeros((5, 3)), *dist, grid=tgrid)
    assert Et.Nrm2(zero).item() == 0.0


def test_bf16_blocks_come_back_as_float32():
    """bfloat16 blocks come back as float32 through global_array."""
    g = Et.Grid(["cpu"] * 4, height=2)
    a = np.linspace(-1, 1, 12).reshape(3, 4).astype(np.float32)
    A = Et.DistMatrix.from_global(torch.tensor(a).bfloat16(), grid=g)
    assert A.dtype == torch.bfloat16
    out = A.redistribute(T.STAR, T.VC).global_array()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, a, atol=1e-2)
