"""Port parity: the HermitianEig path (reflect, _geqrf_slab, the
tridiagonal reduction, tridiag_eig, SBR, HermitianEig and
hermitian_eig_step) and HermitianGenDefEig with gen_def_eig_step.

Each input is made with numpy from a seed and given to the JAX package
(on one device, the grid its SBR and K5 gates need) and to its PyTorch
port on the CPU, where K5 and K6 take their plain versions. Where the
JAX package draws random start vectors (tridiag_eig), its own draw is fed
to the port's core. Eigenvectors are compared elementwise only in float64
on well-separated spectra; clusters are held to the residual and
orthogonality contracts of the JAX package's own tests.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax
import jax.numpy as jnp

import elementalx as El
import elementalx_torch as Et
from elementalx.lapack import condense as jc
from elementalx.lapack import reflect as jr
from elementalx.lapack import sbr as js
from elementalx.lapack import tridiag_eig as jt
from elementalx.lapack.qr import _geqrf_slab as j_geqrf_slab
from elementalx_torch.entry import (
    gen_def_eig_step,
    hermitian_eig_step,
    make_eig_problem,
    make_gendef_problem,
)
from elementalx_torch.lapack import condense as tc
from elementalx_torch.lapack import reflect as tr
from elementalx_torch.lapack import sbr as ts
from elementalx_torch.lapack import tridiag_eig as tt
from elementalx_torch.lapack.hermitian_eig import (
    HermitianEig,
    HermitianEigCtrl,
    HermitianEigSubset,
    HermitianEigValueSubset,
    HermitianGenDefEig,
)
from elementalx_torch.lapack.qr import _geqrf_slab

CPU = Et.Grid("cpu")
EPS64 = np.finfo(np.float64).eps


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers at once: keep torch to one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_grid():
    """The port runs on the card unless the caller asks for the CPU: these
    tests ask, by making a CPU grid the default for the module."""
    prev = Et.Grid._default
    Et.Grid.set_default(Et.Grid("cpu"))
    yield
    Et.Grid.set_default(prev)


@pytest.fixture(scope="module")
def one_device():
    return El.Grid(devices=jax.devices()[:1])


def _t(a):
    return Et.DistMatrix.from_global(a, grid=CPU)


def _herm(rng, n, complex_=False):
    a = rng.standard_normal((n, n))
    if complex_:
        a = a + 1j * rng.standard_normal((n, n))
    return a + a.conj().T


def _symm32(rng, n):
    a = rng.standard_normal((n, n)).astype(np.float32)
    return (a + a.T) / 2


def _tridiag(d, e):
    return np.diag(d) + np.diag(e, -1) + np.diag(e, 1)


def _tz_resid(d, e, w, Z):
    TZ = d[:, None] * Z
    TZ[1:] += e[:, None] * Z[:-1]
    TZ[:-1] += e[:, None] * Z[1:]
    return np.abs(TZ - Z * w[None, :]).max()


# ---------------------------------------------------------------------------
# reflect and _geqrf_slab
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
@pytest.mark.parametrize("j", [0, 3, 9])
def test_householder_parity(dtype, j):
    """Tolerance: 1e-14 (f64/c128) or 1e-6 (f32), one norm and one
    division apart."""
    rng = np.random.default_rng(100)
    x = rng.standard_normal(10)
    if dtype == "complex128":
        x = x + 1j * rng.standard_normal(10)
    x = x.astype(dtype)
    ref = [np.asarray(y) for y in jr.householder(jnp.asarray(x), j, 10)]
    out = [y.numpy() for y in tr.householder(torch.tensor(x), j, 10)]
    tol = 1e-6 if dtype == "float32" else 1e-14
    for o, r in zip(out, ref):
        assert np.abs(o - r).max() <= tol * max(np.abs(r).max(), 1.0)


@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
def test_build_wy_T_parity_and_batch(dtype):
    """T against the JAX closed form (one decoupled tau = 0 column), and a
    batch of two against the unbatched calls. Tolerance 1e-13 (f64), 1e-5
    (f32: one Newton polish on each side)."""
    rng = np.random.default_rng(101)
    V = rng.standard_normal((2, 40, 8))
    tau = rng.uniform(0.5, 1.5, (2, 8))
    if dtype == "complex128":
        V = V + 1j * rng.standard_normal((2, 40, 8))
    V, tau = V.astype(dtype), tau.astype(dtype)
    tau[0, 3] = 0
    tol = 1e-5 if dtype == "float32" else 1e-13
    batch = tr.build_wy_T(torch.tensor(V), torch.tensor(tau)).numpy()
    for k in range(2):
        ref = np.asarray(jax.jit(jr.build_wy_T)(jnp.asarray(V[k]),
                                                jnp.asarray(tau[k])))
        one = tr.build_wy_T(torch.tensor(V[k]), torch.tensor(tau[k])).numpy()
        assert np.abs(one - ref).max() <= tol * np.abs(ref).max()
        assert np.abs(batch[k] - one).max() <= tol * np.abs(ref).max()
    assert np.all(batch[0][3] == 0) and np.all(batch[0][:, 3] == 0)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "cplx"])
def test_apply_packed_reflectors_parity(adjoint, complex_):
    """offset=1 (the condense storage), 28 reflector columns in blocks of
    8, float64: 1e-13 relative."""
    rng = np.random.default_rng(102)
    pk = rng.standard_normal((30, 30))
    A = rng.standard_normal((30, 5))
    if complex_:
        pk = pk + 1j * rng.standard_normal((30, 30))
        A = A + 1j * rng.standard_normal((30, 5))
    tau = rng.uniform(1, 2, 30).astype(pk.dtype)
    ref = np.asarray(jax.jit(jr.ApplyPackedReflectors,
                             static_argnums=(3, 4, 5, 6))(
        jnp.asarray(pk), jnp.asarray(tau), jnp.asarray(A), 8, 28, adjoint, 1))
    out = tr.ApplyPackedReflectors(torch.tensor(pk), torch.tensor(tau),
                                   torch.tensor(A), 8, 28, adjoint,
                                   offset=1).numpy()
    assert np.abs(out - ref).max() <= 1e-13 * np.abs(ref).max()


def test_expand_packed_reflectors_is_orthogonal_and_matches():
    rng = np.random.default_rng(103)
    a = rng.standard_normal((20, 12))
    pk, tau = np.linalg.qr(a, mode="raw")
    pk = pk.T.copy()
    ref = np.asarray(jax.jit(jr.ExpandPackedReflectors,
                             static_argnums=(2, 3, 4))(
        jnp.asarray(pk), jnp.asarray(tau), 4, 12, 12))
    out = tr.ExpandPackedReflectors(torch.tensor(pk), torch.tensor(tau), 4,
                                    12, 12).numpy()
    assert np.abs(out - ref).max() < 1e-13
    assert np.abs(out.T @ out - np.eye(12)).max() < 1e-13


@pytest.mark.parametrize("name", ["LeftReflector", "RightReflector",
                                  "LeftHyperbolicReflector",
                                  "RightHyperbolicReflector"])
@pytest.mark.parametrize("zero_x", [False, True])
def test_reflector_kernels_parity(name, zero_x):
    """The public reflector kernels, including the x = 0 case (tau = 2,
    beta = -chi for the Householder ones). float64, 1e-14."""
    x = np.zeros(5) if zero_x else \
        np.random.default_rng(104).standard_normal(5) * 0.1
    ref = [np.asarray(y) for y in getattr(jr, name)(2.0, jnp.asarray(x))]
    out = [torch.as_tensor(y).numpy()
           for y in getattr(tr, name)(2.0, torch.tensor(x))]
    for o, r in zip(out, ref):
        assert np.abs(o - r).max() < 1e-14


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-13), ("float32", 1e-5)])
def test_geqrf_slab_parity(dtype, tol):
    """LAPACK geqrf on both sides (jax.lax.linalg.geqrf, torch.geqrf):
    packed slab, tau and the compact-WY T agree to rounding."""
    s = np.random.default_rng(105).standard_normal((50, 12)).astype(dtype)
    ref = [np.asarray(y) for y in j_geqrf_slab(jnp.asarray(s), 12)]
    out = [y.numpy() for y in _geqrf_slab(torch.tensor(s), 12)]
    for o, r in zip(out, ref):
        assert np.abs(o - r).max() <= tol * np.abs(r).max()


# ---------------------------------------------------------------------------
# HermitianTridiag / tridiag_apply_q
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [12, 25])
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "cplx"])
def test_hermitian_tridiag(one_device, rng, n, complex_):
    """test_condense.py's contract (Q orthogonal, Q T Q^H = A to 1e-12,
    real d) on the port, and the JAX factorization's d, e, tau and packed
    reflectors to 1e-12 of max|A|."""
    a = _herm(rng, n, complex_)
    fact = tc.HermitianTridiag(Et.LOWER, _t(a), blocksize=4)
    d, e = fact.d.numpy(), fact.e.numpy()
    M = fact.packed.data.shape[0]
    Q = tc.tridiag_apply_q(fact, torch.eye(M, dtype=fact.packed.dtype),
                           adjoint=False, blocksize=4).numpy()[:n, :n]
    assert np.linalg.norm(np.eye(n) - Q.conj().T @ Q) < 1e-12
    T = _tridiag(d[:n], e[:n - 1])
    assert np.linalg.norm(Q @ T @ Q.conj().T - a) / np.linalg.norm(a) < 1e-12
    assert fact.d.dtype == torch.float64
    jf = jc.HermitianTridiag(El.LOWER, El.DistMatrix.from_global(
        a, grid=one_device), blocksize=4)
    scale = np.abs(a).max()
    assert np.abs(np.asarray(jf.d)[:n] - d[:n]).max() < 1e-12 * scale
    assert np.abs(np.asarray(jf.e)[:n - 1] - e[:n - 1]).max() < 1e-12 * scale
    assert np.abs(np.asarray(jf.tau)[:n] - fact.tau.numpy()[:n]).max() < 1e-12
    low = np.tril(np.ones((n, n)), -2).astype(bool)
    assert np.abs(np.asarray(jf.packed.data)[:n, :n][low]
                  - fact.packed.data.numpy()[low]).max() < 1e-12 * scale


@pytest.mark.parametrize("adjoint", [False, True])
def test_tridiag_apply_q_from_reference(one_device, rng, adjoint):
    """The JAX factorization carried over by from_reference: the port's
    backtransform of it equals Q_eff = H_1 ... H_{n-2} D (or its adjoint)
    formed from the JAX reflectors in numpy (complex, with phases)."""
    n = 25
    a = _herm(rng, n, True)
    jf = jc.HermitianTridiag(El.LOWER, El.DistMatrix.from_global(
        a, grid=one_device), blocksize=4)
    fact = tc.TridiagFactorization.from_reference(
        np.asarray(jf.packed.data), n, jf.d, jf.e, jf.tau, jf.phase,
        grid=CPU)
    pk, tau = np.asarray(jf.packed.data)[:n, :n], np.asarray(jf.tau)
    Q = np.eye(n, dtype=complex)
    for k in range(n - 2):
        v = np.zeros(n, dtype=complex)
        v[k + 1] = 1
        v[k + 2:] = pk[k + 2:, k]
        Q = Q @ (np.eye(n) - tau[k] * np.outer(v, v.conj()))
    Q = Q * np.asarray(jf.phase)[:n][None, :]
    B = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    ref = (Q.conj().T if adjoint else Q) @ B
    out = tc.tridiag_apply_q(fact, torch.tensor(B), adjoint,
                             blocksize=4).numpy()
    assert np.abs(out - ref).max() < 1e-13 * np.abs(ref).max()


@pytest.mark.parametrize("blocksize", [64, 256])
def test_hermitian_tridiag_kernel_route_takes_every_panel(monkeypatch, rng,
                                                          blocksize):
    """The route a CUDA tensor takes, on the CPU: with ``on_cuda`` true,
    every panel goes to ``latrd_panel`` (here its plain version), a
    blocksize above K5's MAX_NB is cut to it, and d, e and the packed
    reflectors equal the CPU route's at that width to 1e-12."""
    from elementalx_torch.kernels.latrd import MAX_NB, latrd_panel_plain

    n = 300
    a = _herm(rng, n)
    ref = tc.HermitianTridiag(Et.LOWER, _t(a),
                              blocksize=min(blocksize, MAX_NB))
    widths = []

    def panel(a_, k0, w, nb):
        widths.append(nb)
        return latrd_panel_plain(a_, k0, w, nb)

    monkeypatch.setattr(tc, "on_cuda", lambda *t: True)
    monkeypatch.setattr(tc, "latrd_panel", panel)
    fact = tc.HermitianTridiag(Et.LOWER, _t(a), blocksize=blocksize)
    nb = min(blocksize, MAX_NB)
    assert widths == [nb] * -(-(n - 2) // nb)
    scale = np.abs(a).max()
    for x, y in ((fact.d, ref.d), (fact.e, ref.e),
                 (fact.packed.data, ref.packed.data)):
        assert (x - y).abs().max().item() < 1e-12 * scale


def test_tridiag_panel_matches_xla_panel(rng):
    """The port's _tridiag_panel (K5's plain version) against the JAX
    package's XLA panel on one trailing block, float64: 1e-12."""
    M, k0, w = 40, 8, 12
    a = _herm(rng, M)
    ref = jc._tridiag_panel(jnp.asarray(a), jnp.asarray(a[k0:, k0:]),
                            jnp.zeros((M - k0, w)), jnp.zeros((M - k0, w)),
                            jnp.zeros((M,)), k0, w, M - k0)
    out = tc._tridiag_panel(torch.tensor(a), torch.tensor(a[k0:, k0:]),
                            torch.zeros((M - k0, w), dtype=torch.float64),
                            torch.zeros((M - k0, w), dtype=torch.float64),
                            torch.zeros((M,), dtype=torch.float64), k0, w,
                            M - k0)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert np.abs(o.numpy() - r).max() <= 1e-12 * max(np.abs(r).max(), 1)


# ---------------------------------------------------------------------------
# tridiag_eig
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,dtype", [(40, "float64"), (33, "float32"),
                                     (1, "float64"), (2, "float64")])
def test_tridiag_eigvalsh_parity(n, dtype):
    """The same octsection on both sides: identical brackets, so the
    eigenvalues agree to a few ulp of max|w|."""
    rng = np.random.default_rng(110)
    d = rng.standard_normal(n).astype(dtype)
    e = rng.standard_normal(n - 1).astype(dtype)
    ref = np.asarray(jt.tridiag_eigvalsh(jnp.asarray(d), jnp.asarray(e)))
    out = tt.tridiag_eigvalsh(torch.tensor(d), torch.tensor(e)).numpy()
    eps = np.finfo(dtype).eps
    assert np.abs(out - ref).max() <= 8 * eps * max(np.abs(ref).max(), 1)


@pytest.mark.parametrize("n", [40, 64])
def test_tridiag_eig_with_jax_start_vectors(n):
    """float64, a random (well separated) tridiagonal: fed the JAX
    package's own start block (jax.random key 7), the port's core returns
    the same eigenvalues to 1e-13 and the same eigenvectors to 1e-10, up
    to the sign of each: the second round shifts by the Rayleigh
    quotient, so the last solve's smallest pivot is rounding-sized and
    its sign, which rounding sets, sets the vector's."""
    rng = np.random.default_rng(111)
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    jw, jZ = (np.asarray(x) for x in jt.tridiag_eig(jnp.asarray(d),
                                                   jnp.asarray(e)))
    b0 = np.asarray(jax.random.normal(jax.random.key(7), (n, n),
                                      jnp.float64))
    w, Z = (x.numpy() for x in tt._tridiag_eig(
        torch.tensor(d), torch.tensor(e), torch.tensor(b0)))
    assert np.abs(w - jw).max() < 1e-13 * np.abs(jw).max()
    sign = np.where(np.sum(Z * jZ, axis=0) < 0, -1.0, 1.0)
    assert np.abs(Z * sign[None, :] - jZ).max() < 1e-10


def test_tridiag_eig_public_contract():
    """The public entry (torch start vectors, seed 7): residual and
    orthogonality at f64 grade, eigenvalues against LAPACK."""
    rng = np.random.default_rng(112)
    n = 50
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    w, Z = (x.numpy() for x in tt.tridiag_eig(torch.tensor(d),
                                             torch.tensor(e)))
    wref = sla.eigvalsh_tridiagonal(d, e)
    assert np.abs(w - wref).max() < 1e3 * EPS64 * np.abs(wref).max()
    assert _tz_resid(d, e, w, Z) / (EPS64 * n * np.abs(w).max()) < 100
    assert np.abs(Z.T @ Z - np.eye(n)).max() <= 32 * n * EPS64
    w2, Z2 = (x.numpy() for x in tt.tridiag_eig(torch.tensor(d),
                                               torch.tensor(e)))
    assert np.array_equal(w, w2) and np.array_equal(Z, Z2)


def _glued_wilkinson_tridiag(nblocks, glue):
    m = 21
    dblk = np.abs(np.arange(m) - 10).astype(np.float64)
    d = np.tile(dblk, nblocks)
    e = np.concatenate([np.concatenate([np.ones(m - 1), [glue]])
                        for _ in range(nblocks)])[:nblocks * m - 1]
    return d, e


def test_glued_wilkinson_clusters_tridiag_eig():
    """test_hard_cases.py's glued-Wilkinson chain with 1e-14 glue, at 48
    blocks (n = 1008) instead of 196 (n = 4116): the same clusters of
    values agreeing to ~1e-14, at a size a one-thread CPU run takes in
    seconds. Pass bar as there: ortho <= 32 n eps, scaled residual < 100,
    eigenvalues to 1e3 eps of LAPACK's."""
    d, e = _glued_wilkinson_tridiag(48, 1e-14)
    n = d.shape[0]
    w, Z = (x.numpy() for x in tt.tridiag_eig(torch.tensor(d),
                                             torch.tensor(e)))
    wref = sla.eigvalsh_tridiagonal(d, e)
    assert np.abs(np.sort(w) - wref).max() < 1e3 * EPS64 * np.abs(wref).max()
    assert _tz_resid(d, e, w, Z) / (EPS64 * n * np.abs(w).max()) < 100
    assert np.abs(Z.T @ Z - np.eye(n)).max() <= 32 * n * EPS64


def test_tridiag_eig_dense_cluster_float32_keeps_orthogonality():
    """A float32 tridiagonal whose 2048 eigenvalues fill one dense cluster
    (a uniform spectrum of width 0.01 at 0.2; ctol puts them all in one
    CholeskyQR block), from the JAX package's start vectors (key 7). The
    cluster's inverse-iteration vectors are nearly dependent, and a
    float32 CholeskyQR of them lost their orthogonality: the port read
    118.45 x eps n before its cluster QR ran in float64. Both packages
    stay below the gate of 100 x eps n here."""
    n = 2048
    rng = np.random.default_rng(3)
    lam = np.sort(rng.uniform(0.2, 0.21, n))
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    h = sla.hessenberg((q * lam) @ q.T)
    d = np.diag(h).astype(np.float32)
    e = np.diag(h, -1).astype(np.float32)
    eps = np.finfo(np.float32).eps
    b0 = np.asarray(jax.random.normal(jax.random.key(7), (n, n),
                                      jnp.float32))
    _, Z = tt._tridiag_eig(torch.tensor(d), torch.tensor(e),
                           torch.tensor(b0))
    _, jZ = jt.tridiag_eig(jnp.asarray(d), jnp.asarray(e))
    for z in (Z.numpy(), np.asarray(jZ)):
        z = z.astype(np.float64)
        assert np.abs(z.T @ z - np.eye(n)).max() / (eps * n) < 100


def test_tight_cluster_1e14_spacing():
    """test_hard_cases.py's single giant cluster (n = 512, spacing
    ~1e-14 around 1.0): vectors orthogonal, residual at machine scale."""
    n = 512
    rng = np.random.default_rng(3)
    d = 1.0 + np.arange(n) * 1e-14
    e = np.full(n - 1, 1e-15) * (1 + rng.random(n - 1))
    w, Z = (x.numpy() for x in tt.tridiag_eig(torch.tensor(d),
                                             torch.tensor(e)))
    assert _tz_resid(d, e, w, Z) / (EPS64 * n) < 100
    assert np.abs(Z.T @ Z - np.eye(n)).max() <= 32 * n * EPS64


def test_tridiag_eig_backends_not_ported():
    d, e = torch.ones(3, dtype=torch.float64), torch.ones(2,
                                                         dtype=torch.float64)
    for backend in ("native", "dc", "dc_device"):
        with pytest.raises(NotImplementedError, match="item 8"):
            tt.HermitianTridiagEig(d, e, backend=backend)
    w = tt.HermitianTridiagEig(d, e, vectors=False)
    assert np.allclose(w.numpy(), np.linalg.eigvalsh(_tridiag(d.numpy(),
                                                              e.numpy())))


# ---------------------------------------------------------------------------
# HermitianEig (test_eig_svd.py and test_hard_cases.py contracts)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "cplx"])
def test_hermitian_eig(one_device, rng, n, complex_):
    """test_eig_svd.py's contract (eigenvalues, residual and
    orthogonality to 1e-12) on the port, and the eigenvalues against the
    JAX package's HermitianEig to 1e-12."""
    a = _herm(rng, n, complex_)
    w, Q = HermitianEig(Et.LOWER, _t(a))
    w, q = w.numpy(), Q.global_array()
    wref = np.linalg.eigvalsh(a)
    assert np.max(np.abs(w - wref)) / np.max(np.abs(wref)) < 1e-12
    assert np.linalg.norm(a @ q - q * w[None, :]) / np.linalg.norm(a) < 1e-12
    assert np.linalg.norm(np.eye(n) - q.conj().T @ q) < 1e-12
    jw, _ = El.HermitianEig(El.LOWER, El.DistMatrix.from_global(
        a, grid=one_device))
    assert np.abs(np.asarray(jw) - w).max() < 1e-12 * np.abs(wref).max()


def test_hermitian_eig_values_only(rng):
    a = _herm(rng, 20)
    w = HermitianEig(Et.UPPER, _t(a), vectors=False)
    assert np.max(np.abs(w.numpy() - np.linalg.eigvalsh(a))) < 1e-11


def test_hermitian_eig_subset(rng):
    a = _herm(rng, 20)
    w, Q = HermitianEigSubset(Et.LOWER, _t(a), 5, 9)
    w = w.numpy()
    assert np.max(np.abs(w - np.linalg.eigvalsh(a)[5:10])) < 1e-11
    q = Q.global_array()
    assert q.shape == (20, 5)
    assert np.linalg.norm(a @ q - q * w[None, :]) < 1e-10


def test_value_range_subset(rng):
    a = _herm(rng, 16)
    wall = np.linalg.eigvalsh(a)
    w, Q = HermitianEigValueSubset(Et.LOWER, _t(a), wall[4] - 1e-9,
                                   wall[9] + 1e-9)
    assert w.shape[0] == 6
    np.testing.assert_allclose(w.numpy(), wall[4:10], atol=1e-11)
    q = Q.global_array()
    assert np.linalg.norm(a @ q - q * w.numpy()[None, :]) < 1e-10
    w0, Q0 = HermitianEigValueSubset(Et.LOWER, _t(a), 1e6, 2e6)
    assert w0.shape[0] == 0 and Q0 is None


def test_wilkinson_clusters(one_device):
    """W21 (pairs of nearly equal eigenvalues), from the JAX package's
    generator: residual, orthogonality and eigenvalues to 1e-12."""
    from elementalx import matrices as M

    a = M.Wilkinson(10, one_device).global_array()
    w, Q = HermitianEig(Et.LOWER, _t(a))
    w, q = w.numpy(), Q.global_array()
    n = a.shape[0]
    assert np.linalg.norm(a @ q - q * w[None, :]) < 1e-12
    assert np.linalg.norm(np.eye(n) - q.T @ q) < 1e-12
    assert np.max(np.abs(w - np.linalg.eigvalsh(a))) < 1e-12


def test_glued_wilkinson(one_device):
    """Four glued W11 blocks (clusters of 4 agreeing to ~1e-8)."""
    from elementalx import matrices as M

    blocks = [M.Wilkinson(5, one_device).global_array() for _ in range(4)]
    a = sla.block_diag(*blocks)
    for i in range(1, 4):
        a[i * 11 - 1, i * 11] = a[i * 11, i * 11 - 1] = 1e-8
    w, Q = HermitianEig(Et.LOWER, _t(a))
    w, q = w.numpy(), Q.global_array()
    n = a.shape[0]
    assert np.linalg.norm(a @ q - q * w[None, :]) < 1e-12
    assert np.linalg.norm(np.eye(n) - q.T @ q) < 1e-12
    assert np.max(np.abs(w - np.linalg.eigvalsh(a))) < 1e-12


def test_hermitian_eig_refine_and_alg_raise(rng):
    A = _t(_herm(rng, 8))
    with pytest.raises(NotImplementedError, match="item 9"):
        HermitianEig(Et.LOWER, A, ctrl=HermitianEigCtrl(refine=True))
    with pytest.raises(ValueError):
        HermitianEig(Et.LOWER, A, ctrl=HermitianEigCtrl(tridiag_alg="x"))


def test_hermitian_eig_safe_range_scaling(rng):
    """A matrix near the float64 overflow bound is scaled down on the way
    in and w scaled back: same eigenvalues, relative 1e-12."""
    a = _herm(rng, 12)
    big = a * 1e300
    w = HermitianEig(Et.LOWER, _t(big), vectors=False).numpy()
    assert np.all(np.isfinite(w))
    ref = np.linalg.eigvalsh(a) * 1e300
    assert np.abs(w - ref).max() < 1e-12 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# SBR (test_sbr.py contracts, and parity with the JAX stages)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_sbr64():
    """The JAX package's stages on one (64, 16) float32 input, computed
    once for the tests below: (a, band, panel V's, panel T's, the dense
    chase's tridiagonal and vout)."""
    rng = np.random.default_rng(120)
    n, b = 64, 16
    a = _symm32(rng, n)
    ab, Vs, Ts = js.band_reduce(jnp.asarray(a), b)
    at, vout = jax.jit(js._sb2tr_dense, static_argnames="b")(ab, b)
    Q2 = jax.jit(js._apply_q2, static_argnames=("n", "b"))(
        vout, jnp.eye(n, dtype=jnp.float32), n=n, b=b)
    return (a, np.asarray(ab), [np.asarray(v) for v in Vs],
            [np.asarray(t) for t in Ts], np.asarray(at), np.asarray(vout),
            np.asarray(Q2))


@pytest.mark.parametrize("n,b", [(96, 16), (64, 32)])
def test_band_reduce(rng, n, b):
    """test_sbr.py's contract on the port."""
    a = _symm32(rng, n)
    ab, Vs, Ts = ts.band_reduce(torch.tensor(a), b)
    ab = ab.numpy()
    i, j = np.indices((n, n))
    assert np.max(np.abs(ab[np.abs(i - j) > b])) == 0.0
    ev0 = np.linalg.eigvalsh(a.astype(np.float64))
    ev1 = np.linalg.eigvalsh(ab.astype(np.float64))
    assert np.max(np.abs(ev1 - ev0)) < 1e-4 * max(np.max(np.abs(ev0)), 1)
    Q1 = ts._apply_q1(Vs, Ts, torch.eye(n), b).numpy()
    assert np.max(np.abs(Q1.T @ Q1 - np.eye(n))) < 5e-6
    assert np.max(np.abs(Q1.T @ a @ Q1 - ab)) < 1e-4


def test_band_reduce_parity(jax_sbr64):
    """The JAX band and panel factors to f32 rounding (5e-5 of max|A|)."""
    a, jab, jVs, jTs, *_ = jax_sbr64
    ab, Vs, Ts = ts.band_reduce(torch.tensor(a), 16)
    scale = np.abs(a).max()
    assert np.abs(jab - ab.numpy()).max() < 5e-5 * scale
    for jv, tv in zip(jVs, Vs):
        assert np.abs(jv - tv.numpy()).max() < 5e-5
    for jt_, tt_ in zip(jTs, Ts):
        assert np.abs(jt_ - tt_.numpy()).max() < 5e-5 * np.abs(jt_).max()


def test_sbr_refuses_float64():
    with pytest.raises(TypeError):
        ts.sbr_tridiag(torch.eye(32, dtype=torch.float64), 16)


def test_sbr_dense_tridiag_and_backtransform(rng):
    """test_sbr.py's (96, 16) contract on the port's CPU route."""
    n, b = 96, 16
    a = _symm32(rng, n)
    fact = ts.sbr_tridiag(torch.tensor(a), b=b)
    T = _tridiag(fact.d.numpy(), fact.e.numpy())
    ev0 = np.linalg.eigvalsh(a.astype(np.float64))
    ev1 = np.linalg.eigvalsh(T.astype(np.float64))
    assert np.max(np.abs(ev1 - ev0)) < 1e-4 * max(np.max(np.abs(ev0)), 1)
    Q = ts.sbr_apply_q(fact, torch.eye(n), b).numpy()
    assert np.max(np.abs(Q.T @ Q - np.eye(n))) < 1e-5
    assert np.max(np.abs(a @ Q - Q @ T)) < 2e-4 * max(np.max(np.abs(ev0)), 1)
    Z = rng.standard_normal((n, 5)).astype(np.float32)
    QZ = ts.sbr_apply_q(fact, torch.tensor(Z), b)
    back = ts.sbr_apply_q(fact, QZ, b, adjoint=True).numpy()
    assert np.max(np.abs(back - Z)) < 1e-5


def test_sb2tr_dense_parity_through_spectrum_and_q2(jax_sbr64):
    """(64, 16) float32, the only dtype the JAX chase takes. f32 rounding
    inside the chase moves single d/e entries far more than the spectrum,
    so the two chases are held to each other through the spectrum of
    (d, e) (1e-4 of max|w|) and through _apply_q2 (each Q2 orthogonal to
    1e-5, and Q2^T A_band Q2 = T for each to 1e-4 of max|w|)."""
    n, b = 64, 16
    _, ab, _, _, jat, jv, _ = jax_sbr64
    tat, tv = (x.numpy() for x in ts._sb2tr_dense(torch.tensor(ab), b))
    i, j = np.indices((n, n))
    assert np.max(np.abs(tat[np.abs(i - j) > 1])) < 1e-6
    ev0 = np.linalg.eigvalsh(ab.astype(np.float64))
    wmax = max(np.abs(ev0).max(), 1)
    for at, vout in ((jat, jv), (tat, tv)):
        assert np.abs(np.linalg.eigvalsh(at.astype(np.float64))
                      - ev0).max() < 1e-4 * wmax
        Q2 = ts._apply_q2(torch.tensor(vout), torch.eye(n), n, b).numpy()
        assert np.abs(Q2.T @ Q2 - np.eye(n)).max() < 1e-5
        T = _tridiag(np.diag(at), np.diag(at, -1))
        assert np.abs(Q2.T @ ab @ Q2 - T).max() < 1e-4 * wmax
    assert tv.shape == jv.shape


def _chase_replay(a: torch.Tensor, b: int, lag: int):
    """The chase in the K6 kernel's dependency order: op (j, s) runs beside
    op (j-1, s+lag) and after (j-1, s+lag-1). One step runs every op
    (j, t - lag j): first each op's Householder, its beta published at the
    head of its column (and the mirror) as the kernel publishes it; then
    the updates, the later sweep first; the entry that op (j, s) shares
    with op (j-1, s+2), B's corner A[r0+2b-1, r0+b-1], is handed over:
    (j, s) reads the published beta and its own write lands after
    (j-1, s+2) has written beta there (the kernel keeps B on chip and
    writes it back at the end of op (j, s+1))."""
    n = a.shape[0]
    ap = ts._chase_pad(a, b)
    vout = a.new_zeros((n, ts.chase_smax(n, b), b))
    ops = [ts.chase_ops(n, b, j) for j in range(max(n - 2, 0))]
    for t in range(lag * len(ops) + max(ops, default=0)):
        step = [(j, t - lag * j) for j in range(len(ops))
                if 0 <= t - lag * j < ops[j]]
        house = {}
        for j, s in step:
            house[j, s] = ts._chase_house(ap, j, s, b)
            ce = j if s == 0 else j + 1 + (s - 1) * b
            r0 = j + 1 + s * b
            ap[r0, ce] = ap[ce, r0] = house[j, s][2]
        held = []
        for j, s in sorted(step, reverse=True):
            ts._chase_apply(ap, j, s, b, *house[j, s], vout)
            r, c = j + 1 + s * b + 2 * b - 1, j + s * b + b
            held.append((r, c, ap[r, c].clone(), ap[c, r].clone()))
        for r, c, x, y in held:
            ap[r, c], ap[c, r] = x, y
    return ap[:n, :n], vout


@pytest.mark.parametrize("n,b", [(37, 2), (33, 3), (50, 3), (61, 16),
                                 (100, 16)])
def test_chase_replay_at_kernel_lag(n, b):
    """K6 starts op (j, s) once op (j-1, s+1) is done (a lag of two ops)
    and waits for (j-1, s+2)'s beta only for B's corner. The chase replayed
    in that order equals _sb2tr_dense bit for bit in float64 (ragged n,
    b = 2, 3, 16); at a lag of one it does not, so the replay can tell."""
    rng = np.random.default_rng(n + b)
    x = rng.standard_normal((n, n))
    i = np.arange(n)
    x = np.where(np.abs(i[:, None] - i[None, :]) <= b, (x + x.T) / 2, 0)
    a = torch.tensor(x)
    ref_t, ref_v = ts._sb2tr_dense(a, b)
    t2, v2 = _chase_replay(a, b, 2)
    assert torch.equal(t2, ref_t) and torch.equal(v2, ref_v)
    t1, _ = _chase_replay(a, b, 1)
    assert not torch.equal(t1, ref_t)


@pytest.mark.parametrize("adjoint", [False, True])
def test_apply_q2_parity_on_jax_reflectors(jax_sbr64, adjoint):
    """The port's diamond backtransform on the JAX chase's own vout
    against the JAX one (its Q2, formed once on the identity, or Q2^T):
    1e-5 (f32 products in other orders)."""
    n, b = 64, 16
    *_, jv, jQ2 = jax_sbr64
    Z = np.random.default_rng(121).standard_normal((n, 7)).astype(np.float32)
    ref = (jQ2.T if adjoint else jQ2).astype(np.float64) @ Z
    out = ts._apply_q2(torch.tensor(jv), torch.tensor(Z), n, b,
                       adjoint=adjoint).numpy()
    assert np.abs(out - ref).max() < 1e-5 * np.abs(ref).max()


def test_sbr_from_reference_backtransform(jax_sbr64):
    """The JAX SBR factorization carried over by from_reference: the
    port's sbr_apply_q of it equals the JAX Q1 Q2 to 1e-5."""
    n, b = 64, 16
    _, _, jVs, jTs, jat, jv, jQ2 = jax_sbr64
    fact = ts.SBRFactorization.from_reference(
        jVs, jTs, jv, np.diagonal(jat), np.diagonal(jat, -1), grid=CPU)
    Z = np.random.default_rng(122).standard_normal((n, 4)).astype(np.float32)
    ref = np.asarray(js._apply_q1(tuple(jnp.asarray(v) for v in jVs),
                                  tuple(jnp.asarray(t) for t in jTs),
                                  jnp.asarray(jQ2 @ Z), b))
    out = ts.sbr_apply_q(fact, torch.tensor(Z), b).numpy()
    assert np.abs(out - ref).max() < 1e-5 * np.abs(ref).max()


def test_hermitian_eig_sbr_path(rng):
    """test_sbr.py's driver case: n = 40 not a band multiple (pad to
    band), eigenvalues, residual and orthogonality; the values-only
    route."""
    n, b = 40, 16
    a = _symm32(rng, n)
    ctrl = HermitianEigCtrl(tridiag_alg="sbr", band=b)
    w, Q = HermitianEig(Et.LOWER, _t(a), vectors=True, ctrl=ctrl)
    w, qd = w.numpy(), Q.global_array()
    ev0 = np.linalg.eigvalsh(a.astype(np.float64))
    scale = max(np.max(np.abs(ev0)), 1)
    assert np.max(np.abs(np.sort(w) - ev0)) < 1e-3 * scale
    assert np.max(np.abs(a @ qd - qd * w[None, :])) < 1e-3 * scale
    assert np.max(np.abs(qd.T @ qd - np.eye(n))) < 1e-4
    w2 = HermitianEig(Et.LOWER, _t(a), vectors=False, ctrl=ctrl).numpy()
    assert np.max(np.abs(np.sort(w2) - ev0)) < 1e-3 * scale


# ---------------------------------------------------------------------------
# the slice step
# ---------------------------------------------------------------------------


def test_make_eig_problem():
    h = make_eig_problem(64, dtype=torch.float64, seed=3)
    assert h.shape == (64, 64) and h.dtype == torch.float64
    assert torch.equal(h, h.mT)
    assert torch.equal(h, make_eig_problem(64, dtype=torch.float64, seed=3))
    # spectrum of (g + g^T)/sqrt(8n) fills about [-1, 1]
    assert 0.7 < float(torch.linalg.eigvalsh(h).abs().max()) < 1.3


@pytest.mark.parametrize("alg", ["auto", "latrd", "sbr"])
def test_hermitian_eig_step_f32(one_device, alg):
    """The step on the CPU, float32, n=96 (band 16 for SBR): bench.py's
    scaled residual below 100, and the eigenvalues against the JAX
    package's HermitianEig of the same matrix to 1e-4 of max|w|."""
    n = 96
    h = make_eig_problem(n, seed=4)
    w, q, r = hermitian_eig_step(h, HermitianEigCtrl(tridiag_alg=alg,
                                                     band=16))
    assert float(r) < 100
    eps = np.finfo(np.float32).eps
    qd = q.double()
    assert float((qd.T @ qd - torch.eye(n, dtype=torch.float64)).abs().max()
                 ) / (eps * n) < 100
    jw, _ = El.HermitianEig(El.LOWER, El.DistMatrix.from_global(
        h.numpy(), grid=one_device))
    assert np.abs(np.asarray(jw) - w.numpy()).max() < 1e-4 * np.abs(
        w.numpy()).max()


def test_hermitian_eig_step_f64_matches_bench_formula():
    """float64, n=60: the returned residual is bench.py's
    max|HQ - QW| / (eps n max|w|), recomputed here in numpy."""
    n = 60
    h = make_eig_problem(n, dtype=torch.float64, seed=5)
    w, q, r = hermitian_eig_step(h)
    hn, qn, wn = h.numpy(), q.numpy(), w.numpy()
    ref = np.abs(hn @ qn - qn * wn[None, :]).max() / (EPS64 * n
                                                      * np.abs(wn).max())
    assert abs(float(r) - ref) <= 1e-6 * ref + 1e-3
    assert float(r) < 100


# ---------------------------------------------------------------------------
# HermitianGenDefEig (test_eig_svd.py:58-73 and :212-230)
# ---------------------------------------------------------------------------


def _pencil(rng, n):
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    return a + a.T, b @ b.T + n * np.eye(n)


def test_gen_def_eig(one_device, rng):
    """AXBX: w against scipy's eigh(a, b) to 1e-11 and the residual
    ||AX - BXW|| / ||A|| below 1e-10, as the JAX test; w against the JAX
    package's to 1e-12 of max|w|."""
    n = 14
    a, b = _pencil(rng, n)
    w, X = HermitianGenDefEig(Et.LOWER, _t(a), _t(b))
    w, x = w.numpy(), X.global_array()
    wref = sla.eigh(a, b, eigvals_only=True)
    assert np.max(np.abs(w - wref)) / max(np.max(np.abs(wref)), 1) < 1e-11
    assert np.linalg.norm(a @ x - b @ (x * w[None, :])) / np.linalg.norm(
        a) < 1e-10
    jw, _ = El.HermitianGenDefEig(El.LOWER, El.DistMatrix.from_global(
        a, grid=one_device), El.DistMatrix.from_global(b, grid=one_device))
    assert np.abs(np.asarray(jw) - w).max() < 1e-12 * np.abs(w).max()


def test_gen_def_eig_pencils(one_device, rng):
    """ABX and BAX: w against scipy's eigh types 2 and 3 (1e-10) and the
    JAX package's (1e-12 of max|w|); residual below 1e-9 ||A||."""
    n = 12
    a, b = _pencil(rng, n)
    for pencil, stype in (("ABX", 2), ("BAX", 3)):
        w, X = HermitianGenDefEig(Et.LOWER, _t(a), _t(b), pencil=pencil)
        w, x = w.numpy(), X.global_array()
        wref = sla.eigh(a, b, type=stype, eigvals_only=True)
        assert np.max(np.abs(w - wref)) / max(np.max(np.abs(wref)), 1) < 1e-10
        lhs = a @ (b @ x) if pencil == "ABX" else b @ (a @ x)
        assert np.linalg.norm(lhs - x * w[None, :]) / np.linalg.norm(a) < 1e-9
        jw, _ = El.HermitianGenDefEig(
            El.LOWER, El.DistMatrix.from_global(a, grid=one_device),
            El.DistMatrix.from_global(b, grid=one_device), pencil=pencil)
        assert np.abs(np.asarray(jw) - w).max() < 1e-12 * np.abs(w).max()


def test_gen_def_eig_values_only_and_bad_pencil(rng):
    a, b = _pencil(rng, 10)
    w = HermitianGenDefEig(Et.LOWER, _t(a), _t(b), vectors=False)
    np.testing.assert_allclose(w.numpy(), sla.eigh(a, b, eigvals_only=True),
                               rtol=0, atol=1e-11 * np.abs(w.numpy()).max())
    with pytest.raises(ValueError):
        HermitianGenDefEig(Et.LOWER, _t(a), _t(b), pencil="XY")


def test_make_gendef_problem():
    a, b = make_gendef_problem(48, dtype=torch.float64, seed=2)
    assert torch.equal(a, make_eig_problem(48, dtype=torch.float64, seed=2))
    assert torch.equal(b, b.mT) and torch.equal(a, a.mT)
    assert float(torch.linalg.eigvalsh(b).min()) > 1.5


@pytest.mark.parametrize("pencil", ["AXBX", "ABX", "BAX"])
def test_gen_def_eig_step_vs_jax(one_device, pencil):
    """gen_def_eig_step at n=64, float64, against the JAX composition
    (Cholesky, TwoSidedTrsm/Trmm, HermitianEig, Trsm/Trmm) on the same
    numpy input: w to 1e-12 of max|w|, X column by column up to sign to
    1e-10 of max|X| (the spectrum is well separated), and the scaled
    residual below 100, recomputed in numpy."""
    n = 64
    a, b = make_gendef_problem(n, dtype=torch.float64, seed=6)
    w, x, r = gen_def_eig_step(a, b, pencil)
    an, bn = a.numpy(), b.numpy()
    jw, jX = El.HermitianGenDefEig(
        El.LOWER, El.DistMatrix.from_global(an, grid=one_device),
        El.DistMatrix.from_global(bn, grid=one_device), pencil=pencil)
    jw, jx = np.asarray(jw), jX.global_array()
    w, x = w.numpy(), x.numpy()
    assert np.abs(jw - w).max() < 1e-12 * np.abs(w).max()
    sign = np.where(np.sum(x * jx, axis=0) < 0, -1.0, 1.0)
    assert np.abs(x * sign[None, :] - jx).max() < 1e-10 * np.abs(jx).max()
    if pencil == "AXBX":
        d, scale = an @ x - bn @ x * w[None, :], (
            np.abs(an).max() + np.abs(w).max() * np.abs(bn).max())
    else:
        lhs = an @ (bn @ x) if pencil == "ABX" else bn @ (an @ x)
        d, scale = lhs - x * w[None, :], (
            np.abs(an).max() * np.abs(bn).max() + np.abs(w).max())
    ref = np.abs(d).max() / (EPS64 * n * scale * np.abs(x).max())
    assert abs(float(r) - ref) <= 1e-6 * ref + 1e-3
    assert float(r) < 100


def test_gen_def_eig_step_f32_fused_tail(monkeypatch):
    """float32 with the fused Cholesky tail: the scaled residual and the
    B-orthogonality max|X^T B X - I| / (eps n) below 100."""
    monkeypatch.setenv("ELX_PALLAS_POTRF", "1")
    n = 80
    a, b = make_gendef_problem(n, seed=7)
    w, x, r = gen_def_eig_step(a, b)
    assert x.dtype == torch.float32 and float(r) < 100
    xd, bd = x.double(), b.double()
    eps = np.finfo(np.float32).eps
    orth = (xd.T @ bd @ xd - torch.eye(n, dtype=torch.float64)).abs().max()
    assert float(orth) / (eps * n) < 100
