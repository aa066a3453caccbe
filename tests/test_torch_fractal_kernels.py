"""Port vs reference for the kernels of the Fractal path and of the
binary Ligero repair, on small cases made from seeded numpy generators,
tolerance 0: K20's twin (the batched inverse with a fused numerator)
against the JAX package's PrimeField.inv and batch_inverse_and_mul on
inputs that hold zeros, over edwards_Fr and alt_bn128_Fr; K21's twin (the
p_alpha * M product placed into the variable slots) against
compute_p_alpha_M_evals at 16 constraints, and on a dense column against
host ints; the GF(2^k) twin of K15
against the reference's XOR _row_sum of F.mul; the batched twin of K17
against its transforms one row at a time.  Each JAX function here costs
an XLA CPU compile of about a second."""
import numpy as np
import pytest
import torch

from libiop_tpu.algebra.domains import MultiplicativeCoset as JaxCoset
from libiop_tpu.fields.binary import gf64 as jax_gf64
from libiop_tpu.fields.prime import alt_bn128_fr as jax_alt_bn128_fr
from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu.protocols import holographic_lincheck as jax_hl
from libiop_tpu.protocols import ligero as jax_ligero
from libiop_tpu.relations.examples import \
    generate_r1cs_example as jax_example
from libiop_tpu_torch.algebra.domains import MultiplicativeCoset
from libiop_tpu_torch.algebra.poly import lagrange_poly_evals_over
from libiop_tpu_torch.algebra.subspace import AffineSubspace, fft_tables
from libiop_tpu_torch.fields.binary import gf64
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import limbs_from_numpy, limbs_to_numpy
from libiop_tpu_torch.kernels.additive_fft import additive_fft
from libiop_tpu_torch.kernels.batch_inv import batch_inv
from libiop_tpu_torch.kernels.p_alpha_m import group_size, p_alpha_m_plain
from libiop_tpu_torch.protocols import holographic_lincheck as hl
from libiop_tpu_torch.protocols import ligero
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.relations.sparse import SparseMatrix
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = {"edwards_Fr": (jax_edwards_fr, edwards_fr),
          "alt_bn128_Fr": (jax_alt_bn128_fr, alt_bn128_fr)}


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_batch_inv_twin_matches_reference_inverse(name):
    """inv (c absent) and batch_inverse_and_mul, with zeros mapping to 0,
    on 37 elements."""
    Fj, Ft = (f() for f in FIELDS[name])
    rng = np.random.default_rng(20)
    a = Ft.random_ints(37, rng)
    a[0] = a[11] = a[36] = 0
    c = Ft.random_ints(37, rng)
    aj, cj = Fj.from_ints_np(a), Fj.from_ints_np(c)
    want_inv = np.asarray(Fj.inv(aj))
    want_mul = np.asarray(Fj.batch_inverse_and_mul(aj, cj))
    at, ct = limbs_from_numpy(aj), limbs_from_numpy(cj)
    np.testing.assert_array_equal(limbs_to_numpy(batch_inv(Ft, at)),
                                  want_inv)
    np.testing.assert_array_equal(limbs_to_numpy(batch_inv(Ft, at, ct)),
                                  want_mul)
    np.testing.assert_array_equal(limbs_to_numpy(Ft.inv(at)), want_inv)


def test_p_alpha_m_twin_matches_reference():
    """K21's twin through the port's compute_p_alpha_M_evals, on p_alpha
    over H of the port's Lagrange polynomial, against the reference's
    composition at 16 constraints (15 variables, 3 inputs)."""
    Fj, Ft = jax_edwards_fr(), edwards_fr()
    cs_j, _, _ = jax_example(Fj, 16, 3, 15, np.random.default_rng(12345))
    cs_t, _, _ = generate_r1cs_example(Ft, 16, 3, 15,
                                       np.random.default_rng(12345))
    rng = np.random.default_rng(21)
    alpha = Ft.random_ints(1, rng)[0]
    r = Ft.random_ints(3, rng)
    Ht = MultiplicativeCoset(Ft, 4)
    p_alpha = lagrange_poly_evals_over(Ht, alpha, Ht, "cpu")
    want = jax_hl.compute_p_alpha_M_evals(
        Fj, 2, JaxCoset(Fj, 4), limbs_to_numpy(p_alpha), r,
        list(cs_j.matrices()))
    got = hl.compute_p_alpha_M_evals(Ft, 2, Ht, p_alpha, r,
                                     list(cs_t.matrices()))
    np.testing.assert_array_equal(limbs_to_numpy(got), np.asarray(want))


def test_p_alpha_m_twin_dense_column():
    """K21's plan and twin where one column holds a nonzero in every row:
    M^T in CSR form takes one slot a nonzero, the kernel would give each
    slot 4 lanes, and the twin equals the sum over host ints, placed with
    a sentinel slot."""
    F = edwards_fr()
    n, S = 64, 16
    rng = np.random.default_rng(23)
    rows = np.concatenate([np.arange(n), rng.integers(0, n, 2 * n)])
    cols = np.concatenate([np.zeros(n, np.int64),
                           rng.integers(1, S, 2 * n)])
    vals = F.random_ints(len(rows), rng)
    M = SparseMatrix(F, n, S, rows, cols, F.from_ints_np(vals))
    plan = M.transpose_csr_device("cpu")
    assert plan[2].numel() == len(rows) and plan[3] == n
    assert group_size([plan]) == 4
    p_ints = F.random_ints(n, rng)
    r = F.random_ints(1, rng)
    inv = torch.tensor([S] + list(range(S)), dtype=torch.int64)
    got = p_alpha_m_plain(F, [plan], F.from_ints(p_ints, "cpu"), r, inv, S)
    want = [0] * S
    for i, j, v in zip(rows, cols, vals):
        want[j] = (want[j] + v * p_ints[i]) % F.p
    assert list(F.to_ints(got)) == [0] + [w * r[0] % F.p for w in want]


def test_binary_row_sum_and_batched_fft_twins():
    """GF(2^64): the port's _row_sum (K15's XOR twin) against the
    reference's _row_sum of F.mul over 5 rows of 24; the batched K17 twin
    against its one-row transforms, forward and inverse, over a shifted
    subspace of 2^5."""
    Fj, Ft = jax_gf64(), gf64()
    rng = np.random.default_rng(22)
    a = rng.integers(0, 1 << 32, size=(Ft.W, 5, 24), dtype=np.uint64)
    b = rng.integers(0, 1 << 32, size=(Ft.W, 5, 24), dtype=np.uint64)
    a, b = a.astype(np.uint32), b.astype(np.uint32)
    want = np.asarray(jax_ligero._row_sum(Fj, Fj.mul(a, b)))
    got = ligero._row_sum(Ft, limbs_from_numpy(a), limbs_from_numpy(b))
    np.testing.assert_array_equal(limbs_to_numpy(got), want)
    D = AffineSubspace(Ft, 5, shift=1 << 40)
    rows = limbs_from_numpy(rng.integers(0, 1 << 32, size=(Ft.W, 3, 32),
                                         dtype=np.uint64).astype(np.uint32))
    for inverse in (False, True):
        tw, sums = fft_tables(D, "cpu", inverse)
        batched = additive_fft(Ft, rows, tw, sums, inverse)
        for r in range(3):
            assert torch.equal(batched[:, r], additive_fft(
                Ft, rows[:, r].contiguous(), tw, sums, inverse))
