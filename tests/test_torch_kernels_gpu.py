"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card, at shapes and broadcast patterns the main paths use, over edwards_Fr
(6-word instantiations) and alt_bn128_Fr (8-word), and the binary-field
kernels (and the binary routes of K7, K10, K11, K15, K17, K21, K22 and K25)
over gf64, gf128, gf192 and gf256; and the FRI SNARK on the card, whose bytes
are the CPU path's.  Marked gpu: each test
skips without a CUDA device.  Imports nothing of JAX, so it also runs
on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from libiop_tpu_torch.algebra.domains import MultiplicativeCoset
from libiop_tpu_torch.bcs import common
from libiop_tpu_torch.fields.limbs import (lazy_sum_reduce_plain,
                                           mont_reduce_wide_plain, mul_plain)
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.kernels import LAUNCHES
from libiop_tpu_torch.kernels.blake2b import blake2b_rows, blake2b_rows_plain
from libiop_tpu_torch.kernels.batch_inv import batch_inv, batch_inv_plain
from libiop_tpu_torch.kernels.bivariate import (bivariate_evals,
                                                bivariate_evals_plain)
from libiop_tpu_torch.kernels.ell_matvec import (ell_matvec,
                                                 ell_matvec_gf2_plain,
                                                 ell_matvec_plain)
from libiop_tpu_torch.kernels.field_addsub import (field_addsub,
                                                   field_addsub_plain)
from libiop_tpu_torch.kernels.fri_fold import fri_fold, fri_fold_plain
from libiop_tpu_torch.kernels.fused_dag import (TapeRecorder, fused_dag,
                                                fused_dag_plain)
from libiop_tpu_torch.kernels.lagrange import (lagrange_coeffs,
                                               lagrange_coeffs_plain)
from libiop_tpu_torch.kernels.lazy_reduce import lazy_reduce
from libiop_tpu_torch.kernels.mont_mul import mont_mul
from libiop_tpu_torch.kernels.ntt import ntt_plan, ntt_stages, ntt_stages_plain
from libiop_tpu_torch.kernels.horner import (horner, horner_gf2_plain,
                                             horner_plain)
from libiop_tpu_torch.kernels.poseidon import (poseidon_hash_columns,
                                               poseidon_merkle_heap,
                                               poseidon_sponge_plain)
from libiop_tpu_torch.kernels.p_alpha_m import (group_size, p_alpha_m,
                                                p_alpha_m_gf2_plain,
                                                p_alpha_m_plain)
from libiop_tpu_torch.kernels.place_columns import (place_columns,
                                                    place_columns_plain)
from libiop_tpu_torch.kernels.powers import (powers, powers_gf2_plain,
                                             powers_plain)
from libiop_tpu_torch.kernels.row_dot import row_dot, row_dot_plain
from libiop_tpu_torch.kernels.rs_encode import rs_encode, rs_encode_plain
from libiop_tpu_torch.kernels.vanishing import (vanishing_divide,
                                                vanishing_divide_plain,
                                                vanishing_multiply,
                                                vanishing_multiply_plain)
from libiop_tpu_torch.protocols.fri import _fold_rows
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.relations.sparse import SparseMatrix
from libiop_tpu_torch.algebra import subspace
from libiop_tpu_torch.algebra.bivariate import (BivariateLagrange,
                                                index_of_element)
from libiop_tpu_torch.algebra import poly
from libiop_tpu_torch.algebra.generic import (lagrange_coefficients_any,
                                              lagrange_coeffs_ints_any,
                                              make_domain,
                                              vanishing_derivative_int,
                                              vanishing_eval_int,
                                              vanishing_evals_over_any)
from libiop_tpu_torch.snark.fri import (FRISnarkParams, fri_snark_prover,
                                        fri_snark_verifier)
from libiop_tpu_torch.fields import binary
from libiop_tpu_torch.kernels.additive_fft import (additive_fft,
                                                   additive_fft_plain)
from libiop_tpu_torch.kernels.fri_fold_additive import (
    fri_fold_additive, fri_fold_additive_plain)
from libiop_tpu_torch.kernels.gf2k_mul import (gf2k_inv, gf2k_inv_plain,
                                               gf2k_mul, gf2k_mul_plain,
                                               gf2k_square, gf2k_square_plain)
from libiop_tpu_torch.kernels.linearized import (linearized_divide,
                                                 linearized_divide_plain,
                                                 linearized_multiply,
                                                 linearized_multiply_plain)

pytestmark = pytest.mark.gpu
FIELDS = {"edwards_Fr": edwards_fr, "alt_bn128_Fr": alt_bn128_fr}
F = edwards_fr()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(params=sorted(FIELDS))
def field(request):
    return FIELDS[request.param]()


def _elems(shape, seed, dev, field=None):
    Fx = field or F
    n = int(np.prod(shape))
    return Fx.from_ints(Fx.random_ints(n, np.random.default_rng(seed)),
                        dev).reshape((Fx.L,) + tuple(shape))


@pytest.mark.parametrize("shape_a,shape_b", [
    ((1000,), (1000,)),          # equal shapes
    ((777,), (1,)),              # broadcast scalar
    ((3, 5, 64), (1, 1, 64)),    # broadcast row
    ((9, 16), (9, 1)),           # broadcast column
    ((4, 1, 8), (1, 6, 1)),      # outer product: materialized operands
])
def test_mont_mul_matches_twin(dev, field, shape_a, shape_b):
    F = field
    a, b = _elems(shape_a, 1, dev, F), _elems(shape_b, 2, dev, F)
    before = LAUNCHES["mont_mul"]
    got = mont_mul(F, a, b)
    torch.cuda.synchronize()
    assert LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(got, mul_plain(F, a, b))
    assert torch.equal(mont_mul(F, b, a), got)


#: (rows, N, first_m) of K2's passes: N below, at and twice the tile T =
#: 2^12 (one pass, one, two); 2^20 with 3 rows; first_m at and above T
#: (the column pass alone); a degree-aware start inside the tile
NTT_GROUPS = {
    "below_at_twice_tile": [(1, 2, 1), (3, 64, 1), (2, 1 << 12, 1),
                            (1, 1 << 13, 1)],
    "2^20_rows_3": [(3, 1 << 20, 1), (1, 1 << 20, 4)],
    "first_m_at_or_above_tile": [(2, 1 << 13, 1 << 12), (1, 1 << 16, 1 << 13),
                                 (2, 1 << 14, 4)],
}


@pytest.mark.parametrize("group", sorted(NTT_GROUPS))
def test_ntt_stages_match_twin(dev, field, group):
    """K2's passes equal the twin's stage loop, forward and inverse tables,
    one launch a pass of ntt_plan."""
    F = field
    for rows, N, first_m in NTT_GROUPS[group]:
        dom = MultiplicativeCoset(F, N.bit_length() - 1, 19)
        x = _elems((rows, N), 3, dev, F)
        for W in (dom.generator_powers(dev), dom.inverse_generator_powers(dev)):
            want = ntt_stages_plain(F, x, W, first_m)
            before = LAUNCHES["ntt_stage"]
            got = ntt_stages(F, x.clone(), W, first_m)
            torch.cuda.synchronize()
            assert LAUNCHES["ntt_stage"] - before == len(ntt_plan(N, first_m))
            assert torch.equal(got, want), (F.name, rows, N, first_m)


@pytest.mark.parametrize("msg_bytes,digest_bytes,tag", [
    (0, 32, 0), (4, 8, 1), (127, 32, 0), (128, 32, 1), (192, 32, 0),
    (385, 64, 1)])
def test_blake2b_rows_match_twin(dev, msg_bytes, digest_bytes, tag):
    nw = max(1, -(-msg_bytes // 4))
    rng = np.random.default_rng(msg_bytes)
    raw = rng.integers(0, 256, size=(37, 4 * nw), dtype=np.uint8)
    raw[:, msg_bytes:] = 0
    words = torch.from_numpy(raw.view(np.int32).copy()).to(dev)
    got = blake2b_rows(words, msg_bytes, digest_bytes, tag)
    torch.cuda.synchronize()
    assert torch.equal(got, blake2b_rows_plain(words, msg_bytes, digest_bytes,
                                               tag))


@pytest.mark.parametrize("eta", [1, 2, 3, 4])
def test_fri_fold_matches_twin(dev, field, eta):
    F = field
    c = 1 << eta
    dom = MultiplicativeCoset(F, 8, 19)
    evals = _elems((dom.order,), eta, dev, F)
    rows = torch.from_numpy(_fold_rows(F, eta)).to(dev)
    xpow = powers(F, _elems((1,), 9, dev, F).reshape(F.L), c)
    winv = dom.inverse_generator_powers(dev)
    got = fri_fold(F, evals, rows, winv, xpow, c)
    torch.cuda.synchronize()
    assert torch.equal(got, fri_fold_plain(F, evals, rows, winv, xpow, c))


@pytest.mark.parametrize("op", ["add", "sub", "neg"])
@pytest.mark.parametrize("shape_a,shape_b", [
    ((1000,), (1000,)), ((777,), (1,)), ((1,), (777,)), ((9, 16), (9, 1)),
    ((4, 1, 8), (1, 6, 1))])
def test_field_addsub_matches_twin(dev, field, op, shape_a, shape_b):
    F = field
    a, b = _elems(shape_a, 4, dev, F), _elems(shape_b, 5, dev, F)
    a[:, 0] = 0                     # 0 - x and -0 hit the borrow edge
    before = LAUNCHES["field_addsub"]
    got = field_addsub(F, op, a, b)
    torch.cuda.synchronize()
    assert LAUNCHES["field_addsub"] == before + 1
    assert torch.equal(got, field_addsub_plain(F, op, a, None if op == "neg"
                                               else b))


@pytest.mark.parametrize("K", ["L", "L+1", "2L+2"])
@pytest.mark.parametrize("montgomery", [False, True])
def test_lazy_reduce_matches_twin(dev, field, K, montgomery):
    """Lazy sums of 4096 canonical values per row (columns near 2^28) and a
    product accumulator's 2L+2 rows of 2^36-sized columns."""
    F = field
    K = {"L": F.L, "L+1": F.L + 1, "2L+2": 2 * F.L + 2}[K]
    rng = np.random.default_rng(K)
    n = 513
    if K == 2 * F.L + 2:
        a, b = _elems((n,), 6, dev, F), _elems((n,), 7, dev, F)
        t = torch.zeros((K, n), dtype=torch.int64, device=dev)
        for i in range(F.L):
            t[i:i + F.L] += a[i].to(torch.int64) * b.to(torch.int64)
    else:
        t = torch.from_numpy(rng.integers(0, 4096 * 65535, size=(K, n))).to(
            dev)
    t[:, 0] = 0
    got = lazy_reduce(F, t, montgomery)
    torch.cuda.synchronize()
    twin = lazy_sum_reduce_plain if montgomery else mont_reduce_wide_plain
    assert torch.equal(got, twin(F, t))


def test_ell_matvec_matches_twin(dev, field):
    F = field
    cs = generate_r1cs_example(F, 256, 15, 255, np.random.default_rng(3))[0]
    z = _elems((256,), 8, dev, F)
    for M in cs.matrices():
        for tag, seg, src, S in (("mv", M.rows, M.cols, M.num_rows),
                                 ("mvT", M.cols, M.rows, M.num_cols)):
            entry, src_flat, K = M._ell_plan(seg, src, S)
            vals = torch.from_numpy(np.ascontiguousarray(np.concatenate(
                [M.vals, np.zeros((F.L, 1), np.int32)], axis=1))).to(dev)
            e = torch.from_numpy(entry).to(dev)
            s = torch.from_numpy(src_flat).to(dev)
            got = ell_matvec(F, vals, e, s, z, K)
            torch.cuda.synchronize()
            assert torch.equal(got, ell_matvec_plain(F, vals, e, s, z, K))


def test_fused_dag_matches_twin(dev, field):
    """A tape with every operand kind, a register reused after its last
    use, a stored input and two roots."""
    F = field
    n = 3000
    b = TapeRecorder()
    x, y, z = b.input(), b.input(), b.input()
    s0, s1 = b.scalar(), b.scalar()
    acc = b.mul(x, s0)
    acc = b.add(acc, b.mul(y, b.sub(s1, z)))
    r0 = b.sub(b.mul(acc, acc), x)
    r1 = b.add(b.mul(r0, s1), b.sub(s0, y))
    tape = b.finish([r0, r1, z])
    inputs = [_elems((n,), 10 + k, dev, F) for k in range(3)]
    scalars = [0, F.p - 1]
    before = LAUNCHES["fused_dag"]
    got = fused_dag(F, tape, inputs, scalars)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_dag"] == before + 1
    want = fused_dag_plain(F, tape, inputs, scalars)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("salt_bytes", [0, 8, 32])
def test_salted_leaf_pipeline_matches_host(dev, salt_bytes):
    from libiop_tpu_torch.algebra.generic import (element_outside_of_subset,
                                                  make_domain)
    from libiop_tpu_torch.bcs.hashing import Blake2bHashing
    dt = make_domain(F, 6, shift=element_outside_of_subset(F, 6))
    evals = [_elems((64,), 20 + k, dev) for k in range(3)]
    salts = np.random.default_rng(salt_bytes).bytes(16 * salt_bytes) \
        if salt_bytes else None
    root, heap, blocks = common.device_leaf_digests(F, evals, dt, 4, 32,
                                                    salts=salts)
    host = common.serialize_leaf_blocks(F, [e.cpu() for e in evals], dt, 4)
    assert blocks.gather(range(16)) == host
    hasher = Blake2bHashing(128)
    sb = salt_bytes
    want = [hasher.leaf_hash(b + (salts[k * sb:(k + 1) * sb] if sb else b""))
            for k, b in enumerate(host)]
    got = heap[16:].cpu().numpy().astype("<u4")
    assert [got[k].tobytes() for k in range(16)] == want


@pytest.mark.parametrize("variant,k,n", [
    ("poseidon", 2, 1000), ("poseidon", 13, 300), ("poseidon", 25, 64),
    ("poseidon_high_alpha", 8, 777), ("T4", 5, 100)])
def test_poseidon_matches_twin(dev, variant, k, n):
    """K9 over alt_bn128_Fr (the presets, t = 3 and the t = 4 one) against
    its twin, and a whole Merkle heap; the constants of two parameter sets
    alternate, so the constant memory is uploaded again between them."""
    from libiop_tpu_torch.bcs import poseidon_presets as presets
    from libiop_tpu_torch.bcs.poseidon import BatchedPoseidon, PoseidonParams
    Fb = alt_bn128_fr()
    params = PoseidonParams.from_preset(Fb, presets.ALTBN_HIGH_ALPHA_T4) \
        if variant == "T4" else PoseidonParams.for_field(Fb, variant)
    bp = BatchedPoseidon(params)
    other = BatchedPoseidon(PoseidonParams.for_field(Fb, "poseidon_high_alpha"
                                                     if variant == "poseidon"
                                                     else "poseidon"))
    elems = _elems((k, n), 30 + k, dev, Fb)
    before = LAUNCHES["poseidon"]
    got = poseidon_hash_columns(bp, elems)
    poseidon_hash_columns(other, elems)
    again = poseidon_hash_columns(bp, elems)
    torch.cuda.synchronize()
    assert LAUNCHES["poseidon"] == before + 3
    want = poseidon_sponge_plain(bp, elems)
    assert torch.equal(got, want) and torch.equal(again, want)
    leaves = elems[:, :, :64].contiguous()
    heap = poseidon_merkle_heap(bp, leaves)
    assert torch.equal(heap, poseidon_merkle_heap(bp, leaves.cpu()).to(dev))


def test_poseidon_edwards_matches_twin(dev):
    from libiop_tpu_torch.bcs.poseidon import BatchedPoseidon, PoseidonParams
    bp = BatchedPoseidon(PoseidonParams.for_field(F, "poseidon"))
    elems = _elems((8, 500), 40, dev)
    got = poseidon_hash_columns(bp, elems)
    torch.cuda.synchronize()
    assert torch.equal(got, poseidon_sponge_plain(bp, elems))


@pytest.mark.parametrize("d,k", [(1, 3), (37, 5), (256, 8), (257, 4),
                                 (3000, 64)])
def test_horner_matches_twin(dev, field, d, k):
    coeffs = _elems((d,), d, dev, field)
    x = _elems((k,), d + 1, dev, field)
    before = LAUNCHES["horner"]
    got = horner(field, coeffs, x)
    torch.cuda.synchronize()
    assert LAUNCHES["horner"] == before + (1 if d <= 256 else 2)
    assert torch.equal(got, horner_plain(field, coeffs, x))


@pytest.mark.parametrize("n", [1, 2, 255, 1 << 12])
def test_powers_matches_twin(dev, field, n):
    x = _elems((1,), 50, dev, field).reshape(field.L)
    start = _elems((1,), 51, dev, field).reshape(field.L)
    for s in (None, start):
        got = powers(field, x, n, s)
        torch.cuda.synchronize()
        assert torch.equal(got, powers_plain(field, x, n, s))


@pytest.mark.parametrize("h,nb,d", [(8, 1, 5), (8, 4, 29), (256, 3, 700),
                                    (1024, 2, 2048), (16, 300, 100)])
def test_vanishing_matches_twin(dev, field, h, nb, d):
    a = _elems((1,), 60, dev, field).reshape(field.L)
    f = _elems((nb * h,), 61, dev, field)
    q, r = vanishing_divide(field, f, a, h)
    torch.cuda.synchronize()
    qw, rw = vanishing_divide_plain(field, f, a, h)
    assert torch.equal(q, qw) and torch.equal(r, rw)
    g = _elems((d,), 62, dev, field)
    got = vanishing_multiply(field, g, a, h)
    torch.cuda.synchronize()
    assert torch.equal(got, vanishing_multiply_plain(field, g, a, h))


def test_place_columns_matches_twin(dev):
    """K13 over both limb counts: a sentinel-only map (every column zero),
    a full permutation and partial placements, n and nv multiples of 4 (the
    16-byte path) or not (37 into 103, 4,097 into 4,099: the scalar path
    and its tail), each with int32 and int64 indices, contiguous and as a
    view one entry into a larger map (not 16-byte aligned)."""
    for field in FIELDS.values():
        F = field()
        for kind, nv, n in (("sentinel_only", 37, 100),
                            ("permutation", 37, 37),
                            ("permutation", 1024, 1024),
                            ("partial", 37, 100), ("partial", 37, 103),
                            ("partial", 4097, 4099), ("partial", 1000, 1024)):
            rng = np.random.default_rng(nv + n)
            values = _elems((3, nv), 70, dev, F)
            inv = np.full(n, nv, np.int64)
            if kind == "permutation":
                inv = rng.permutation(nv)
            elif kind == "partial":
                inv[rng.permutation(n)[:nv]] = np.arange(nv)
            for index_dtype in (torch.int32, torch.int64):
                whole = torch.from_numpy(np.concatenate([[nv], inv])).to(
                    index_dtype).to(dev)
                for view in (False, True):
                    idx = whole[1:] if view else whole[1:].clone()
                    before = LAUNCHES["place_columns"]
                    got = place_columns(values, idx)
                    torch.cuda.synchronize()
                    case = (F.name, kind, nv, n, index_dtype, view)
                    assert LAUNCHES["place_columns"] == before + 1, case
                    assert torch.equal(got,
                                       place_columns_plain(values, idx)), case
                    assert kind != "sentinel_only" or not got.any(), case


def test_rs_encode_matches_twin(dev):
    """K14 over both widths: |H| = 2^3, 2^10, 2^12 into codewords 2^2 and
    2^3 times larger, and the zk row blinding oracle's extended domain
    (2|H|) into 4|H| for |H| = 8 and 2^10."""
    for field in FIELDS.values():
        F = field()
        cases = [(h, e, False) for h in (8, 1 << 10, 1 << 12) for e in (2, 3)]
        cases += [(h, 2, True) for h in (8, 1 << 10)]
        for h, e, extended in cases:
            dim = h.bit_length() - 1
            src = MultiplicativeCoset(F, dim + extended)
            L = MultiplicativeCoset(F, dim + e, F.multiplicative_generator)
            values = _elems((1 if extended else 3, src.order), h + e, dev, F)
            before = LAUNCHES["rs_encode"]
            got = rs_encode(F, values, src, L)
            torch.cuda.synchronize()
            case = (F.name, h, e, extended)
            assert LAUNCHES["rs_encode"] == before + 1, case
            assert torch.equal(got, rs_encode_plain(F, values, src, L)), case


def test_row_dot_matches_twin(dev):
    """K15 over both widths at R = 1, 64, 65, 257, 513 rows (the 8-word
    accumulator folds every four products), with a full b and with one
    scalar a row."""
    N = 1000
    for field in FIELDS.values():
        F = field()
        for R in (1, 64, 65, 257, 513):
            a = _elems((R, N), R, dev, F)
            for scalar_rows in (False, True):
                b = _elems((R, 1 if scalar_rows else N), R + 1, dev, F)
                before = LAUNCHES["row_dot"]
                got = row_dot(F, a, b)
                torch.cuda.synchronize()
                case = (F.name, R, scalar_rows)
                assert LAUNCHES["row_dot"] == before + 1, case
                assert torch.equal(got, row_dot_plain(F, a, b)), case


BINARY = ("gf64", "gf128", "gf192", "gf256")


def _gf_elems(Fb, shape, seed, dev):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return Fb.from_ints(Fb.random_ints(n, rng), dev).reshape((Fb.W,) + shape)


def test_gf2k_mul_square_inv_match_twins(dev):
    """K16 over every binary width: products with equal shapes, a
    broadcast scalar, row and column, squares, and inverses (0 included)."""
    for name in BINARY:
        Fb = getattr(binary, name)()
        a = _gf_elems(Fb, (5, 67), 1, dev)
        a[:, 0, 0] = 0
        for b in (_gf_elems(Fb, (5, 67), 2, dev), _gf_elems(Fb, (1,), 3, dev),
                  _gf_elems(Fb, (67,), 4, dev), _gf_elems(Fb, (5, 1), 5, dev)):
            before = LAUNCHES["gf2k_mul"]
            got = gf2k_mul(Fb, a, b)
            torch.cuda.synchronize()
            assert LAUNCHES["gf2k_mul"] == before + 1
            assert torch.equal(got, gf2k_mul_plain(Fb, a, b)), (name, b.shape)
        assert torch.equal(gf2k_square(Fb, a), gf2k_square_plain(Fb, a)), name
        inv = gf2k_inv(Fb, a)
        assert torch.equal(inv, gf2k_inv_plain(Fb, a)), name
        assert Fb.to_ints(inv)[0, 0] == 0


def test_additive_fft_matches_twin(dev):
    """K17 forward and inverse over every binary width: shifted subspaces
    of every size 2^1 .. 2^20 (one pass up to 2^8, then column, tile,
    class and final passes, blocks of 2^8 to 2^13), three rows at each
    change of the plan, and a random basis; each transform launches
    exactly the passes of its plan; the inverse undoes the forward."""
    from libiop_tpu_torch.kernels.additive_fft import additive_fft_plan
    for name in BINARY:
        Fb = getattr(binary, name)()
        rng = np.random.default_rng(7)
        doms = [subspace.AffineSubspace(Fb, m, shift=1 << m)
                for m in range(1, 21)]
        doms.append(subspace.AffineSubspace(
            Fb, 6, shift=Fb.random_ints(1, rng)[0],
            basis=Fb.random_ints(6, rng)))
        for D in doms:
            m = D.dim
            for rows in (1, 3) if m in (7, 8, 9, 15, 16, 17, 18, 19) else (1,):
                x = _gf_elems(Fb, (rows, D.order) if rows > 1 else
                              (D.order,), m + rows, dev)
                for inverse in (False, True):
                    tw, sums = subspace.fft_tables(D, dev, inverse)
                    before = LAUNCHES["additive_fft"]
                    got = additive_fft(Fb, x, tw, sums, inverse)
                    torch.cuda.synchronize()
                    assert LAUNCHES["additive_fft"] - before == len(
                        additive_fft_plan(m, Fb.W)), (name, m, rows)
                    assert torch.equal(got, additive_fft_plain(
                        Fb, x, tw, sums, inverse)), (name, m, rows, inverse)
            if m <= 12:
                x = _gf_elems(Fb, (D.order,), m, dev)
                assert torch.equal(subspace.additive_ifft(
                    subspace.additive_fft(x, D), D), x), (name, m)


def test_linearized_matches_twin(dev, monkeypatch):
    """K18: division (one and many chunks, an uneven last chunk) and
    multiplication by Z of subspaces of 2, 16, 2^7 and 2^10 points.  The
    blocked scan (h <= 2^7) at the witness's deep division (h = 16 over
    65,648 and 65,645 coefficients), at segment edges (the quotient one
    segment, one segment and one position, a bottom segment of one
    position) and at segment lengths other than scan_segment's; h = 2^7
    over gf256 keeps its nibble tables in device memory; h = 2^10 takes a
    launch a chunk."""
    from libiop_tpu_torch.algebra.generic import linearized_vanishing
    from libiop_tpu_torch.kernels import linearized as k18
    planned = k18.scan_segment
    for name, dim, d, segment in (
            [(n, dim, d, None) for n in ("gf64", "gf192")
             for dim, d in ((1, 9), (4, 17), (4, 300), (10, 2 * 1024 - 1),
                            (10, 3000), (4, 16 + 1024), (4, 16 + 1024 + 1),
                            (4, 16 + 2 * 1024 + 1), (7, 5000))]
            + [("gf192", 4, 65648, None), ("gf192", 4, 65645, None),
               ("gf192", 1, 9, 2), ("gf192", 1, 9, 8), ("gf192", 4, 300, 16),
               ("gf192", 4, 16 + 3 * 64 + 5, 64), ("gf256", 7, 5000, None),
               ("gf256", 4, 65648, None)]):
        Fb = getattr(binary, name)()
        H = subspace.AffineSubspace(Fb, dim, shift=1 << (dim + 3))
        Z = linearized_vanishing(H)
        terms = Z.coeffs_dense_positions()
        below = [(g, c) for g, c in terms if g < H.order]
        f = _gf_elems(Fb, (d,), d, dev)
        monkeypatch.setattr(k18, "scan_segment", planned if segment is None
                            else lambda d, h, B=segment: B)
        before = LAUNCHES["linearized"]
        got = linearized_divide(Fb, f, below, H.order)
        torch.cuda.synchronize()
        assert LAUNCHES["linearized"] > before
        want = linearized_divide_plain(Fb, f, below, H.order)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), \
            (name, dim, d, segment)
        if d <= 3000:
            assert torch.equal(linearized_multiply(Fb, f, terms, H.order),
                               linearized_multiply_plain(Fb, f, terms,
                                                         H.order))


def test_fri_fold_additive_matches_twin(dev):
    """K19's block batch inversion over every binary width: one partial
    block (2^3 positions), a shifted 2^10 and several blocks (2^13), eta
    1, 2 and 3, at points outside the domain and at domain elements in
    the first and the last block (a zero difference enters the block
    product as 1); one launch a fold."""
    from libiop_tpu_torch.protocols import fri
    for name in BINARY:
        Fb = getattr(binary, name)()
        for dim in (3, 10, 13):
            D = subspace.AffineSubspace(Fb, dim, shift=1 << dim)
            v = _gf_elems(Fb, (D.order,), dim, dev)
            for eta in (1, 2, 3):
                Z = fri.localizer_vanishing(D, eta)
                offs = fri.coset_vanishing_offsets(D, eta, Z, dev)
                for x in (Fb.random_ints(1, np.random.default_rng(eta))[0],
                          D.element_by_index_int(1),
                          D.element_by_index_int(D.order - 2)):
                    args = (Fb, v, D.elements(dev), offs, x,
                            Z.eval_at_point_int(x), Fb.inv_int(Z.epsilon),
                            1 << eta)
                    before = LAUNCHES["fri_fold_additive"]
                    got = fri_fold_additive(*args)
                    torch.cuda.synchronize()
                    assert LAUNCHES["fri_fold_additive"] == before + 1
                    assert torch.equal(got, fri_fold_additive_plain(*args)), \
                        (name, dim, eta, x)


def test_fused_dag_binary_matches_twin(dev):
    """K8's GF(2^k) instantiation on a tape with every op kind, scalars and
    inputs, over every binary width."""
    for name in BINARY:
        Fb = getattr(binary, name)()
        b = TapeRecorder()
        x, y, z = b.input(), b.input(), b.input()
        s = b.scalar()
        t = b.mul(b.add(x, s), y)
        u = b.sub(b.mul(t, z), x)
        tape = b.finish([u, b.mul(u, u)])
        n = 1000
        inputs = [_gf_elems(Fb, (n,), k, dev) for k in range(3)]
        scalars = Fb.random_ints(1, np.random.default_rng(9))
        before = LAUNCHES["fused_dag"]
        got = fused_dag(Fb, tape, inputs, scalars)
        torch.cuda.synchronize()
        assert LAUNCHES["fused_dag"] == before + 1
        want = fused_dag_plain(Fb, tape, inputs, scalars)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


def test_batch_inv_matches_twin(dev, field):
    """K20 with and without a numerator, zeros included, across block
    boundaries (2048 elements a block) and a partial last block."""
    F = field
    for n in (1, 5, 2048, 2049, 70001):
        rng = np.random.default_rng(n)
        ints = F.random_ints(n, rng)
        for z in range(0, n, 7):
            ints[z] = 0
        a = F.from_ints(ints, dev)
        c = _elems((n,), n + 1, dev, F)
        before = LAUNCHES["batch_inv"]
        got = batch_inv(F, a)
        torch.cuda.synchronize()
        assert LAUNCHES["batch_inv"] == before + 1
        assert torch.equal(got, batch_inv_plain(F, a, None)), n
        assert torch.equal(batch_inv(F, a, c), batch_inv_plain(F, a, c)), n
        if n < 100:
            assert list(F.to_ints(got)) == [pow(x, F.p - 2, F.p)
                                            for x in ints]


def test_p_alpha_m_matches_twin(dev, field):
    """K21 on the three matrices of an example at 2^12 (M^T in CSR form),
    a permuted placement with sentinel slots."""
    F = field
    n = 1 << 12
    cs, _, _ = generate_r1cs_example(F, n, 15, n - 1,
                                     np.random.default_rng(0))
    mats = list(cs.matrices())
    plans = [M.transpose_csr_device(dev) for M in mats]
    S = mats[0].num_cols
    inv = torch.from_numpy(np.random.default_rng(3).permutation(S + 64))
    inv = torch.where(inv >= S, torch.full_like(inv, S), inv).to(dev)
    p = _elems((n,), 4, dev, F)
    r = F.random_ints(3, np.random.default_rng(5))
    before = LAUNCHES["p_alpha_m"]
    got = p_alpha_m(F, plans, p, r, inv, S)
    torch.cuda.synchronize()
    assert LAUNCHES["p_alpha_m"] == before + 1
    assert torch.equal(got, p_alpha_m_plain(F, plans, p, r, inv, S))


def test_p_alpha_m_dense_column_matches_twin(dev, field):
    """K21 where one column holds a nonzero in every row (a constant
    column, as real circuits have) beside sparse ones: 32 lanes a slot."""
    F = field
    n, S = 1 << 12, 1 << 10
    rng = np.random.default_rng(11)
    rows = np.concatenate([np.arange(n), rng.integers(0, n, 3 * n)])
    cols = np.concatenate([np.zeros(n, np.int64),
                           rng.integers(1, S, 3 * n)])
    mats = [SparseMatrix(F, n, S, rows, cols,
                         F.from_ints_np(F.random_ints(len(rows), rng)))
            for _ in range(2)]
    plans = [M.transpose_csr_device(dev) for M in mats]
    assert plans[0][3] == n and group_size(plans) == 32
    assert all(plan[2].numel() == len(rows) for plan in plans)
    inv = torch.arange(S, dtype=torch.int64).flip(0).to(dev)
    p = _elems((n,), 12, dev, F)
    r = F.random_ints(2, rng)
    got = p_alpha_m(F, plans, p, r, inv, S)
    assert torch.equal(got, p_alpha_m_plain(F, plans, p, r, inv, S))


def test_row_dot_binary_matches_twin(dev):
    """K15's GF(2^k) instantiation over every binary width, a full b and
    one scalar a row, R = 1, 7 and 300 rows."""
    for name in BINARY:
        Fb = getattr(binary, name)()
        for R in (1, 7, 300):
            a = _gf_elems(Fb, (R, 999), R, dev)
            for nb in (999, 1):
                b = _gf_elems(Fb, (R, nb), R + nb, dev)
                before = LAUNCHES["row_dot"]
                got = row_dot(Fb, a, b)
                torch.cuda.synchronize()
                assert LAUNCHES["row_dot"] == before + 1
                assert torch.equal(got, row_dot_plain(Fb, a, b)), (name, R, nb)


def test_additive_fft_batched_matches_twin(dev):
    """K17 over a batch of rows: one launch a level for all rows, equal to
    the twin and to the one-row transforms, forward and inverse."""
    for name in ("gf64", "gf192"):
        Fb = getattr(binary, name)()
        D = subspace.AffineSubspace(Fb, 10, shift=1 << 20)
        x = _gf_elems(Fb, (5, D.order), 11, dev)
        for inverse in (False, True):
            tw, sums = subspace.fft_tables(D, dev, inverse)
            one = additive_fft(Fb, x[:, 0].contiguous(), tw, sums, inverse)
            before = LAUNCHES["additive_fft"]
            got = additive_fft(Fb, x, tw, sums, inverse)
            torch.cuda.synchronize()
            per_transform = LAUNCHES["additive_fft"] - before
            assert torch.equal(got[:, 0], one), (name, inverse)
            assert torch.equal(got, additive_fft_plain(Fb, x, tw, sums,
                                                       inverse))
            rows = [additive_fft(Fb, x[:, r].contiguous(), tw, sums, inverse)
                    for r in range(5)]
            assert torch.equal(got, torch.stack(rows, dim=1))
            assert LAUNCHES["additive_fft"] - before == 6 * per_transform


def test_ell_matvec_binary_matches_twin(dev):
    """K7's GF(2^k) instantiation at W 2 and 6 on the example's matrices at
    2^8, M z and M^T y, and on a plan with a row of only padding."""
    for name in ("gf64", "gf192"):
        Fb = getattr(binary, name)()
        cs = generate_r1cs_example(Fb, 256, 15, 255,
                                   np.random.default_rng(3))[0]
        z = _gf_elems(Fb, (256,), 8, dev)
        for M in cs.matrices():
            for seg, src, S in ((M.rows, M.cols, M.num_rows),
                                (M.cols, M.rows, M.num_cols)):
                entry, src_flat, K = M._ell_plan(seg, src, S)
                vals = torch.from_numpy(np.ascontiguousarray(np.concatenate(
                    [M.vals, np.zeros((Fb.W, 1), np.int32)], axis=1))).to(dev)
                e = torch.from_numpy(entry).to(dev)
                s = torch.from_numpy(src_flat).to(dev)
                before = LAUNCHES["ell_matvec_gf2"]
                got = ell_matvec(Fb, vals, e, s, z, K)
                torch.cuda.synchronize()
                assert LAUNCHES["ell_matvec_gf2"] == before + 1
                assert torch.equal(got, ell_matvec_gf2_plain(Fb, vals, e, s,
                                                             z, K)), name
        vals = _gf_elems(Fb, (5,), 9, dev)
        vals[:, -1] = 0
        e = torch.tensor([0, 1, 4, 4, 2, 3], dtype=torch.int64, device=dev)
        s = torch.tensor([0, 2, 0, 0, 1, 1], dtype=torch.int64, device=dev)
        z = _gf_elems(Fb, (3,), 10, dev)
        got = ell_matvec(Fb, vals, e, s, z, 2)
        assert not got[:, 1].any()
        assert torch.equal(got, ell_matvec_gf2_plain(Fb, vals, e, s, z, 2))


def test_horner_binary_matches_twin(dev):
    """K10's GF(2^k) instantiation at W 2 and 6, one launch at d <= 256,
    two above."""
    for name in ("gf64", "gf192"):
        Fb = getattr(binary, name)()
        for d, k in ((1, 3), (37, 5), (256, 8), (257, 4), (3000, 64)):
            coeffs = _gf_elems(Fb, (d,), d, dev)
            x = _gf_elems(Fb, (k,), d + 1, dev)
            before = LAUNCHES["horner_gf2"]
            got = horner(Fb, coeffs, x)
            torch.cuda.synchronize()
            assert LAUNCHES["horner_gf2"] == before + (1 if d <= 256 else 2)
            assert torch.equal(got, horner_gf2_plain(Fb, coeffs, x)), \
                (name, d)


def test_powers_binary_matches_twin(dev):
    """K11's GF(2^k) instantiation at W 2 and 6, with and without a
    start, from one thread to the 2^17-thread walk."""
    for name in ("gf64", "gf192"):
        Fb = getattr(binary, name)()
        x = _gf_elems(Fb, (1,), 50, dev).reshape(Fb.W)
        start = _gf_elems(Fb, (1,), 51, dev).reshape(Fb.W)
        for n in (1, 2, 17, 255, 1 << 12, (1 << 21) + 3):
            for s in (None, start):
                before = LAUNCHES["powers_gf2"]
                got = powers(Fb, x, n, s)
                torch.cuda.synchronize()
                assert LAUNCHES["powers_gf2"] == before + 1
                assert torch.equal(got, powers_gf2_plain(Fb, x, n, s)), \
                    (name, n)


def test_p_alpha_m_binary_matches_twin(dev):
    """K21's GF(2^k) instantiation at W 2 and 6: the three matrices of an
    example at 2^12 with a permuted placement and sentinel slots, and a
    dense column (32 lanes a slot)."""
    for name in ("gf64", "gf192"):
        Fb = getattr(binary, name)()
        n = 1 << 12
        cs, _, _ = generate_r1cs_example(Fb, n, 15, n - 1,
                                         np.random.default_rng(0))
        mats = list(cs.matrices())
        plans = [M.transpose_csr_device(dev) for M in mats]
        S = mats[0].num_cols
        inv = torch.from_numpy(np.random.default_rng(3).permutation(S + 64))
        inv = torch.where(inv >= S, torch.full_like(inv, S), inv).to(dev)
        p = _gf_elems(Fb, (n,), 4, dev)
        r = Fb.random_ints(3, np.random.default_rng(5))
        before = LAUNCHES["p_alpha_m_gf2"]
        got = p_alpha_m(Fb, plans, p, r, inv, S)
        torch.cuda.synchronize()
        assert LAUNCHES["p_alpha_m_gf2"] == before + 1
        assert torch.equal(got, p_alpha_m_gf2_plain(Fb, plans, p, r, inv, S))
        S = 1 << 10
        rng = np.random.default_rng(11)
        rows = np.concatenate([np.arange(n), rng.integers(0, n, 3 * n)])
        cols = np.concatenate([np.zeros(n, np.int64),
                               rng.integers(1, S, 3 * n)])
        mats = [SparseMatrix(Fb, n, S, rows, cols,
                             Fb.from_ints_np(Fb.random_ints(len(rows), rng)))
                for _ in range(2)]
        plans = [M.transpose_csr_device(dev) for M in mats]
        assert group_size(plans) == 32
        inv = torch.arange(S, dtype=torch.int64).flip(0).to(dev)
        r = Fb.random_ints(2, rng)
        got = p_alpha_m(Fb, plans, p, r, inv, S)
        assert torch.equal(got, p_alpha_m_gf2_plain(Fb, plans, p, r, inv,
                                                    S)), name



def _bivariate_domains(Fx, log_s, log_l):
    """S and a domain L disjoint from it (a coset of the generator, or a
    subspace shifted off S)."""
    if Fx.kind == "additive":
        return make_domain(Fx, log_s), make_domain(Fx, log_l, shift=1 << 40)
    return make_domain(Fx, log_s), make_domain(
        Fx, log_l, shift=Fx.multiplicative_generator)


def test_bivariate_matches_twin(dev):
    """K22 through BivariateLagrange.evaluations_over over both prime
    fields (6 and 8 words) and every binary width, one launch a call, with
    x off L and on L (the diagonal), at |L| of 32, 2048 and 8192 (part of a
    block of 2048, one block, four), equal to its twin and, on a sample,
    to the host-int definition; then a part-filled last block."""
    for name in sorted(FIELDS) + list(BINARY):
        _check_bivariate(dev, name)


def _check_bivariate(dev, name):
    Fx = FIELDS[name]() if name in FIELDS else getattr(binary, name)()
    counter = "bivariate_gf2" if Fx.kind == "additive" else "bivariate"
    for log_s, log_l in ((2, 5), (4, 11), (6, 13)):
        S, L = _bivariate_domains(Fx, log_s, log_l)
        f = BivariateLagrange(S)
        ys = L.elements(dev)
        zy = vanishing_evals_over_any(S, L, dev)
        x_off = Fx.random_ints(1, np.random.default_rng(log_l))[0]
        for x in (x_off, L.element_by_index_int(L.order - 3)):
            before = LAUNCHES[counter]
            got = f.evaluations_over(x, L, dev)
            torch.cuda.synchronize()
            assert LAUNCHES[counter] == before + 1
            want = bivariate_evals_plain(
                Fx, ys, zy, x, vanishing_eval_int(S, x),
                vanishing_derivative_int(S, x), index_of_element(L, x))
            assert torch.equal(got, want), (name, log_l, x)
            k = min(40, L.order)
            vals = Fx.to_ints(got[:, -k:])
            for i in range(L.order - k, L.order):
                assert int(vals[i - L.order + k]) == \
                    f.evaluation_at_point_int(
                        x, L.element_by_index_int(i)), (name, i)
    # a part-filled block: n not a multiple of the block's 2048 elements
    n = 2048 + 77
    ys, zy = ys[:, :n].contiguous(), zy[:, :n].contiguous()
    args = (x_off, 5, 7, 100)
    got = bivariate_evals(Fx, ys, zy, *args)
    assert torch.equal(got, bivariate_evals_plain(Fx, ys, zy, *args)), name


def test_lagrange_matches_twin(dev):
    """K25 through lagrange_coefficients_any over both prime fields and
    every binary width, one launch a call, with alpha off H and on H (the
    one-hot vector), at |H| of 8, 2048 and 8192 (part of a block of 2048,
    one block, four), equal to its twin and, at |H| = 8, to the host-int
    coefficients; then poly.lagrange_coefficients at a device alpha, and a
    part-filled last block."""
    for name in sorted(FIELDS) + list(BINARY):
        Fx = FIELDS[name]() if name in FIELDS else getattr(binary, name)()
        counter = ("lagrange_coeffs_gf2" if Fx.kind == "additive"
                   else "lagrange_coeffs")
        for log_h in (3, 11, 13):
            H = make_domain(Fx, log_h)
            hs = H.elements(dev)
            ws = None if Fx.kind == "additive" else H.generator_powers(dev)
            a_off = Fx.random_ints(1, np.random.default_rng(log_h))[0]
            for a in (a_off, H.element_by_index_int(H.order - 3)):
                before = LAUNCHES[counter]
                got = lagrange_coefficients_any(H, a, dev)
                torch.cuda.synchronize()
                assert LAUNCHES[counter] == before + 1
                want = lagrange_coeffs_plain(Fx, hs, ws,
                                             _lagrange_scal(Fx, H, a, dev))
                assert torch.equal(got, want), (name, log_h, a)
                if log_h == 3:
                    assert [int(v) for v in Fx.to_ints(got)] == \
                        lagrange_coeffs_ints_any(H, a), (name, a)
        if Fx.kind != "additive":
            alpha = Fx.from_ints([a_off], dev).reshape(Fx.L)
            before = LAUNCHES[counter]
            got = poly.lagrange_coefficients(H, alpha)
            torch.cuda.synchronize()
            assert LAUNCHES[counter] == before + 1
            assert torch.equal(got, lagrange_coefficients_any(H, a_off, dev))
        n = 2048 + 77
        scal = _lagrange_scal(Fx, H, a_off, dev)
        hs_n = hs[:, :n].contiguous()
        ws_n = None if ws is None else ws[:, :n].contiguous()
        assert torch.equal(lagrange_coeffs(Fx, hs_n, ws_n, scal),
                           lagrange_coeffs_plain(Fx, hs_n, ws_n, scal)), name


def _lagrange_scal(Fx, H, a, dev):
    """The (L, 2) buffer of alpha and zeta that lagrange_coefficients_any
    hands K25."""
    if Fx.kind == "additive":
        c = vanishing_derivative_int(H, a)
    else:
        c = Fx.mul_ints(H.order % Fx.p, Fx.pow_int(H.shift, H.order - 1))
    zeta = Fx.mul_ints(vanishing_eval_int(H, a), Fx.inv_int(c))
    return Fx.from_ints([Fx.sample_int(a), zeta], dev)


def test_fri_snark_on_the_card_gives_the_cpu_bytes(dev):
    """The FRI SNARK (K2 encodes, K3 tree, K4 folds) proves on the card the
    bytes of the CPU path (tests/test_torch_fri_snark.py's edwards_Fr pin)
    and its verifier accepts them."""
    import hashlib
    Fx = edwards_fr()
    params = FRISnarkParams(security_parameter=32, codeword_domain_dim=8,
                            RS_extra_dimensions=2, localization_parameter=1,
                            num_oracles=2, pow_bits=2, override_fri_queries=4,
                            override_fri_interactive_repetitions=1)
    before = dict(LAUNCHES)
    proof = fri_snark_prover(Fx, params, rng=np.random.default_rng(3),
                             device=dev)
    for k in ("ntt_stage", "blake2b_rows", "fri_fold"):
        assert LAUNCHES[k] > before[k], k
    blob = proof.serialize()
    assert hashlib.sha256(blob).hexdigest() == \
        "bbd18bb0e21d5088443eca6e58e6a58d41feb9b038fd30ddce84027464e86626"
    assert fri_snark_verifier(Fx, proof, params, device=dev)


def test_four_step_matches_twins(dev):
    """K23's four launch shapes against their twins on 2^12 plans over both
    widths: R = C = 64 on D = 1, 2, 4, 8 shards and batches of 1-3, and
    R = 64, C = 8 on D = 8 and 4 (C/D = 1 and 2: the unpack's and the
    epilogue's 4-byte path); the prologue with and without the shift and
    with d < N."""
    from libiop_tpu_torch.kernels import four_step
    for F in (f() for f in FIELDS.values()):
        for R, C, D, B in ((64, 64, 1, 1), (64, 64, 2, 3), (64, 64, 4, 1),
                           (64, 64, 8, 2), (64, 8, 8, 1), (64, 8, 4, 3)):
            N = R * C
            dom = MultiplicativeCoset(F, N.bit_length() - 1, 19)
            sp, W = dom.shift_powers(dev), dom.generator_powers(dev)
            case = (F.name, R, C, D, B)
            for d in (N, N - 333):
                x = _elems((B, d), d, dev, F)
                for s in range(D):
                    for table in (None, sp):
                        before = LAUNCHES["four_step_prologue"]
                        got = four_step.prologue(F, x, s, D, R, C, table)
                        torch.cuda.synchronize()
                        assert LAUNCHES["four_step_prologue"] == before + 1
                        assert torch.equal(got, four_step.prologue_plain(
                            F, x, s, D, R, C, table)), (case, d, s)
            a = _elems((B, R // D, C), 5, dev, F)
            for s in range(D):
                assert torch.equal(
                    four_step.twiddle_pack(F, a, s, D, W),
                    four_step.twiddle_pack_plain(F, a, s, D, W)), (case, s)
            recv = _elems((D, B, R // D, C // D), 6, dev, F).movedim(
                1, 0).contiguous()
            assert torch.equal(four_step.unpack(F, recv, R),
                               four_step.unpack_plain(recv, R)), case
            g = _elems((D, B, C // D, R), 7, dev, F).movedim(1, 0).contiguous()
            assert torch.equal(four_step.epilogue(F, g, C),
                               four_step.epilogue_plain(g, C)), case
            torch.cuda.synchronize()


def test_sharded_ntt_on_the_card_equals_fft(dev):
    """ShardedNTT over D shards on one card equals K2's fft byte for byte,
    shift 1 and a coset shift, both widths (2^8 on 8 shards, 2^13 on 4,
    2^16 on 2)."""
    from libiop_tpu_torch.algebra.fft import fft
    from libiop_tpu_torch.parallel.mesh import make_codeword_mesh
    from libiop_tpu_torch.parallel.shard_ntt import ShardedNTT
    for F in (f() for f in FIELDS.values()):
        for dim, D in ((8, 8), (13, 4), (16, 2)):
            mesh = make_codeword_mesh(devices=[dev] * D)
            for shift in (1, F.multiplicative_generator):
                dom = MultiplicativeCoset(F, dim, shift)
                coeffs = _elems((dom.order - 3,), dim, dev, F)
                assert torch.equal(ShardedNTT(dom, mesh)(coeffs),
                                   fft(coeffs, dom)), (F.name, dim, D, shift)


def test_ldt_combine_matches_twin(dev):
    """K24 against its twin on 262 strided views of one (L, n, N) array,
    every seventh input with a x^Delta table, prime fields (the 8-word
    accumulator folds every four products) and the four binary widths."""
    from libiop_tpu_torch.kernels.ldt_combine import (ldt_combine,
                                                      ldt_combine_plain)
    n, N = 262, 1 << 12
    for Fx in [f() for f in FIELDS.values()] + [
            getattr(binary, name)() for name in BINARY]:
        rng = np.random.default_rng(n)
        stacked = Fx.from_ints(Fx.random_ints(n * N, rng), dev).reshape(
            Fx.L, n, N)
        tables = [Fx.from_ints(Fx.random_ints(N, rng), dev)
                  if k % 7 == 3 else None for k in range(n)]
        coeffs = Fx.random_ints(n, rng)
        sub = [Fx.random_ints(1, rng)[0] if t is not None else None
               for t in tables]
        inputs = [stacked[:, k] for k in range(n)]
        key = "ldt_combine_gf2" if Fx.kind == "additive" else "ldt_combine"
        before = LAUNCHES[key]
        got = ldt_combine(Fx, inputs, coeffs, sub, tables)
        torch.cuda.synchronize()
        assert LAUNCHES[key] == before + 1, Fx.name
        assert torch.equal(got, ldt_combine_plain(Fx, inputs, coeffs, sub,
                                                  tables)), Fx.name

