"""Port vs reference for the kernels of the Ligero slice and its parameters:
K14's twin (the batched row encode) against the reference's _encode_rows
and its extended-domain blinding encode, K15's twin (the row inner
product) against _row_sum of F.mul and against lazy_linear_combination,
K13's twin (column placement) against place_columns, and LigeroIOPParams
field by field.  Inputs from seeded numpy generators; tolerance 0.

The reference's row encodes and row sums cost an XLA CPU compile each (2-6
s).  Tier 1 recomputes the reference for one case of each kind (``LIVE``)
and compares it with the port's element for element; it holds the port's
other outputs to the sha256 of the reference's outputs (``PINS``, as the
SNARK pins do).  The slow test recomputes every reference output, compares
it with the port's and checks the pin."""
import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

import libiop_tpu.algebra.fft as jax_fft
from libiop_tpu.algebra.domains import MultiplicativeCoset as JaxCoset
from libiop_tpu.algebra.generic import fft_any as jax_fft_any
from libiop_tpu.algebra.generic import ifft_any as jax_ifft_any
from libiop_tpu.algebra.generic import place_columns as jax_place_columns
from libiop_tpu.fields.prime import alt_bn128_fr as jax_alt_bn128_fr
from libiop_tpu.fields.prime import edwards_fr as jax_edwards_fr
from libiop_tpu.protocols import ligero as jlig
from libiop_tpu.protocols.common import \
    lazy_linear_combination as jax_lazy_linear_combination
from libiop_tpu_torch.algebra.domains import MultiplicativeCoset
from libiop_tpu_torch.algebra.generic import place_columns
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import limbs_from_numpy, limbs_to_numpy
from libiop_tpu_torch.kernels.row_dot import accumulator_cap, row_dot
from libiop_tpu_torch.kernels.rs_encode import rs_encode
from libiop_tpu_torch.protocols import ligero as tlig
from libiop_tpu_torch.protocols.common import lazy_linear_combination
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = {"edwards_Fr": (jax_edwards_fr, edwards_fr),
          "alt_bn128_Fr": (jax_alt_bn128_fr, alt_bn128_fr)}

#: (kind, field, size): "encode" |H| (3 rows into a coset of 4|H|),
#: "extended" |H| (3 rows of the extended domain 2|H| into a coset of
#: 4|H|, as the zk row blinding oracle), "row_sum" and
#: "linear_combination" R rows of 16
CASES = ([("encode", f, h) for f in sorted(FIELDS) for h in (8, 16)]
         + [("extended", f, 8) for f in sorted(FIELDS)]
         + [(kind, f, R) for kind in ("row_sum", "linear_combination")
            for f in sorted(FIELDS) for R in (1, 5, 65)])

#: sha256 of the reference's output (little-endian uint32 limbs) per case
PINS = {
    ("encode", "alt_bn128_Fr", 8):
        "7a0b367870151bf17a5c0fa767ffb63bc52aed374f9ca3f6897fe0b9a25fbc6e",
    ("encode", "alt_bn128_Fr", 16):
        "f581d33e42c23fddeaae81aeb84f72c12d5c6eca052c3816f7bff0d057bb4106",
    ("encode", "edwards_Fr", 8):
        "13e10e3eacdb36a92d342ab8af7ba185bbdb5b4f6f500aaa0041f5be1a87b75a",
    ("encode", "edwards_Fr", 16):
        "6e8a4c93ae179bc771b94ceb2f17ce5ee474cca616c4bcae91e8919dbf6f122c",
    ("extended", "alt_bn128_Fr", 8):
        "c9d3f98be0a202c2da77b82bdf090a75525c7c79154d9f5954293c701a1e5aa2",
    ("extended", "edwards_Fr", 8):
        "ba37b8014aee1b9167bf6f3d8b75f8c03293a31a205cec2e36671c96efda81f1",
    ("row_sum", "alt_bn128_Fr", 1):
        "a34398ab7c7adcae3044c52ea1f7344a5a3ad53acd5b14175ddcb8f71c878374",
    ("row_sum", "alt_bn128_Fr", 5):
        "9da13b227fa93f38a3c0e5a68b3af19c817841c3eccb44dec721cca3ee56f816",
    ("row_sum", "alt_bn128_Fr", 65):
        "f62b9809d79949c53390a1a4e7aebb01ba4e05671f8e3c7f86dd23a96ac50d5a",
    ("row_sum", "edwards_Fr", 1):
        "3598ea803e82b6735e7e743c2bf6e8c62854739c768aee8822efd3d5ddebafcd",
    ("row_sum", "edwards_Fr", 5):
        "7501c9410d265dad015c955089660b936f3018ac9b1dfe23ff7e861c5b1d15a6",
    ("row_sum", "edwards_Fr", 65):
        "40ce7c57ac13988c5db4329f16f950b28f3a19d23f2118fecaf113cdd896b3cf",
    ("linear_combination", "alt_bn128_Fr", 1):
        "7ec98c8aff19b74c46bb4ad01bd9004fa778bbb4a907c0cdeb810a7603c9154f",
    ("linear_combination", "alt_bn128_Fr", 5):
        "b05e6176d73ac3ee34799889bd7b07ac464a09c5916b5a9084aa9ca84e5023e9",
    ("linear_combination", "alt_bn128_Fr", 65):
        "ef102fdd4665b1b83a9f395e71904d0bc41959a09810c33a0f169b740bc82d05",
    ("linear_combination", "edwards_Fr", 1):
        "75d0062cd6255eab164463325ed297a65e2f341ecb5f53fafbba3f17fddf40c1",
    ("linear_combination", "edwards_Fr", 5):
        "7e7f8790d3b73f72a7cbeca75f882223b71dad76f5c653b60ffcec23c885fb00",
    ("linear_combination", "edwards_Fr", 65):
        "70ef1611689c0492754682d528c9f4d6af98834b04a8782fafb0d27812c73e22",
}


def _limbs(Ft, shape, seed):
    """Random field elements as the reference's (L, *shape) limb array."""
    n = int(np.prod(shape))
    return Ft.from_ints_np(np.array(Ft.random_ints(
        n, np.random.default_rng(seed)), dtype=object).reshape(shape))


def _inputs(case):
    """The case's limb arrays and, for a linear combination, its host-int
    coefficients."""
    kind, field, n = case
    Ft = FIELDS[field][1]()
    if kind == "encode":
        return (_limbs(Ft, (3, n), n),)
    if kind == "extended":
        return (_limbs(Ft, (3, 2 * n), 5),)
    if kind == "row_sum":
        return _limbs(Ft, (n, 16), n), _limbs(Ft, (n, 16), n + 100)
    return (_limbs(Ft, (n, 16), n + 7),
            Ft.random_ints(n, np.random.default_rng(n + 8)))


def _domains(case, F, coset):
    """(source subgroup, codeword coset of 4|H|): the source is H for an
    encode and the extended domain 2|H| for the blinding row."""
    dim = case[2].bit_length() - 1
    src_dim = dim + 1 if case[0] == "extended" else dim
    return coset(F, src_dim), coset(F, dim + 2, F.multiplicative_generator)


def _port_output(case) -> np.ndarray:
    kind, field, n = case
    Ft = FIELDS[field][1]()
    args = _inputs(case)
    if kind in ("encode", "extended"):
        src, dst = _domains(case, Ft, MultiplicativeCoset)
        out = rs_encode(Ft, limbs_from_numpy(args[0]), src, dst)
        if kind == "encode":  # the protocol's own call goes the same way
            assert (tlig._encode_rows(Ft, limbs_from_numpy(args[0]), src,
                                      dst) == out).all()
    elif kind == "row_sum":
        a, b = (limbs_from_numpy(x) for x in args)
        out = row_dot(Ft, a, b)
        assert (tlig._row_sum(Ft, a, b) == out).all()
    else:
        out = lazy_linear_combination(Ft, args[1], limbs_from_numpy(args[0]))
    return limbs_to_numpy(out)


def _reference_output(case) -> np.ndarray:
    kind, field, n = case
    Fj = FIELDS[field][0]()
    args = _inputs(case)
    if kind in ("encode", "extended"):
        src, dst = _domains(case, Fj, JaxCoset)
        x = jnp.asarray(args[0])
        out = (jlig._encode_rows(Fj, x, src, dst) if kind == "encode"
               else jax_fft_any(jax_ifft_any(x, src), dst))
    elif kind == "row_sum":
        out = jlig._row_sum(Fj, Fj.mul(jnp.asarray(args[0]),
                                       jnp.asarray(args[1])))
    else:
        rows = args[0]
        out = jax_lazy_linear_combination(
            Fj, args[1], [jnp.asarray(rows[:, i, :]) for i in range(n)])
    return np.asarray(out)


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, dtype="<u4").tobytes()
                          ).hexdigest()


#: the cases whose reference output tier 1 recomputes
LIVE = [("encode", "edwards_Fr", 8), ("extended", "edwards_Fr", 8),
        ("row_sum", "edwards_Fr", 5), ("linear_combination", "edwards_Fr", 5)]


def _reference(case) -> np.ndarray:
    saved = jax_fft._SCAN_THRESHOLD
    jax_fft._SCAN_THRESHOLD = 2  # the bit-identical scanned butterflies
    try:
        return _reference_output(case)
    finally:
        jax_fft._SCAN_THRESHOLD = saved


def _check_pins(kinds):
    """The LIVE cases of ``kinds`` against the recomputed reference, every
    case of ``kinds`` against its pin."""
    for case in CASES:
        if case[0] in kinds:
            got = _port_output(case)
            if case in LIVE:
                np.testing.assert_array_equal(got, _reference(case))
            assert _digest(got) == PINS[case], case


def test_rs_encode_matches_reference_pins():
    """K14's twin (and the protocol's _encode_rows) on 3 rows of |H| = 8
    and 16 into a coset of 4|H|, and on the zk row blinding oracle's
    encode from the extended domain 2|H| into the coset of 4|H| (|H| = 8),
    both fields."""
    _check_pins(("encode", "extended"))


def test_rs_encode_refuses_a_domain_without_the_source():
    Ft = edwards_fr()
    H = MultiplicativeCoset(Ft, 3)
    wrong = MultiplicativeCoset(Ft, 5, generator=pow(H.g, 3, Ft.p))
    with pytest.raises(ValueError):
        rs_encode(Ft, limbs_from_numpy(_limbs(Ft, (1, 8), 1)), H, wrong)


def test_row_dot_matches_reference_pins():
    """K15's twin against _row_sum of F.mul (a full b; the protocol's
    _row_sum too) and against lazy_linear_combination (one scalar a row),
    R = 1, 5, 65, both fields."""
    _check_pins(("row_sum", "linear_combination"))


@pytest.mark.slow
@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_reference_outputs_give_the_pins(case):
    """The reference's output, recomputed, equals the port's and hashes to
    its pin."""
    want = _reference(case)
    np.testing.assert_array_equal(_port_output(case), want)
    assert _digest(want) == PINS[case]


def test_row_dot_accumulator_caps():
    """The products one reduction takes: 4043 at edwards_Fr, five at
    alt_bn128_Fr (where the kernel folds every four rows)."""
    assert accumulator_cap(edwards_fr()) == 4043
    assert accumulator_cap(alt_bn128_fr()) == 5


def test_place_columns_matches_reference():
    """K13's twin (generic.place_columns) at unsorted positions, both
    fields."""
    for jf, tf in FIELDS.values():
        Fj, Ft = jf(), tf()
        rng = np.random.default_rng(3)
        positions = rng.permutation(40)[:23]          # unsorted, distinct
        values = _limbs(Ft, (2, 23), 4)
        want = jax_place_columns(jnp.asarray(values), positions, 40)
        got = place_columns(limbs_from_numpy(values), positions, 40)
        np.testing.assert_array_equal(limbs_to_numpy(got), np.asarray(want))


def _public(obj):
    return {k: v for k, v in vars(obj).items() if k != "F"
            and not hasattr(v, "__dict__")}


def test_ligero_iop_params_match_reference():
    """bench.py's configuration (security 128, RS extra 2, height/width
    0.1) at 2^16 and 2^20 constraints, zk and not, both fields: every
    parameter, the zk query-bound fixed point and any RS-extra bump
    included.  Host arithmetic only."""
    for jf, tf in FIELDS.values():
        Fj, Ft = jf(), tf()
        for log_n in (16, 20):
            for make_zk in (False, True):
                n = 1 << log_n
                args = (128, 2, 0.1, make_zk, n, n - 1)
                pj = jlig.LigeroIOPParams(Fj, *args)
                pt = tlig.LigeroIOPParams(Ft, *args)
                assert _public(pt) == _public(pj)
                assert dataclasses.asdict(pt.encoded_params) == \
                    dataclasses.asdict(pj.encoded_params)
                assert vars(pt.direct_ldt_params) == \
                    vars(pj.direct_ldt_params)
                assert _public(pt.ldt_reducer_params) == \
                    _public(pj.ldt_reducer_params)


# -- K24: the LDT reducer's combination ---------------------------------------
#: n = 262 inputs (Ligero's largest), every seventh of submaximal degree
#: (Delta 1 to 5), over a domain of 16 elements
LDT_N, LDT_DIM, LDT_MAX_DEGREE = 262, 4, 12


def _ldt_case(name):
    """Both packages' fields and domains, the input degrees, the random
    coefficients and the input codewords (numpy, the reference's layout)."""
    if name == "gf64":
        from libiop_tpu.algebra.subspace import AffineSubspace as JaxSubspace
        from libiop_tpu.fields.binary import gf64 as jax_gf64
        from libiop_tpu_torch.algebra.subspace import AffineSubspace
        from libiop_tpu_torch.fields.binary import gf64
        Fj, Ft = jax_gf64(), gf64()
        Lj = JaxSubspace(Fj, LDT_DIM, shift=1 << 40)
        Lt = AffineSubspace(Ft, LDT_DIM, 1 << 40)
    else:
        Fj, Ft = (m() for m in FIELDS[name])
        Lj = JaxCoset(Fj, LDT_DIM, shift=Ft.multiplicative_generator)
        Lt = MultiplicativeCoset(Ft, LDT_DIM, Ft.multiplicative_generator)
    degrees = [LDT_MAX_DEGREE - (1 + k % 5) if k % 7 == 3 else LDT_MAX_DEGREE
               for k in range(LDT_N)]
    rng = np.random.default_rng(262)
    coeffs = Ft.random_ints(2 * LDT_N, rng)
    evals = Fj.from_ints_np(Ft.random_ints(LDT_N * Lt.order, rng),
                            (LDT_N, Lt.order))
    return Fj, Ft, Lj, Lt, degrees, coeffs, evals


#: sha256 of the reference's CombinedLDTOracle.evaluated_contents
#: (little-endian uint32 limbs or words) per field; the slow test
#: recomputes them
LDT_PINS = {
    "edwards_Fr":
        "8a510177959e878958ced969a17fc0637433767614a16a2e2fdee43b0f03a5b0",
    "alt_bn128_Fr":
        "346258ff4a848340061f52fbe17348c8615eceb651d0456335f3ebfda2e1b03b",
    "gf64":
        "7a7fe120183d0825b2c1c2c2b83f597f10f8d42dee52780f41ab5eba1cfca76c",
}


def _ldt_reference(name) -> np.ndarray:
    from libiop_tpu.protocols.ldt_reducer import \
        CombinedLDTOracle as JaxCombined
    Fj, _, Lj, _, degrees, coeffs, evals = _ldt_case(name)
    jo = JaxCombined(Fj, Lj, degrees)
    jo.set_coefficients(coeffs)
    return np.asarray(jo.evaluated_contents(
        [jnp.asarray(evals[:, k]) for k in range(LDT_N)]), dtype=np.uint32)


def _ldt_port(name) -> np.ndarray:
    """K24's twin, reached through the port's CombinedLDTOracle, each input
    a strided view of one (L, n, N) array as on Ligero."""
    from libiop_tpu_torch.protocols.ldt_reducer import CombinedLDTOracle
    _, Ft, _, Lt, degrees, coeffs, evals = _ldt_case(name)
    to = CombinedLDTOracle(Ft, Lt, degrees)
    to.set_coefficients(coeffs)
    assert len(to.submaximal) == 37
    stacked = limbs_from_numpy(evals)
    return limbs_to_numpy(to.evaluated_contents(
        [stacked[:, k] for k in range(LDT_N)]))


@pytest.mark.parametrize("name", sorted(LDT_PINS))
def test_ldt_combine_matches_reference_pins(name):
    """K24's twin against the reference's evaluated_contents (its pin)."""
    assert _digest(_ldt_port(name)) == LDT_PINS[name]


def test_ldt_combine_matches_reference_live():
    np.testing.assert_array_equal(_ldt_port("edwards_Fr"),
                                  _ldt_reference("edwards_Fr"))


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(LDT_PINS))
def test_ldt_reference_outputs_give_the_pins(name):
    want = _ldt_reference(name)
    np.testing.assert_array_equal(_ldt_port(name), want)
    assert _digest(want) == LDT_PINS[name]
