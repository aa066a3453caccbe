"""Port vs reference for column placement (kernel K13's route,
``generic.place_columns``) and the host side of that route: the inverse map
is built once per positions' contents, and a read-only positions array (as
the IOP objects hold theirs) is keyed by identity after its first call, so a
later call neither copies nor digests it.  Inputs from seeded numpy
generators; tolerance 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libiop_tpu.algebra.generic import place_columns as jax_place_columns
from libiop_tpu_torch.algebra import generic
from libiop_tpu_torch.fields.prime import alt_bn128_fr, edwards_fr
from libiop_tpu_torch.interop import limbs_from_numpy, limbs_to_numpy
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = {"edwards_Fr": edwards_fr, "alt_bn128_Fr": alt_bn128_fr}


def _values(F, nv, seed):
    rng = np.random.default_rng(seed)
    return F.from_ints_np(F.random_ints(nv, rng))


def _positions(kind, seed):
    """(positions, out_size): 1,000 distinct unsorted columns of 1,024 (24
    sentinel columns), or a permutation of 1,024."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(1024)
    return (perm[:1000] if kind == "sentinels" else perm), 1024


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("kind", ["sentinels", "permutation"])
def test_place_columns_matches_reference(field, kind):
    """(L, 1,000) into 1,024 columns with sentinels, and (L, 1,024) through
    a permutation of 1,024, against the JAX package's place_columns."""
    F = FIELDS[field]()
    positions, out_size = _positions(kind, 11)
    values = _values(F, len(positions), 12)
    want = jax_place_columns(jnp.asarray(values), positions, out_size)
    got = generic.place_columns(limbs_from_numpy(values), positions,
                                out_size)
    np.testing.assert_array_equal(limbs_to_numpy(got), np.asarray(want))


def test_place_columns_keys_a_frozen_array_once():
    """A second call with the same read-only positions array keys nothing
    and builds no map; an equal-valued distinct array is keyed once and
    finds the same map (and gives the same output); a writeable array is
    keyed at every call.  The maps are int32, as the reference's."""
    F = edwards_fr()
    positions, out_size = _positions("sentinels", 13)
    positions.setflags(write=False)
    values = limbs_from_numpy(_values(F, len(positions), 14))
    stats = generic.PLACEMENT_STATS
    keys, maps = stats["keys"], stats["maps"]
    first = generic.place_columns(values, positions, out_size)
    assert (stats["keys"], stats["maps"]) == (keys + 1, maps + 1)
    again = generic.place_columns(values, positions, out_size)
    assert (stats["keys"], stats["maps"]) == (keys + 1, maps + 1)
    assert (again == first).all()

    twin = positions.copy()
    twin.setflags(write=False)
    other = generic.place_columns(values, twin, out_size)
    generic.place_columns(values, twin, out_size)
    assert (stats["keys"], stats["maps"]) == (keys + 2, maps + 1)
    assert (other == first).all()

    writeable = positions.copy()
    for _ in range(2):
        assert (generic.place_columns(values, writeable, out_size)
                == first).all()
    assert (stats["keys"], stats["maps"]) == (keys + 4, maps + 1)
    inv = generic.device_table(
        ("place", out_size, len(positions), generic._positions_key(twin)),
        values.device, lambda: None)
    assert inv.dtype == torch.int32
