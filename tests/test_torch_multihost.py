"""The port's multi-process path ("fake cluster"): two processes joined by
torch.distributed with the gloo backend on the CPU, the counterpart of
tests/test_multihost.py.

Each worker joins the process group through a file:// rendezvous, builds
the global codeword mesh (one shard a process), assembles a sharded
codeword from its local chunk, gathers host bytes, runs a cross-process
ShardedNTT against the local transform, and proves the Aurora configuration
of tests/test_multihost.py:70-127 under the global mesh; the workers' proof
digests must agree (``assert_same_on_all_processes``).  The same proof
unsharded and under an 8-shard in-process mesh must have the same bytes,
and all three the sha256 of the reference's single-process proof
(``AURORA_PIN``, taken from a JAX process of its own; the slow test
recomputes it the same way).  Every child is killed when the test's
timeout expires."""
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

from libiop_tpu_torch.algebra import fft as fftmod
from libiop_tpu_torch.bcs.common import BCSTranscript
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.parallel import multihost
from libiop_tpu_torch.parallel.mesh import (codeword_sharding_context,
                                            make_codeword_mesh)
from libiop_tpu_torch.relations.examples import generate_r1cs_example
from libiop_tpu_torch.snark.aurora import (AuroraSnarkParams,
                                           aurora_snark_prover,
                                           aurora_snark_verifier)
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180

#: sha256 of the reference's single-process proof of the configuration
#: below (libiop_tpu.snark.aurora, its own process)
AURORA_PIN = \
    "d4fb856ed6a69cbc93df148c0ca31bafcb1dd81dbc83a3ac349e44b4bacde77e"


def _aurora_config(F):
    n = 256
    cs, primary, aux = generate_r1cs_example(F, n, 3, n - 1,
                                             np.random.default_rng(99))
    return cs, primary, aux


def _aurora_params():
    return AuroraSnarkParams(
        security_parameter=32, RS_extra_dimensions=2,
        fri_localization_parameter=2, pow_bits=2, override_fri_queries=4,
        override_fri_interactive_repetitions=1, override_ldt_instances=1)


_WORKER = r"""
import hashlib, sys
from datetime import timedelta
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import numpy as np
import torch
torch.set_num_threads(1)
from libiop_tpu_torch.algebra.domains import MultiplicativeCoset
from libiop_tpu_torch.algebra.fft import SHARD_ROUTES, fft
from libiop_tpu_torch.fields.prime import edwards_fr
from libiop_tpu_torch.parallel import multihost
from libiop_tpu_torch.parallel.mesh import codeword_sharding_context
from libiop_tpu_torch.parallel.shard_ntt import ShardedNTT
from libiop_tpu_torch.snark.aurora import aurora_snark_prover
from test_torch_multihost import _aurora_config, _aurora_params

rank, world, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
multihost.initialize("file://" + rdv, world, rank, backend="gloo",
                     device="cpu", timeout=timedelta(seconds=60))
assert multihost.process_count() == world
F = edwards_fr()
mesh = multihost.make_global_codeword_mesh()
assert mesh.size == world and mesh.local_shards()[0][0] == rank

# a sharded codeword from this process's chunk of a deterministic vector
n_global = 64
per = n_global // world
vals = [(i * 7 + 3) % F.p for i in range(n_global)]
g = multihost.host_local_to_global(
    mesh, F.from_ints(vals[rank * per:(rank + 1) * per], "cpu"))
assert g.shape[-1] == n_global
sq = multihost.host_local_to_global(mesh, F.mul(g.local, g.local))
back = multihost.global_to_host_local(mesh, sq)
expect = [pow(v, 2, F.p) for v in vals]
assert list(F.to_ints(torch.from_numpy(back))) == \
    expect[rank * per:(rank + 1) * per], "sharded square mismatch"
assert list(F.to_ints(sq.full())) == expect, "all-gather mismatch"

# host bytes: every process ends with the identical full list
blocks = [bytes([rank]) + i.to_bytes(2, "little") for i in range(3 + rank)]
full = multihost.allgather_host_bytes(blocks)
assert len(full) == sum(3 + r for r in range(world))
assert full[0][:1] == b"\x00" and full[3][:1] == b"\x01"
multihost.assert_same_on_all_processes(
    hashlib.blake2b(b"".join(full), digest_size=16).digest())

# a cross-process four-step NTT against the local transform
dom = MultiplicativeCoset(F, 8, 19)
coeffs = F.from_ints(F.random_ints(200, np.random.default_rng(5)), "cpu")
assert torch.equal(ShardedNTT(dom, mesh)(coeffs), fft(coeffs, dom))
print("CLUSTER_OK", rank, flush=True)

cs, primary, aux = _aurora_config(F)
with codeword_sharding_context(mesh):
    blob = aurora_snark_prover(cs, primary, aux, _aurora_params(),
                               device="cpu").serialize()
digest = hashlib.sha256(blob).digest()
multihost.assert_same_on_all_processes(digest)
print("WORKER_OK", rank, digest.hex(), SHARD_ROUTES["four_step"], flush=True)
multihost.shutdown()
"""


def run_processes(cmds, timeout=TIMEOUT_S):
    """Run the commands concurrently; kill every one of them when any has
    not ended within ``timeout`` seconds.  Returns their stdouts."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The two workers' outputs, one line list a rank."""
    tmp = tmp_path_factory.mktemp("cluster")
    script = tmp / "worker.py"
    script.write_text(_WORKER.format(repo=REPO,
                                     tests=os.path.join(REPO, "tests")))
    rdv = str(tmp / "rendezvous")
    outs = run_processes([[sys.executable, str(script), str(r), "2", rdv]
                          for r in range(2)])
    return [o.splitlines() for o in outs]


def _line(lines, tag):
    return next(ln.split() for ln in lines if ln.startswith(tag))


def test_two_process_fake_cluster(cluster):
    for rank, lines in enumerate(cluster):
        assert _line(lines, "CLUSTER_OK")[1] == str(rank)


def test_two_process_aurora_prover(cluster):
    """The sharded prover across two processes: the same bytes on both
    ranks (checked in the workers), the reference's, and the four-step
    route taken."""
    for rank, lines in enumerate(cluster):
        _, r, digest, four_step = _line(lines, "WORKER_OK")
        assert r == str(rank) and int(four_step) > 0
        assert digest == AURORA_PIN


@pytest.mark.parametrize("sharded", [False, True])
def test_in_process_aurora_prover(sharded):
    """Unsharded, and under an 8-shard in-process mesh on the CPU: the
    reference's bytes; the unsharded proof verifies."""
    F = edwards_fr()
    cs, primary, aux = _aurora_config(F)
    params = _aurora_params()
    for k in fftmod.SHARD_ROUTES:
        fftmod.SHARD_ROUTES[k] = 0
    if sharded:
        with codeword_sharding_context(make_codeword_mesh(
                devices=["cpu"] * 8)):
            blob = aurora_snark_prover(cs, primary, aux, params,
                                       device="cpu").serialize()
        assert fftmod.SHARD_ROUTES["four_step"] > 0
    else:
        blob = aurora_snark_prover(cs, primary, aux, params,
                                   device="cpu").serialize()
        assert fftmod.SHARD_ROUTES == {"four_step": 0, "local": 0}
        assert aurora_snark_verifier(cs, primary,
                                     BCSTranscript.deserialize(blob), params,
                                     device="cpu")
    assert hashlib.sha256(blob).hexdigest() == AURORA_PIN


def test_single_process_helpers():
    """Outside a process group the gathers are the identity."""
    assert multihost.process_count() == 1
    assert multihost.allgather_host_bytes([b"a", b"bc"]) == [b"a", b"bc"]
    multihost.assert_same_on_all_processes(b"\x00" * 32)
    with pytest.raises(RuntimeError):
        multihost.make_global_codeword_mesh()


_JAX_REFERENCE = r"""
import hashlib, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import conftest  # the CPU platform and the scan-mode products
import numpy as np
from libiop_tpu.fields.prime import edwards_fr
from libiop_tpu.relations.examples import generate_r1cs_example
from libiop_tpu.snark.aurora import AuroraSnarkParams, aurora_snark_prover
F = edwards_fr()
n = 256
cs, primary, aux = generate_r1cs_example(F, n, 3, n - 1,
                                         np.random.default_rng(99))
params = AuroraSnarkParams(
    security_parameter=32, RS_extra_dimensions=2,
    fri_localization_parameter=2, pow_bits=2, override_fri_queries=4,
    override_fri_interactive_repetitions=1, override_ldt_instances=1)
blob = aurora_snark_prover(cs, primary, aux, params).serialize()
print("JAX_OK", hashlib.sha256(blob).hexdigest(), flush=True)
"""


@pytest.mark.slow
def test_reference_proof_behind_the_pin(tmp_path):
    script = tmp_path / "reference.py"
    script.write_text(_JAX_REFERENCE.format(
        repo=REPO, tests=os.path.join(REPO, "tests")))
    out, = run_processes([[sys.executable, str(script)]], timeout=1800)
    assert _line(out.splitlines(), "JAX_OK")[1] == AURORA_PIN
