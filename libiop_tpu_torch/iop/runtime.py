"""The IOP runtime: registration/execution engine for Interactive Oracle Proofs.

Port of libiop_tpu/iop/runtime.py.  Protocol objects drive this engine; the
base class is an interactive simulator (fresh randomness) and the BCS
prover/verifier subclass it to supply Fiat-Shamir randomness.  Oracle
contents are (L, N) Montgomery limb tensors on the engine's device (prover
side); pointwise query evaluation uses host ints mod p (verifier side), so
virtual oracles implement both a vectorized definition (``traced_aux`` and
``traced_contents``) and ``evaluation_at_point``.  The prover evaluates the
DAGs of virtual oracles with kernel K8 (kernels/fused_dag.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..algebra.domains import MultiplicativeCoset
from ..algebra.fft import SHARD_ROUTES  # noqa: F401 (beside DAG_ROUTES)
from ..kernels.fused_dag import DagLimitError, Tape, TapeRecorder, fused_dag
from ..utils.profiling import PROFILER


@dataclasses.dataclass(frozen=True)
class DomainHandle:
    id: int


@dataclasses.dataclass(frozen=True)
class OracleHandle:
    id: int
    virtual: bool = False


@dataclasses.dataclass(frozen=True)
class ProverMessageHandle:
    id: int


@dataclasses.dataclass(frozen=True)
class VerifierMessageHandle:
    id: int


@dataclasses.dataclass(frozen=True)
class QueryPositionHandle:
    id: int


@dataclasses.dataclass(frozen=True)
class QueryHandle:
    id: int


@dataclasses.dataclass
class OracleRegistration:
    domain: DomainHandle
    degree_bound: int
    round: int
    make_zk: bool = False
    #: a holographic index oracle (round 0, committed once by the indexer)
    is_index: bool = False


@dataclasses.dataclass
class VirtualOracleRegistration:
    domain: DomainHandle
    degree_bound: int
    constituents: List[OracleHandle]
    oracle: "VirtualOracle"


@dataclasses.dataclass
class ProverMessageRegistration:
    size: int
    round: int


@dataclasses.dataclass
class VerifierMessageRegistration:
    size: int
    round: int


@dataclasses.dataclass
class RoundParameters:
    """BCS leaf-serialization hint: leaves of this round's Merkle trees pack
    whole cosets of this size."""
    quotient_map_size: int = 1


class VirtualOracle:
    """A polynomial defined from constituent oracles, with a vectorized
    prover interface and a pointwise verifier interface that agree.

    The vectorized definition is ``traced_contents(F, aux, evals)``: field
    ops (``F.add``, ``F.sub``, ``F.mul``) over the constituents' codewords
    and the oracle's ``traced_aux(device)`` values, each either an (L, N)
    codeword or a Python int (a canonical scalar).  ``F`` is the field
    itself (eager evaluation) or a ``TapeRecorder`` (the fused K8 path)."""

    def traced_aux(self, device) -> Optional[List]:
        """Codewords and scalars the definition needs, or None while its
        challenge is not set."""
        raise NotImplementedError

    def traced_contents(self, F, aux: List, evals: List):
        raise NotImplementedError

    def traced_sig(self) -> tuple:
        """What, besides the oracle's type, its constituents and its aux
        kinds, shapes the traced expression."""
        return ()

    def evaluated_contents(self, constituent_evals: List[torch.Tensor]
                           ) -> torch.Tensor:
        like = constituent_evals[0]
        aux = self.traced_aux(like.device)
        assert aux is not None, f"{type(self).__name__}: challenge not set"
        aux = [self.F.scalar(a, like) if isinstance(a, int) else a
               for a in aux]
        return self.traced_contents(self.F, aux, constituent_evals)

    def evaluation_at_point(self, position: int, point_int: int,
                            constituent_values: List[int]) -> int:
        raise NotImplementedError

    def prefetch_points(self, positions: List[int], points: List[int]):
        """Optional batch hook, called once with every position this oracle
        will be point-queried at before any ``evaluation_at_point``."""


#: compiled tapes of fused DAGs, per DAG signature
_TAPES: Dict[tuple, Tape] = {}
#: how the runtime evaluated virtual-oracle DAGs: whole ("fused"), or
#: split into its roots' constituents first ("split"), counted per call
DAG_ROUTES = {"fused": 0, "split": 0}
#: SHARD_ROUTES (algebra/fft.py): how the transforms run under an active
#: codeword mesh went, "four_step" (ShardedNTT) or "local", counted per call


class IOPProtocol:
    """Base engine = interactive simulation with fresh randomness."""

    def __init__(self, field, device, seed: int = 0):
        self.F = field
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed ^ 0x5DEECE66D)
        self.domains: List[MultiplicativeCoset] = []
        self.oracle_regs: List[OracleRegistration] = []
        self.virtual_regs: List[VirtualOracleRegistration] = []
        self.prover_msg_regs: List[ProverMessageRegistration] = []
        self.verifier_msg_regs: List[VerifierMessageRegistration] = []
        self.round_params: Dict[int, RoundParameters] = {}
        self._current_round = 0
        self._last_was_verifier = False
        self._has_index_round = False
        self._interactions_sealed = False
        self.qpos_regs: List[Tuple[str, object]] = []
        self.query_regs: List[Tuple[OracleHandle, QueryPositionHandle]] = []
        self._queries_sealed = False
        self.oracle_evals: Dict[int, Optional[torch.Tensor]] = {}
        self.prover_messages: Dict[int, List[int]] = {}
        self.verifier_messages: Dict[int, List[int]] = {}
        self._virtual_evals_cache: Dict[int, torch.Tensor] = {}
        self._pointwise_cache: Dict[Tuple[int, bool, int], int] = {}
        self._qpos_values: Dict[int, int] = {}
        self._rounds_done = 0
        self._prefetched_points = False

    # -- registration phase ------------------------------------------------
    def register_domain(self, domain: MultiplicativeCoset) -> DomainHandle:
        for i, d in enumerate(self.domains):
            if d == domain:
                return DomainHandle(i)
        self.domains.append(domain)
        return DomainHandle(len(self.domains) - 1)

    def get_domain(self, h: DomainHandle) -> MultiplicativeCoset:
        return self.domains[h.id]

    def _flip_to_prover(self):
        assert not self._interactions_sealed
        if self._last_was_verifier:
            self._current_round += 1
            self._last_was_verifier = False

    def _leave_index_round(self):
        """Round 0 holds only the index: once it exists, the first prover
        registration opens round 1."""
        if self._has_index_round and self._current_round == 0:
            self._current_round = 1

    def register_index_oracle(self, domain_h: DomainHandle,
                              degree_bound: int) -> OracleHandle:
        """A holographic round-0 oracle; index oracles precede every other
        registration."""
        assert self._current_round == 0 and not self._last_was_verifier
        assert all(r.is_index for r in self.oracle_regs)
        self._has_index_round = True
        self.oracle_regs.append(OracleRegistration(
            domain_h, degree_bound, round=0, is_index=True))
        return OracleHandle(len(self.oracle_regs) - 1)

    def register_oracle(self, domain_h: DomainHandle, degree_bound: int,
                        make_zk: bool = False) -> OracleHandle:
        """``make_zk`` oracles are committed in salted Merkle trees."""
        self._flip_to_prover()
        self._leave_index_round()
        self.oracle_regs.append(OracleRegistration(
            domain_h, degree_bound, round=self._current_round,
            make_zk=make_zk))
        return OracleHandle(len(self.oracle_regs) - 1)

    def register_virtual_oracle(self, domain_h: DomainHandle, degree_bound: int,
                                constituents: Sequence[OracleHandle],
                                oracle: VirtualOracle) -> OracleHandle:
        self.virtual_regs.append(VirtualOracleRegistration(
            domain_h, degree_bound, list(constituents), oracle))
        return OracleHandle(len(self.virtual_regs) - 1, virtual=True)

    def register_prover_message(self, size: int) -> ProverMessageHandle:
        self._flip_to_prover()
        self._leave_index_round()
        self.prover_msg_regs.append(
            ProverMessageRegistration(size, self._current_round))
        return ProverMessageHandle(len(self.prover_msg_regs) - 1)

    def register_verifier_random_message(self, size: int) -> VerifierMessageHandle:
        assert not self._interactions_sealed
        self._last_was_verifier = True
        self.verifier_msg_regs.append(
            VerifierMessageRegistration(size, self._current_round))
        return VerifierMessageHandle(len(self.verifier_msg_regs) - 1)

    def set_round_parameters(self, params: RoundParameters,
                             round: Optional[int] = None):
        rnd = self._current_round if round is None else round
        self.round_params[rnd] = params

    def get_round_parameters(self, round: int) -> RoundParameters:
        return self.round_params.get(round, RoundParameters())

    def seal_interaction_registrations(self):
        assert not self._interactions_sealed
        self._interactions_sealed = True
        self.num_interaction_rounds = self._current_round + 1

    # -- query registration phase -----------------------------------------
    def register_random_query_position(self, domain_h: DomainHandle
                                       ) -> QueryPositionHandle:
        assert self._interactions_sealed and not self._queries_sealed
        self.qpos_regs.append(("random", domain_h))
        return QueryPositionHandle(len(self.qpos_regs) - 1)

    def register_deterministic_query_position(
            self, deps: Sequence[QueryPositionHandle],
            fn: Callable[..., int]) -> QueryPositionHandle:
        assert self._interactions_sealed and not self._queries_sealed
        self.qpos_regs.append(("det", (list(deps), fn)))
        return QueryPositionHandle(len(self.qpos_regs) - 1)

    def register_query(self, oracle_h: OracleHandle,
                       pos_h: QueryPositionHandle) -> QueryHandle:
        assert self._interactions_sealed and not self._queries_sealed
        self.query_regs.append((oracle_h, pos_h))
        return QueryHandle(len(self.query_regs) - 1)

    def seal_query_registrations(self):
        self._queries_sealed = True

    # -- execution: prover side -------------------------------------------
    def submit_oracle(self, handle: OracleHandle, evals: torch.Tensor):
        assert not handle.virtual
        reg = self.oracle_regs[handle.id]
        dom = self.get_domain(reg.domain)
        assert tuple(evals.shape) == (self.F.L, dom.num_elements()), (
            tuple(evals.shape), dom.num_elements())
        assert reg.round == self._rounds_done, (
            f"oracle for round {reg.round} submitted during round "
            f"{self._rounds_done}")
        self.oracle_evals[handle.id] = evals

    def submit_prover_message(self, handle: ProverMessageHandle,
                              values: List[int]):
        reg = self.prover_msg_regs[handle.id]
        assert len(values) == reg.size
        assert reg.round == self._rounds_done
        self.prover_messages[handle.id] = [self.F.sample_int(int(v))
                                           for v in values]

    def signal_prover_round_done(self):
        """Validate completeness of the round; subclasses add MT+hashchain."""
        rnd = self._rounds_done
        for i, reg in enumerate(self.oracle_regs):
            if reg.round == rnd and i not in self.oracle_evals:
                raise RuntimeError(f"oracle {i} of round {rnd} not submitted")
        for i, reg in enumerate(self.prover_msg_regs):
            if reg.round == rnd and i not in self.prover_messages:
                raise RuntimeError(
                    f"prover message {i} of round {rnd} not submitted")
        self._rounds_done += 1

    # -- verifier randomness ----------------------------------------------
    def _fresh_verifier_randomness(self, size: int, index: int) -> List[int]:
        return self.F.random_ints(size, self._rng)

    def obtain_verifier_random_message(self, handle: VerifierMessageHandle
                                       ) -> List[int]:
        if handle.id in self.verifier_messages:
            return self.verifier_messages[handle.id]
        reg = self.verifier_msg_regs[handle.id]
        assert reg.round < self._rounds_done, (
            "verifier randomness requested before its round was completed")
        vals = self._fresh_verifier_randomness(reg.size, handle.id)
        self.verifier_messages[handle.id] = vals
        return vals

    def receive_prover_message(self, handle: ProverMessageHandle) -> List[int]:
        return self.prover_messages[handle.id]

    # -- oracle access: vectorized ----------------------------------------
    def get_oracle_domain(self, handle: OracleHandle):
        reg = (self.virtual_regs[handle.id] if handle.virtual
               else self.oracle_regs[handle.id])
        return self.get_domain(reg.domain)

    def get_oracle_degree_bound(self, handle: OracleHandle) -> int:
        reg = (self.virtual_regs[handle.id] if handle.virtual
               else self.oracle_regs[handle.id])
        return reg.degree_bound

    def get_oracle_evaluations(self, handle: OracleHandle) -> torch.Tensor:
        if not handle.virtual:
            ev = self.oracle_evals.get(handle.id)
            if ev is None:
                raise RuntimeError(f"oracle {handle.id} has no submitted contents")
            return ev
        if handle.id in self._virtual_evals_cache:
            return self._virtual_evals_cache[handle.id]
        reg = self.virtual_regs[handle.id]
        constituent_evals = [self.get_oracle_evaluations(c)
                             for c in reg.constituents]
        ev = reg.oracle.evaluated_contents(constituent_evals)
        self._virtual_evals_cache[handle.id] = ev
        return ev

    def get_fused_oracle_evaluations(self, handles: Sequence[OracleHandle]
                                     ) -> List[torch.Tensor]:
        """Evaluate the virtual-oracle DAGs under several roots in one launch
        of kernel K8.  A postorder walk (the reference's, runtime.py:379-441)
        collects the uncached virtual nodes; real oracles and cached virtual
        ones are the tape's leaf inputs.  Their ``traced_contents`` compile
        into a tape, cached per DAG signature; challenges and tables enter
        through ``traced_aux``.  The roots' results are cached.  A DAG that
        exceeds K8's launch limits is split: its roots' virtual
        constituents are evaluated first (each a DAG of its own, split in
        turn), then the roots over them, or the roots one at a time.  A
        single oracle over the limits with its constituents cached raises
        DagLimitError."""
        roots = list(handles)
        try:
            return self._fused_evaluations(roots)
        except DagLimitError as e:
            limit = e
        cache = self._virtual_evals_cache
        pending = [h for h in roots if h.virtual and h.id not in cache]
        children = list(dict.fromkeys(
            c for h in pending for c in self.virtual_regs[h.id].constituents
            if c.virtual and c.id not in cache))
        parts = children or (pending if len(pending) > 1 else [])
        if not parts:
            oracle = self.virtual_regs[pending[0].id].oracle if pending \
                else None
            raise DagLimitError(f"virtual oracle {type(oracle).__name__} "
                                f"alone exceeds K8's limits: {limit}")
        DAG_ROUTES["split"] += 1
        for h in parts:
            self.get_fused_oracle_evaluations([h])
        return self.get_fused_oracle_evaluations(roots)

    def _fused_evaluations(self, roots: List[OracleHandle]
                           ) -> List[torch.Tensor]:
        order: List[int] = []
        node_cons: List[List[tuple]] = []
        leaf_keys: List[tuple] = []
        leaf_index: Dict[tuple, int] = {}
        vindex: Dict[int, int] = {}

        def leaf(key) -> tuple:
            if key not in leaf_index:
                leaf_index[key] = len(leaf_keys)
                leaf_keys.append(key)
            return ("leaf", leaf_index[key])

        def walk(h: OracleHandle) -> tuple:
            if not h.virtual:
                return leaf(("r", h.id))
            if h.id in self._virtual_evals_cache:
                return leaf(("vc", h.id))
            if h.id not in vindex:
                cons = [walk(c) for c in self.virtual_regs[h.id].constituents]
                vindex[h.id] = len(order)
                order.append(h.id)
                node_cons.append(cons)
            return ("v", vindex[h.id])

        root_keys = [walk(h) for h in roots]
        leaves = [self.get_oracle_evaluations(OracleHandle(i, kind == "vc"))
                  .contiguous() for kind, i in leaf_keys]
        if not order:
            return [leaves[j] for _, j in root_keys]
        oracles = [self.virtual_regs[vid].oracle for vid in order]
        auxes = []
        for vid, oracle in zip(order, oracles):
            aux = oracle.traced_aux(self.device)
            if aux is None:
                raise RuntimeError(f"virtual oracle {vid} "
                                   f"({type(oracle).__name__}) has no tape: "
                                   "its challenge is not set")
            auxes.append(aux)
        kinds = tuple(tuple(isinstance(a, int) for a in aux) for aux in auxes)
        sig = (self.F.name, len(leaf_keys), tuple(root_keys), kinds,
               tuple((type(o).__qualname__, o.traced_sig(), tuple(cons))
                     for o, cons in zip(oracles, node_cons)))
        tape = _TAPES.get(sig)
        if tape is None:
            b = TapeRecorder()
            leaf_vals = [b.input() for _ in leaf_keys]
            aux_vals = [[b.scalar() if is_int else b.input()
                         for is_int in ks] for ks in kinds]
            vals = []
            for k, oracle in enumerate(oracles):
                cv = [leaf_vals[j] if kind == "leaf" else vals[j]
                      for kind, j in node_cons[k]]
                vals.append(oracle.traced_contents(b, aux_vals[k], cv))
            tape = _TAPES[sig] = b.finish(
                [vals[j] for kind, j in root_keys if kind == "v"])
        DAG_ROUTES["fused"] += 1
        inputs = leaves + [a.contiguous() for aux in auxes for a in aux
                           if not isinstance(a, int)]
        scalars = [a for aux in auxes for a in aux if isinstance(a, int)]
        outs = iter(fused_dag(self.F, tape, inputs, scalars))
        results = []
        for h, (kind, j) in zip(roots, root_keys):
            if kind == "v":
                self._virtual_evals_cache[h.id] = next(outs)
                results.append(self._virtual_evals_cache[h.id])
            else:
                results.append(leaves[j])
        return results

    # -- oracle access: pointwise (host ints) ------------------------------
    def prefetch_query_point_evals(self):
        """Resolve every registered query's position, propagate positions
        down each virtual oracle's DAG and hand each virtual oracle its full
        position set via ``prefetch_points`` in one batch."""
        self._prefetched_points = True
        with PROFILER.block("prefetch_point_evals"):
            pos_by_vid: Dict[int, set] = {}

            def collect(h: OracleHandle, pos: int):
                if not h.virtual:
                    return
                pos_by_vid.setdefault(h.id, set()).add(pos)
                for c in self.virtual_regs[h.id].constituents:
                    collect(c, pos)

            for oracle_h, pos_h in self.query_regs:
                collect(oracle_h, self.obtain_query_position(pos_h))
            for vid, poss in pos_by_vid.items():
                reg = self.virtual_regs[vid]
                dom = self.get_domain(reg.domain)
                ordered = sorted(poss)
                reg.oracle.prefetch_points(
                    ordered, [dom.element_by_index_int(p) for p in ordered])

    def get_oracle_evaluation_at_position(self, handle: OracleHandle,
                                          position: int) -> int:
        if handle.virtual and not self._prefetched_points:
            self.prefetch_query_point_evals()
        key = (handle.id, handle.virtual, position)
        if key in self._pointwise_cache:
            return self._pointwise_cache[key]
        if not handle.virtual:
            ev = self.oracle_evals.get(handle.id)
            if ev is None:
                raise RuntimeError(f"oracle {handle.id} has no contents")
            val = int(self.F.to_ints(ev[:, position:position + 1])[0])
        else:
            reg = self.virtual_regs[handle.id]
            dom = self.get_domain(reg.domain)
            cvals = [self.get_oracle_evaluation_at_position(c, position)
                     for c in reg.constituents]
            val = self.F.sample_int(reg.oracle.evaluation_at_point(
                position, dom.element_by_index_int(position), cvals))
        self._pointwise_cache[key] = val
        return val

    # -- query execution ---------------------------------------------------
    def _fresh_query_position(self, domain_size: int, index: int) -> int:
        return int(self._rng.integers(0, domain_size))

    def obtain_query_position(self, handle: QueryPositionHandle) -> int:
        if handle.id in self._qpos_values:
            return self._qpos_values[handle.id]
        kind, payload = self.qpos_regs[handle.id]
        if kind == "random":
            dom = self.get_domain(payload)
            pos = self._fresh_query_position(dom.num_elements(), handle.id)
        else:
            deps, fn = payload
            pos = int(fn(*[self.obtain_query_position(d) for d in deps]))
        self._qpos_values[handle.id] = pos
        return pos

    def obtain_query_response(self, handle: QueryHandle) -> int:
        oracle_h, pos_h = self.query_regs[handle.id]
        return self.get_oracle_evaluation_at_position(
            oracle_h, self.obtain_query_position(pos_h))
