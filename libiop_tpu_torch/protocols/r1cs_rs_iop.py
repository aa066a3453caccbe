"""The RS-encoded Aurora protocol (port of
libiop_tpu/protocols/r1cs_rs_iop.py): witness oracles fw/fAz/fBz/fCz, the
fz and rowcheck virtual oracles, and dispatch into the multi-lincheck, or
into Fractal's holographic multi-lincheck over indexed matrices.

fz = fw * Z_input + f_{1,v}, with f_{1,v} interpolating (1, primary) over
the input-variable domain; rowcheck = (fAz*fBz - fCz) / Z_constraint.
With zk (query bound b) each witness polynomial gets Z*R added, R random of
degree < b, so b evaluations outside the systematic domain reveal nothing:
fw degree n-(k+1)+b, fA/B/Cz degree m+b, rowcheck m+2b-1.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..algebra.generic import (divide_by_vanishing_any, fft_any, ifft_any,
                               lagrange_coeffs_ints_any, mul_by_vanishing_any,
                               place_columns, vanishing_eval_int,
                               vanishing_evals_over_any,
                               vanishing_inverse_evals_over_any)
from ..iop.runtime import IOPProtocol, OracleHandle, VirtualOracle
from .holographic_lincheck import (HolographicLincheckParams,
                                  HolographicMultiLincheck)
from .lincheck import LincheckParams, MultiLincheck


class FzOracle(VirtualOracle):
    """fz = fw * Z_input + f_{1,v}."""

    def __init__(self, F, input_domain, codeword_domain):
        self.F = F
        self.input_domain = input_domain
        self.L = codeword_domain
        self.primary: Optional[List[int]] = None
        self._f1v_cw = None

    def set_primary_input(self, primary: List[int]):
        self.primary = [self.F.sample_int(int(v)) for v in primary]
        self._f1v_cw = None

    def _f1v_over_codeword(self, device):
        if self._f1v_cw is None:
            vals = self.F.from_ints([1] + self.primary, device)
            self._f1v_cw = fft_any(ifft_any(vals, self.input_domain), self.L)
        return self._f1v_cw

    def traced_aux(self, device):
        if self.primary is None:
            return None
        return [vanishing_evals_over_any(self.input_domain, self.L, device),
                self._f1v_over_codeword(device)]

    def traced_contents(self, F, aux, evals):
        z_in, f1v = aux
        return F.add(F.mul(evals[0], z_in), f1v)

    def evaluation_at_point(self, position, x, vals):
        assert self.primary is not None
        F = self.F
        lag = lagrange_coeffs_ints_any(self.input_domain, x)
        f1v_x = lag[0]
        for l, v in zip(lag[1:], self.primary):
            f1v_x = F.add_ints(f1v_x, F.mul_ints(l, v))
        z_x = vanishing_eval_int(self.input_domain, x)
        return F.add_ints(F.mul_ints(vals[0], z_x), f1v_x)


class RowcheckOracle(VirtualOracle):
    """(fAz*fBz - fCz) / Z_constraint over the codeword domain."""

    def __init__(self, F, codeword_domain, constraint_domain):
        self.F = F
        self.L = codeword_domain
        self.constraint_domain = constraint_domain

    def traced_aux(self, device):
        return [vanishing_inverse_evals_over_any(self.constraint_domain,
                                                 self.L, device)]

    def traced_contents(self, F, aux, evals):
        az, bz, cz = evals
        return F.mul(F.sub(F.mul(az, bz), cz), aux[0])

    def evaluation_at_point(self, position, x, vals):
        F = self.F
        az, bz, cz = vals
        z_x = vanishing_eval_int(self.constraint_domain, x)
        return F.mul_ints(F.sub_ints(F.mul_ints(az, bz), cz), F.inv_int(z_x))


class EncodedAuroraParams:
    def __init__(self, F, interactive_security_bits: int,
                 codeword_domain_dim: int, constraint_domain_dim: int,
                 summation_domain_dim: int, query_bound: int, make_zk: bool,
                 holographic: bool = False, index_domain_dim: int = 0):
        self.F = F
        self.codeword_domain_dim = codeword_domain_dim
        self.constraint_domain_dim = constraint_domain_dim
        self.summation_domain_dim = summation_domain_dim
        self.query_bound = query_bound if make_zk else 0
        self.make_zk = make_zk
        self.holographic = holographic
        self.index_domain_dim = index_domain_dim
        if holographic:
            self.holographic_lincheck_params = HolographicLincheckParams(
                F, interactive_security_bits, constraint_domain_dim, make_zk)
        else:
            self.lincheck_params = LincheckParams(
                F, interactive_security_bits, constraint_domain_dim, make_zk)

    def max_tested_degree_bound(self) -> int:
        """r1cs_rs_iop.tcc:56-77; the holographic bound is the reference
        package's: 3|K| over the index domain, with the zk query bound."""
        b = self.query_bound
        if self.holographic:
            lincheck = max(
                3 * (1 << max(self.index_domain_dim,
                              self.constraint_domain_dim)),
                2 * (1 << self.summation_domain_dim) + b - 1)
        elif not self.make_zk:
            return 1 << self.summation_domain_dim
        else:
            lincheck = 2 * (1 << self.summation_domain_dim) + b - 1
        rowcheck = (1 << self.constraint_domain_dim) + 2 * b - 1
        return max(lincheck, rowcheck)

    def max_constraint_degree_bound(self) -> int:
        b = self.query_bound
        if self.holographic:
            lincheck = 4 * (1 << max(self.index_domain_dim,
                                     self.constraint_domain_dim))
        else:
            lincheck = 2 * (1 << self.summation_domain_dim) + b - 1
        rowcheck = 2 * (1 << self.constraint_domain_dim) + 2 * b - 1
        return max(lincheck, rowcheck)


class EncodedAurora:
    def __init__(self, iop: IOPProtocol, constraint_handle, variable_handle,
                 codeword_handle, r1cs, params: EncodedAuroraParams,
                 rng: Optional[np.random.Generator] = None):
        self.iop = iop
        self.F = iop.F
        self.params = params
        self.r1cs = r1cs
        self.rng = rng or np.random.default_rng()
        self.constraint_domain = iop.get_domain(constraint_handle)
        self.variable_domain = iop.get_domain(variable_handle)
        self.L = iop.get_domain(codeword_handle)
        self.codeword_handle = codeword_handle
        F = self.F
        k = r1cs.num_inputs
        assert (k + 1) & k == 0, "num_inputs + 1 must be a power of two"
        assert r1cs.num_constraints == self.constraint_domain.order
        assert r1cs.num_variables + 1 == self.variable_domain.order
        self.input_domain = self.variable_domain.get_subset_of_order(k + 1)
        n = self.variable_domain.order
        m = self.constraint_domain.order
        b = params.query_bound
        zk = params.make_zk
        self.fw_degree = n - (k + 1) + b
        self.fw_handle = iop.register_oracle(codeword_handle, self.fw_degree,
                                             make_zk=zk)
        self.fAz_handle = iop.register_oracle(codeword_handle, m + b,
                                              make_zk=zk)
        self.fBz_handle = iop.register_oracle(codeword_handle, m + b,
                                              make_zk=zk)
        self.fCz_handle = iop.register_oracle(codeword_handle, m + b,
                                              make_zk=zk)
        self.fz_oracle = FzOracle(F, self.input_domain, self.L)
        self.fz_handle = iop.register_virtual_oracle(
            codeword_handle, self.fw_degree + k + 1, [self.fw_handle],
            self.fz_oracle)
        Mz_handles = [self.fAz_handle, self.fBz_handle, self.fCz_handle]
        if params.holographic:
            self.multi_lincheck = HolographicMultiLincheck(
                iop, codeword_handle, constraint_handle,
                self.input_domain.dim, list(r1cs.matrices()), self.fz_handle,
                Mz_handles, params.holographic_lincheck_params, rng=self.rng)
        else:
            self.multi_lincheck = MultiLincheck(
                iop, codeword_handle, constraint_handle, variable_handle,
                self.input_domain.dim, list(r1cs.matrices()), self.fz_handle,
                Mz_handles, params.lincheck_params, rng=self.rng)
        self.rowcheck_oracle = RowcheckOracle(F, self.L, self.constraint_domain)
        self.rowcheck_handle = iop.register_virtual_oracle(
            codeword_handle, m + 2 * b - 1,
            [self.fAz_handle, self.fBz_handle, self.fCz_handle],
            self.rowcheck_oracle)
        self.var_reindex = np.array(
            [self.variable_domain.reindex_by_subgroup(self.input_domain.dim, j)
             for j in range(n)], dtype=np.int64)
        # the witness slots, fixed for the object's life: read-only, so
        # that place_columns keys their device map on the array itself
        self.var_reindex.setflags(write=False)
        self.aux_positions = self.var_reindex[r1cs.num_inputs + 1:]
        self._aux_positions_dev = {}  # str(device) -> its device copy

    def set_index_oracles(self, index_handle, indexed_handles):
        assert self.params.holographic
        self.multi_lincheck.set_index_oracles(index_handle, indexed_handles)

    def set_index_vectors_over_K(self, vectors_per_matrix):
        assert self.params.holographic
        self.multi_lincheck.set_index_vectors_over_K(vectors_per_matrix)

    def register_challenge(self):
        if self.params.holographic:
            self.multi_lincheck.register_challenge_alpha()
        else:
            self.multi_lincheck.register_challenge()

    def register_proof(self):
        if self.params.holographic:
            self.multi_lincheck.register_response_alpha()
            self.multi_lincheck.register_challenge_beta()
            self.multi_lincheck.register_response_beta()
        else:
            self.multi_lincheck.register_proof()

    def _encode(self, primary: List[int], auxiliary: List[int], masks):
        """The four witness codewords (the reference's ``_encode_fn`` as
        plain eager code): f_{1,v}; fw = (aux - f_{1,v} at the witness slots,
        interpolated, plus Z_variable * masks[0] under zk) / Z_input; f_Mz =
        LDE of Mz (plus Z_constraint * masks[1 + M] under zk) for M in A, B,
        C."""
        F = self.F
        dev = self.iop.device
        n = self.variable_domain.order
        m = self.constraint_domain.order
        aux_positions = self.aux_positions
        f1v_coeffs = ifft_any(F.from_ints([1] + list(primary), dev),
                              self.input_domain)
        f1v_vd = fft_any(f1v_coeffs, self.variable_domain)
        pos_dev = self._aux_positions_dev.get(str(dev))
        if pos_dev is None:
            pos_dev = self._aux_positions_dev[str(dev)] = torch.tensor(
                aux_positions, device=dev)
        fw_prime = place_columns(
            F.sub(F.from_ints(list(auxiliary), dev),
                  f1v_vd.index_select(1, pos_dev)), aux_positions, n)
        fw_coeffs = ifft_any(fw_prime, self.variable_domain)
        if masks:
            zr = mul_by_vanishing_any(masks[0], self.variable_domain)
            zr[:, :n] = F.add(zr[:, :n], fw_coeffs)
            fw_coeffs = zr
        quotient, _rem = divide_by_vanishing_any(fw_coeffs, self.input_domain)
        fw_cw = fft_any(quotient, self.L) if quotient.shape[1] else \
            F.zeros((self.L.order,), dev)
        z = self.r1cs.full_assignment(primary, auxiliary, dev)
        outs = [fw_cw]
        for idx, M in enumerate(self.r1cs.matrices()):
            coeffs = ifft_any(M.matvec(z), self.constraint_domain)
            if masks:
                zr = mul_by_vanishing_any(masks[1 + idx],
                                          self.constraint_domain)
                zr[:, :m] = F.add(zr[:, :m], coeffs)
                coeffs = zr
            outs.append(fft_any(coeffs, self.L))
        return outs

    def submit_witness_oracles(self, primary: List[int], auxiliary: List[int]):
        """Under zk the sumcheck masks, then the four witness masks (fw, A,
        B, C), draw from the prover's rng in the reference's order."""
        self.fz_oracle.set_primary_input(primary)
        self.multi_lincheck.submit_sumcheck_masking_polynomials()
        b = self.params.query_bound
        masks = [self.F.random((max(b, 1),), self.rng, self.iop.device)
                 for _ in range(4)] if self.params.make_zk else []
        fw_cw, az_cw, bz_cw, cz_cw = self._encode(primary, auxiliary, masks)
        self.iop.submit_oracle(self.fw_handle, fw_cw)
        self.iop.submit_oracle(self.fAz_handle, az_cw)
        self.iop.submit_oracle(self.fBz_handle, bz_cw)
        self.iop.submit_oracle(self.fCz_handle, cz_cw)

    def calculate_and_submit_proof(self):
        if self.params.holographic:
            self.multi_lincheck.calculate_response_alpha()
            self.iop.signal_prover_round_done()
            self.multi_lincheck.calculate_response_beta()
        else:
            self.multi_lincheck.calculate_and_submit_proof()

    def construct_verifier_state(self, primary: List[int]):
        self.fz_oracle.set_primary_input(primary)
        self.multi_lincheck.construct_verifier_state()

    def get_all_oracle_handles(self) -> List[OracleHandle]:
        out = self.multi_lincheck.ldt_oracle_handles()
        out.extend([self.fw_handle, self.fAz_handle, self.fBz_handle,
                    self.fCz_handle, self.rowcheck_handle])
        return out
