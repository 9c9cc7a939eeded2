"""CP-Groth16 verifier: one multi-Miller-loop pairing check.

Copy of hekaton_tpu/cpgroth16/verifier.py with the imports changed.

Equivalent of the reference's cp-groth16/src/verifier.rs:23-71:
e(A,B) * e(IC,-gamma) * prod_i e(D_i,-delta_i) * e(C,-delta_last) == e(alpha,beta).
Pairings are tiny and latency-bound; they stay on host (SURVEY.md §7).
"""
from __future__ import annotations

from ..curves import host as ch
from ..fields.bn254 import R
from ..pairing.host import multi_pairing, pairing

from .data_structures import Proof, VerifyingKey


class PreparedVerifyingKey:
    def __init__(self, vk: VerifyingKey):
        self.vk = vk
        self.alpha_beta_gt = pairing(vk.alpha_g, vk.beta_h)
        self.neg_gamma_h = ch.pt_neg(vk.gamma_h)
        self.neg_deltas_h = [ch.pt_neg(d) for d in vk.deltas_h]


def prepare_verifying_key(vk: VerifyingKey) -> PreparedVerifyingKey:
    return PreparedVerifyingKey(vk)


def prepare_inputs(pvk: PreparedVerifyingKey, public_inputs: list):
    assert len(public_inputs) + 1 == len(pvk.vk.gamma_abc_g), (
        f"{len(public_inputs) + 1} != {len(pvk.vk.gamma_abc_g)}"
    )
    acc = pvk.vk.gamma_abc_g[0]
    for x, base in zip(public_inputs, pvk.vk.gamma_abc_g[1:]):
        acc = ch.pt_add(acc, ch.pt_mul(base, x % R))
    return acc


def verify_proof_with_prepared_inputs(pvk, proof: Proof, prepared_inputs) -> bool:
    g1s = [proof.a, prepared_inputs] + list(proof.ds) + [proof.c]
    g2s = [proof.b, pvk.neg_gamma_h] + pvk.neg_deltas_h
    assert len(g1s) == len(g2s)
    return multi_pairing(g1s, g2s) == pvk.alpha_beta_gt


def verify_proof(pvk: PreparedVerifyingKey, proof: Proof, public_inputs: list) -> bool:
    return verify_proof_with_prepared_inputs(pvk, proof, prepare_inputs(pvk, public_inputs))
