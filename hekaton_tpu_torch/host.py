"""The port's host-side modules, gathered for scripts.

Copies of the JAX package's host modules (hekaton_tpu/{fields,curves,
pairing,native,r1cs,utils,hashes,protocol,workloads}), kept in this package
under the same relative paths so that the port imports nothing of the JAX
package: BN254 host algebra and pairings, BLS12-381's constants, tower and
pairing (`bls`, `bls_pairing`), the native host library, the seeded
Rng, the workloads, and the coordinator-side IPP / TIPA / SnarkPack
aggregation. Scripts that drive the port (chip_smoke.py) take them from here.
"""
from .curves import host as ch  # noqa: F401
from .fields import bls12_381 as bls  # noqa: F401
from .fields import bls12_381_tower as bls_tower  # noqa: F401
from .fields.bn254 import P, R  # noqa: F401
from .native import accel, available as native_available  # noqa: F401
from .pairing import bls12_381 as bls_pairing  # noqa: F401
from .protocol.aggregation import AggProvingKey, agg_transcript  # noqa: F401
from .protocol.ipp import ipp_setup  # noqa: F401
from .protocol.tipa import tipa_key_from_ipp  # noqa: F401
from .utils.rng import Rng  # noqa: F401
from .workloads.chain import PortalChainCircuit, PortalChainParams  # noqa: F401
from .workloads.merkle import MerkleTreeCircuit, MerkleTreeCircuitParams  # noqa: F401
