"""The JAX package's host-only modules that the port uses as they are.

None of these imports JAX (tests/test_torch_no_jax.py runs the port with
JAX blocked): BN254 host algebra and pairings, the native host library, the
seeded Rng, the workloads, and the coordinator-side IPP / TIPA / SnarkPack
aggregation. Scripts that drive the port (chip_smoke.py) take them from
here, so that every import they make is of this package.
"""
from hekaton_tpu.curves import host as ch  # noqa: F401
from hekaton_tpu.fields.bn254 import P, R  # noqa: F401
from hekaton_tpu.native import accel, available as native_available  # noqa: F401
from hekaton_tpu.protocol.aggregation import AggProvingKey, agg_transcript  # noqa: F401
from hekaton_tpu.protocol.ipp import ipp_setup  # noqa: F401
from hekaton_tpu.protocol.tipa import tipa_key_from_ipp  # noqa: F401
from hekaton_tpu.utils.rng import Rng  # noqa: F401
from hekaton_tpu.workloads.chain import PortalChainCircuit, PortalChainParams  # noqa: F401
from hekaton_tpu.workloads.merkle import MerkleTreeCircuit, MerkleTreeCircuitParams  # noqa: F401
