"""Setup artifact: the proving-key package written between setup and work.

Port of hekaton_tpu/runtime/keys.py: circuit id + params +
`minimal_proving_keys` keyed by unique-subcircuit index (CRS deduplication
across identical subcircuit shapes). Serialized with pickle — the package is
a local trusted artifact produced and consumed by this framework only.

`ProvingKeys.load` also reads a key file written by the JAX package's
`ProvingKeys.save`, without importing JAX: its unpickler maps the JAX
package's key classes (hekaton_tpu.cpgroth16.data_structures.* and
hekaton_tpu.runtime.keys.ProvingKeys) onto the port's. Host points, the
circuit params and the r1cs.fastsynth.CompiledMatrices come through as they
are (their modules import no JAX).
"""
from __future__ import annotations

import pickle

FORMAT_VERSION = 1

_CLASS_MAP = {
    "hekaton_tpu.cpgroth16.data_structures": "hekaton_tpu_torch.cpgroth16.data_structures",
}


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("hekaton_tpu.runtime.keys", "ProvingKeys"):
            return ProvingKeys
        return super().find_class(_CLASS_MAP.get(module, module), name)


class ProvingKeys:
    def __init__(self, circ_id: str, params, minimal_pks: dict, num_subcircuits: int,
                 representatives: list):
        self.circ_id = circ_id
        self.params = params
        self.minimal_pks = minimal_pks  # unique subcircuit idx -> ProvingKey
        self.num_subcircuits = num_subcircuits
        self.representatives = representatives  # idx -> unique idx

    @classmethod
    def generate(cls, circ_id: str, circ, backend, rng_factory):
        """Generate one CRS per unique subcircuit, with the boundary-index
        correction of crs_plan."""
        from ..protocol.coordinator import G16ProvingKeyGenerator, crs_plan

        gen = G16ProvingKeyGenerator(circ, backend)
        unique, reps = crs_plan(circ)
        minimal = {i: gen.gen_pk(rng_factory(i), i) for i in unique}
        return cls(circ_id, circ.get_params(), minimal, circ.num_subcircuits(), reps)

    def get_pk(self, subcircuit_idx: int):
        return self.minimal_pks[self.representatives[subcircuit_idx]]

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump({"version": FORMAT_VERSION, "keys": self}, f, protocol=4)

    @classmethod
    def load(cls, path: str) -> "ProvingKeys":
        """Read a key file written by this package or by the JAX package."""
        with open(path, "rb") as f:
            blob = _PortUnpickler(f).load()
        assert blob["version"] == FORMAT_VERSION
        return blob["keys"]
