"""Setup artifact: the proving-key package written between setup and work.

Port of hekaton_tpu/runtime/keys.py: circuit id + params +
`minimal_proving_keys` keyed by unique-subcircuit index (CRS deduplication
across identical subcircuit shapes). Serialized with pickle — the package is
a local trusted artifact produced and consumed by this framework only.

`ProvingKeys.load` also reads a key file written by the JAX package's
`ProvingKeys.save`, without importing the JAX package: its unpickler maps
every class of a `hekaton_tpu.<module>` onto the same class of the port's
`hekaton_tpu_torch.<module>` (the key classes, `fields.host.Fq2` inside G2
points, `r1cs.fastsynth.CompiledMatrices`, the workloads' params), so a
loaded key holds no object of the JAX package. A class whose module the port
has no copy of fails to load.
"""
from __future__ import annotations

import pickle

FORMAT_VERSION = 1

_JAX_PKG = "hekaton_tpu."
_PORT_PKG = "hekaton_tpu_torch."


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith(_JAX_PKG):
            module = _PORT_PKG + module[len(_JAX_PKG):]
        return super().find_class(module, name)


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
