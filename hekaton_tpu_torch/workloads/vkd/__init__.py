from .vkd import (  # noqa: F401
    DEPTH,
    PATH_LENGTH,
    SPLIT_FACTOR,
    VerifiableKeyDirectoryCircuit,
    VerifiableKeyDirectoryCircuitParams,
)
