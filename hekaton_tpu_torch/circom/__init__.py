from .r1cs_file import (  # noqa: F401
    Header,
    R1CSFile,
    read_binary_wtns,
    read_witness,
    write_witness,
)
