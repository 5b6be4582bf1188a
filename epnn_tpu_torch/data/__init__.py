from epnn_tpu_torch.data.dataset import (
    MolBatch,
    pad_molecules,
    round_up,
    uniform_q0_contract,
)
from epnn_tpu_torch.data.xyz import (
    Molecule,
    XYZParseError,
    load_molecule,
    parse_xyz_file,
    parse_xyz_text,
)

__all__ = ["MolBatch", "Molecule", "XYZParseError", "load_molecule",
           "pad_molecules", "parse_xyz_file", "parse_xyz_text", "round_up",
           "uniform_q0_contract"]
