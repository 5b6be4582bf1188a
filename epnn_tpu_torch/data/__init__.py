from epnn_tpu_torch.data.dataset import (
    MolBatch,
    bucket_molecules,
    minibatches,
    pad_molecules,
    round_up,
    train_val_split,
    uniform_q0_contract,
)
from epnn_tpu_torch.data.xyz import (
    Molecule,
    XYZParseError,
    load_directory,
    load_molecule,
    parse_xyz_file,
    parse_xyz_text,
)

__all__ = ["MolBatch", "Molecule", "XYZParseError", "bucket_molecules",
           "load_directory", "load_molecule", "minibatches", "pad_molecules", "parse_xyz_file",
           "parse_xyz_text", "round_up", "train_val_split",
           "uniform_q0_contract"]
