"""Polarization-response analysis (counterpart of
``epnn_tpu/analysis/polarization.py``).

The model's predicted *response* to dimerization — Δq = q(dimer) −
q(monomers at the same geometry) — compared against a labeled response.
Monomers within the cutoff exchange electrons, so Δq ≠ 0 even though each
subsystem's total is conserved.  The dimer is split at ``split`` (or the
molecule's splits metadata), each monomer is predicted as an isolated
system, and everything stays in natural atom order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from epnn_tpu_torch.data.xyz import Molecule
from epnn_tpu_torch.infer import Predictor


@dataclasses.dataclass
class PolarizationResult:
    dimer_name: str
    pred_dimer: np.ndarray          # (n,)
    pred_monomers: np.ndarray       # (n,) concatenated in atom order
    pred_polarization: np.ndarray   # (n,)
    label_polarization: Optional[np.ndarray] = None

    @property
    def error(self) -> Optional[np.ndarray]:
        if self.label_polarization is None:
            return None
        return self.label_polarization - self.pred_polarization

    @property
    def mae(self) -> Optional[float]:
        err = self.error
        return None if err is None else float(np.abs(err).mean())

    def summary(self) -> str:
        lines = [f"polarization response for {self.dimer_name}:"]
        lines.append(f"  pred:  {np.array2string(self.pred_polarization, precision=4)}")
        if self.label_polarization is not None:
            lines.append(
                f"  label: {np.array2string(self.label_polarization, precision=4)}"
            )
            lines.append(f"  MAE:   {self.mae:.5f} e")
        return "\n".join(lines)


def split_dimer(dimer: Molecule, split: Optional[int] = None,
                charges: Optional[Sequence[float]] = None):
    """Split a dimer into two monomer Molecules at ``split``.

    Monomer net charges are REQUIRED: they are physical inputs (integer
    charges of each isolated monomer) and are not derivable from the
    dimer file.
    Guessing them (e.g. proportionally by atom count) yields non-integer
    monomer charges and quantitative-looking but physically meaningless
    polarization output, so it is an error, not a default.
    """
    split = split if split is not None else dimer.split
    if split is None:
        raise ValueError(f"{dimer.name}: no split index available")
    if charges is None:
        raise ValueError(
            f"{dimer.name}: monomer net charges are required to split a "
            "dimer (pass charges=(q_monoA, q_monoB), or provide monomer "
            ".xyz files whose headers carry the charges)"
        )
    mono_a = Molecule(
        name=dimer.name + "_monoA",
        symbols=dimer.symbols[:split],
        xyz=dimer.xyz[:split],
        total_charge=float(charges[0]),
    )
    mono_b = Molecule(
        name=dimer.name + "_monoB",
        symbols=dimer.symbols[split:],
        xyz=dimer.xyz[split:],
        total_charge=float(charges[1]),
    )
    return mono_a, mono_b


def polarization_response(
    predictor: Predictor,
    dimer: Molecule,
    monomers: Optional[Sequence[Molecule]] = None,
    monomer_charges: Optional[Sequence[float]] = None,
    label_polarization: Optional[np.ndarray] = None,
    pad_to: Optional[int] = None,
) -> PolarizationResult:
    """Compute Δq(polarization) = q(dimer) − q(monomers), all predicted."""
    if monomers is None:
        monomers = split_dimer(dimer, charges=monomer_charges)
    q_dimer = predictor.predict_molecules([dimer], pad_to=pad_to)[0]
    q_monos = predictor.predict_molecules(list(monomers), pad_to=pad_to)
    q_mono = np.concatenate(q_monos)[: dimer.natoms]
    return PolarizationResult(
        dimer_name=dimer.name,
        pred_dimer=q_dimer,
        pred_monomers=q_mono,
        pred_polarization=q_dimer - q_mono,
        label_polarization=label_polarization,
    )
