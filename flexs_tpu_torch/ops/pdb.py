"""Minimal PDB parsing: per-residue CA/CB coordinates + native sequence.

The reference delegates structure handling to PyRosetta (reference
rosetta.py:95-116); the centroid potential of `landscapes.rosetta` needs
only fixed-backbone geometry: one interaction centre per residue (CB,
falling back to CA for glycine).  Host-side numpy, as in the JAX package
(`flexs_tpu/ops/pdb.py`), of which this is the port's own copy.
"""
from typing import NamedTuple

import numpy as np

# 3-letter -> 1-letter residue codes (reference rosetta.py:19-42).
THREE_TO_ONE = {
    "ALA": "A",
    "ARG": "R",
    "ASN": "N",
    "ASP": "D",
    "CYS": "C",
    "GLN": "Q",
    "GLU": "E",
    "GLY": "G",
    "HIS": "H",
    "ILE": "I",
    "LEU": "L",
    "LYS": "K",
    "MET": "M",
    "PHE": "F",
    "PRO": "P",
    "SER": "S",
    "THR": "T",
    "TRP": "W",
    "TYR": "Y",
    "VAL": "V",
}


class Structure(NamedTuple):
    """Fixed-backbone geometry of one chain."""

    sequence: str  # native 1-letter sequence
    ca: np.ndarray  # f32[L, 3] alpha-carbon coordinates
    cb: np.ndarray  # f32[L, 3] beta-carbon coordinates (CA for GLY)


def parse_pdb(path: str, chain: str = None) -> Structure:
    """Parse the first model of a PDB file into a `Structure`.

    Only ATOM records are read; alternate locations other than ' '/'A' are
    skipped; residues missing a CA are dropped.
    """
    residues = {}  # (chain, resseq, icode) -> {"name":, "CA":, "CB":}
    order = []
    with open(path) as f:
        for line in f:
            if line.startswith("ENDMDL"):
                break
            if not line.startswith("ATOM"):
                continue
            altloc = line[16]
            if altloc not in (" ", "A"):
                continue
            atom_name = line[12:16].strip()
            if atom_name not in ("CA", "CB"):
                continue
            res_name = line[17:20].strip()
            chain_id = line[21]
            if chain is not None and chain_id != chain:
                continue
            key = (chain_id, line[22:26], line[26])
            xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            if key not in residues:
                residues[key] = {"name": res_name}
                order.append(key)
            residues[key][atom_name] = xyz

    seq, ca, cb = [], [], []
    for key in order:
        res = residues[key]
        if "CA" not in res or res["name"] not in THREE_TO_ONE:
            continue
        seq.append(THREE_TO_ONE[res["name"]])
        ca.append(res["CA"])
        cb.append(res.get("CB", res["CA"]))  # GLY has no CB

    return Structure(
        sequence="".join(seq),
        ca=np.asarray(ca, np.float32),
        cb=np.asarray(cb, np.float32),
    )
