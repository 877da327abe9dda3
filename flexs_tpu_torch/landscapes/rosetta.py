"""Rosetta-style folding landscape: centroid energy over a fixed backbone.

Contract (reference flexs/landscapes/rosetta.py):
  * `RosettaFolding(pdb_file, sigmoid_center, sigmoid_norm_value)`: name
    "RosettaFolding"; `wt_sequence` from the PDB; fitness =
    sigmoid((-E - center) / norm) (:173-177); `get_folding_energy(seq)`
    raises on a length mismatch (:152-171).
  * `registry()`: the 3msi (66-aa) and 3mx7 (90-aa) problems with the
    reference's starting sequences and sigmoid parameters (:180-228).

The JAX package rebuilds PyRosetta's `cen_std` centroid score as a potential
that is linear in per-(burial bin, residue) and per-(distance bin, residue
pair) tables over the fixed backbone:

    E(s) = sum_i ENV[bbin_i, s_i] + sum_{(i,j) contacts} PAIR[dbin_ij, s_i, s_j]

The fitted tables, the structures and the feature geometry are read in
place from the JAX package's data directory
(`flexs_tpu/landscapes/data/rosetta/`).  Scoring a batch is two gathers and
two sums on the landscape's device; `device_fitness()` exposes the pure
`(params, tokens)` form for the fused runner and the sweeps.
"""
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from flexs_tpu_torch.alphabet import AAS, Alphabet
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.ops.pdb import Structure, parse_pdb
from flexs_tpu_torch.types import SEQUENCES_TYPE

_AA = Alphabet(AAS)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DATA_DIR = os.path.join(_REPO, "flexs_tpu", "landscapes", "data", "rosetta")
_PARAMS_FILE = os.path.join(_DATA_DIR, "centroid_potential.npz")

# Feature geometry of the fitted potential (the JAX package's values: the
# tables were fitted against exactly these features).
BURIAL_RADIUS = 10.0  # CB neighbours within this radius define burial
NUM_BURIAL_BINS = 8
BURIAL_BIN_WIDTH = 3  # bin = min(count // width, bins - 1)
CONTACT_BINS = np.array([4.5, 5.5, 6.5, 7.5, 8.5, 10.0], np.float32)
MIN_SEQ_SEP = 2  # |i - j| >= this for pair terms


def compute_features(structure: Structure):
    """(burial_bins i32[L], pair_i, pair_j, pair_bins i32[P]) from fixed CB geometry."""
    cb = structure.cb
    dists = np.linalg.norm(cb[:, None, :] - cb[None, :, :], axis=2)
    L = len(cb)

    neighbor_count = ((dists < BURIAL_RADIUS).sum(axis=1) - 1).astype(np.int64)
    burial_bins = np.minimum(neighbor_count // BURIAL_BIN_WIDTH, NUM_BURIAL_BINS - 1)

    pair_i, pair_j, pair_bins = [], [], []
    for i in range(L):
        for j in range(i + MIN_SEQ_SEP, L):
            d = dists[i, j]
            if d < CONTACT_BINS[-1]:
                pair_i.append(i)
                pair_j.append(j)
                pair_bins.append(int(np.searchsorted(CONTACT_BINS, d)))
    return (
        burial_bins.astype(np.int32),
        np.asarray(pair_i, np.int32),
        np.asarray(pair_j, np.int32),
        np.asarray(pair_bins, np.int32),
    )


def default_potential():
    """Physics-prior potential, used when no fitted tables exist.

    Hydropathy-driven burial preference and a crude hydrophobic contact
    bonus; the fitted tables (centroid_potential.npz) supersede it.
    """
    # Kyte-Doolittle hydropathy in AAS order.
    kd = {
        "I": 4.5, "V": 4.2, "L": 3.8, "F": 2.8, "C": 2.5, "M": 1.9, "A": 1.8,
        "G": -0.4, "T": -0.7, "S": -0.8, "W": -0.9, "Y": -1.3, "P": -1.6,
        "H": -3.2, "E": -3.5, "Q": -3.5, "D": -3.5, "N": -3.5, "K": -3.9,
        "R": -4.5,
    }
    hydro = np.array([kd[a] for a in AAS], np.float32) / 4.5
    burial = np.arange(NUM_BURIAL_BINS, dtype=np.float32) / (NUM_BURIAL_BINS - 1)
    env = -np.outer(burial - 0.5, hydro)  # buried hydrophobic = favourable
    contact = -0.2 * np.outer(hydro, hydro)  # like-likes-like
    pair = np.stack([contact * (1 - b / len(CONTACT_BINS)) for b in range(len(CONTACT_BINS))])
    return env.astype(np.float32), pair.astype(np.float32), 0.0, 1.0


def load_potential():
    """(env [B, 20], pair [D, 20, 20], energy_offset, energy_scale)."""
    if os.path.exists(_PARAMS_FILE):
        with np.load(_PARAMS_FILE) as d:
            return (
                d["env"].astype(np.float32),
                d["pair"].astype(np.float32),
                float(d["offset"]),
                float(d["scale"]),
            )
    return default_potential()


class RosettaFitnessParams(NamedTuple):
    """What `_rosetta_fitness` reads, on the landscape's device."""

    env_site: torch.Tensor  # f32[L, 20]: burial-bin lookup folded in per position
    pair_site: torch.Tensor  # f32[P, 20, 20]: the pair table gathered per contact
    pair_i: torch.Tensor  # int64[P]
    pair_j: torch.Tensor  # int64[P]
    consts: torch.Tensor  # f32[2]: (sigmoid_center, sigmoid_norm)


def _energies(params: RosettaFitnessParams, tokens: torch.Tensor) -> torch.Tensor:
    """Centroid energy f32[B] of int[B, L] AA tokens: two gathers, two sums."""
    tokens = tokens.long()
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    env_e = params.env_site[positions, tokens].sum(dim=1)
    contacts = torch.arange(params.pair_site.shape[0], device=tokens.device)
    pair_e = params.pair_site[contacts, tokens[:, params.pair_i], tokens[:, params.pair_j]]
    return env_e + pair_e.sum(dim=1)


def _rosetta_fitness(params: RosettaFitnessParams, tokens) -> torch.Tensor:
    """Pure fitness f32[B] of int[B, L] AA tokens: sigmoid((-E - center) / norm).

    Module-level, so the fused runner and the sweeps see one function for
    every Rosetta landscape.
    """
    center, norm = params.consts[0], params.consts[1]
    return torch.sigmoid((-_energies(params, tokens) - center) / norm)


class RosettaFolding(Landscape):
    """Centroid folding energy of substitutions on a fixed backbone.

    Attributes:
        wt_sequence: Native sequence parsed from the PDB.
    """

    def __init__(
        self,
        pdb_file: str,
        sigmoid_center: float,
        sigmoid_norm_value: float,
        chain: Optional[str] = None,
        device=None,
    ):
        """Create a RosettaFolding landscape from a PDB structure.

        `device` is where the tables live and scoring runs (default "cuda";
        pass "cpu" to run on the CPU).
        """
        super().__init__("RosettaFolding")
        self.device = resolve_device(device)

        self.structure = parse_pdb(pdb_file, chain=chain)
        self.wt_sequence = self.structure.sequence
        self.sigmoid_center = sigmoid_center
        self.sigmoid_norm_value = sigmoid_norm_value

        burial_bins, pair_i, pair_j, pair_bins = compute_features(self.structure)
        env, pair, offset, scale = load_potential()

        length = len(self.wt_sequence)
        # Fold the burial-bin lookup into a per-site [L, 20] table and the
        # per-contact distance bin into a [P, 20, 20] table; spread the
        # fitted offset over the sites so E keeps PyRosetta's scale.
        env_site = env[burial_bins] * scale
        env_site = env_site + offset / max(length, 1)
        pair_site = pair[pair_bins] * scale

        def on_device(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        self._fitness_params = RosettaFitnessParams(
            on_device(env_site, torch.float32),
            on_device(pair_site, torch.float32),
            on_device(pair_i, torch.int64),
            on_device(pair_j, torch.int64),
            on_device([sigmoid_center, sigmoid_norm_value], torch.float32),
        )

    def _check_lengths(self, sequences) -> None:
        for s in sequences:
            if len(s) != len(self.wt_sequence):
                raise ValueError(
                    "`sequence` must be of the same length as original protein "
                    "in .pdb file"
                )

    def get_folding_energy(self, sequence: str) -> float:
        """Centroid energy of `sequence` threaded onto the backbone."""
        self._check_lengths([sequence])
        tokens = torch.as_tensor(_AA.encode([sequence]), device=self.device)
        return float(_energies(self._fitness_params, tokens)[0])

    def fitness_from_tokens(self, tokens) -> torch.Tensor:
        """f32[B] fitness of int[B, L] AA tokens, on the landscape's device."""
        return _rosetta_fitness(
            self._fitness_params, torch.as_tensor(tokens, device=self.device)
        )

    def device_fitness(self):
        """(pure fitness fn, params) pair for the fused runner; params = `RosettaFitnessParams`."""
        return _rosetta_fitness, self._fitness_params

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        seqs = list(sequences)
        if not seqs:  # the reference returns an empty result for an empty batch
            return np.zeros(0, np.float64)
        self._check_lengths(seqs)
        scores = self.fitness_from_tokens(_AA.encode(seqs))
        return scores.cpu().numpy().astype(np.float64)


def registry() -> Dict[str, Dict]:
    """Return problems (reference rosetta.py:180-228; starts verbatim)."""
    return {
        "3msi": {
            "params": {
                "pdb_file": f"{_DATA_DIR}/3msi.pdb",
                "sigmoid_center": -3,
                "sigmoid_norm_value": 12,
            },
            "starts": {
                "ed_3_wt": "MAQASVVANQLIPINTHLTLVMMRSEVVTYVHIPAEDIPRLVSMDVNRAVPLGTTLMPDMVKGYAA",  # noqa: E501
                "ed_5_wt": "MAQASVVFNQLIPINTHLTLVMMRFEVVTPVGCPAMDIPRLVSQQVNRAVPLGTTLMPDMVKGYAA",  # noqa: E501
                "ed_7_wt": "WAQRSVVANQLIPINTGLTLVMMRSELVTGVGAPAEDIPRLVSMQVNRAVPLGTTNMPDMVKGYAA",  # noqa: E501
                "ed_12_wt": "RAQESVVANQLIPILTHLTQKMSRRFVVTPVGIPAEDIPRLVNAQVDRAVPLGTTLMPDMDKGYAA",  # noqa: E501
                "ed_27_wt": "MRRYSVIAYQERPINLHSTLTFNRSEVPWPVNRPASDAPRLVSMQNNRSVPLGTKLPEDPVCRYAL",  # noqa: E501
            },
        },
        "3mx7": {
            "params": {
                "pdb_file": f"{_DATA_DIR}/3mx7.pdb",
                "sigmoid_center": -3,
                "sigmoid_norm_value": 12,
            },
            "starts": {
                "ed_2_wt": "MTDLVAVWDVALSDGHHKIEFEHGTTSGKRVVYVDGKESIRKEWMFKLVGKETFYVGAAKTKATINIDAISGFAYEYTLEINGKSLKKYM",  # noqa: E501
                "ed_5_wt": "MTDLVAVWFYALSDGVHKIEFEHGTTSGKRVVYVDGKEEIRKEWMFKLVGKETFYVGAAKTKATINIWAISGFAIEYTLTINGKSLKKYM",  # noqa: E501
                "ed_7_wt": "MTDLVAYWDVANSDGVHKISFEHGTTSGKRVVYVDGKEEIRKEGMFKLVGRETFYVGAAKTKATINIDAGSGFAYEYTLEINGKVLKKYM",  # noqa: E501
                "ed_13_wt": "VTDKSAVWDVALSDGVHKIEFEHGTTSIKRVVYVQGKEENRKEWQFKGVGKETFYVGAAKRKATINIDAKSGFAYEVTLEINQKSLKQYM",  # noqa: E501
                "ed_29_wt": "STDLVEVMRIACSDGVHKIEFEHGTTSGMRVHYKDLKEEGRKPHRFKLEGNFQWYENCHKTKAIINITAIMGFAYWYFLEWNGKSLKKYM",  # noqa: E501
            },
        },
    }
