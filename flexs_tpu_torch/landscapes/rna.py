"""RNA binding landscape (ViennaRNA duplex energy rebuilt on tensors).

Contract (reference flexs/landscapes/rna.py):
  * `RNABinding(targets, seq_length, conserved_region)`: fitness is the
    mean over targets of duplex binding energy normalized by the perfect-
    complement minimum energy scaled to seq_length (:75-85, :108-112);
    sequences violating the conserved region score 0 (:98-105); name
    "RNABinding_T{targets}_L{seq_length}" (:64).
  * `registry()`: 4 hidden 100-nt targets, starts for L in {14, 50, 100},
    single-target, two-target, and conserved two-target problems, 36 in
    total (:119-210; target/start strings reproduced verbatim: they are
    benchmark data, not code).

The oracle is `ops.cuda_duplex.duplex_energies`: on a CUDA landscape the
hand-written kernel scores a whole batch against every target in one
launch; on a CPU landscape the plain PyTorch DP does.  `device_fitness()`
exposes the pure `(params, tokens)` form for the fused runner.
"""
from typing import Dict, List, Optional

import numpy as np
import torch

from flexs_tpu_torch.alphabet import RNAA, Alphabet
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.ops import cuda_duplex, rna_duplex
from flexs_tpu_torch.types import SEQUENCES_TYPE

_RNA = Alphabet(RNAA)
_COMPLEMENTS = {"A": "U", "C": "G", "G": "C", "U": "A"}


def _rna_binding_fitness(params, tokens):
    """Pure fitness f32[B]: mean over targets of normalized duplex energy.

    params = (targets_rev int64[T, L2], energy-model dict, norms f32[T],
              conserved_pattern int64[L1] (-1 where unconstrained)).
    """
    targets_rev, em, norms, conserved = params
    maxloop = em["interior_cost"].shape[0] - 2
    energies = cuda_duplex.duplex_energies(tokens, targets_rev, em, maxloop)
    # Sum then divide by T, as a mean over the target axis is computed in f32.
    fit = (energies / norms).sum(dim=1) / norms.shape[0]
    ok = ((conserved < 0) | (tokens == conserved[None, :])).all(dim=1)
    return torch.where(ok, fit, 0.0)


class RNABinding(Landscape):
    """RNA binding affinity to one or more hidden targets."""

    def __init__(
        self,
        targets: List[str],
        seq_length: int,
        conserved_region: Optional[Dict] = None,
        params: Optional[rna_duplex.DuplexParams] = None,
        use_pallas: bool = False,
        device=None,
    ):
        """Create an RNABinding landscape.

        Args:
            targets: Binding-target RNA strings; fitness is the mean of the
                per-target normalized binding energies.
            seq_length: Length of sequences to be evaluated.
            conserved_region: Optional `{"start": int, "pattern": str}`;
                violating sequences score 0 ("swampland").
            params: Duplex energy parameters (default: calibrated set).
            use_pallas: Kept for signature parity with the JAX package; it
                changes nothing (on the card every path uses the kernel).
            device: Where the energy tables live and scoring runs
                (default "cuda"; pass "cpu" for the plain version).
        """
        super().__init__(name=f"RNABinding_T{targets}_L{seq_length}")

        self.targets = targets
        self.seq_length = seq_length
        self.conserved_region = conserved_region
        self.use_pallas = use_pallas
        self.device = resolve_device(device)
        self.params = params or rna_duplex.DuplexParams.calibrated()
        self._em = self.params.energy_model(self.device)

        self.norm_values = self.compute_min_binding_energies()

        target_rev = np.stack([_RNA.encode_one(t)[::-1] for t in targets])
        conserved = np.full(seq_length, -1, np.int64)
        if conserved_region is not None:
            start = conserved_region["start"]
            pattern = _RNA.encode_one(conserved_region["pattern"])
            conserved[start : start + len(pattern)] = pattern
        self._fitness_params = (
            torch.as_tensor(target_rev, dtype=torch.int64, device=self.device),
            self._em,
            torch.as_tensor(self.norm_values, dtype=torch.float32, device=self.device),
            torch.as_tensor(conserved, device=self.device),
        )

    def compute_min_binding_energies(self) -> np.ndarray:
        """Lowest possible binding energy per target (perfect complement)."""
        energies = []
        for target in self.targets:
            complement = "".join(_COMPLEMENTS[x] for x in target)[::-1]
            tokens = torch.as_tensor(_RNA.encode([complement]), device=self.device)
            target_rev = torch.as_tensor(
                _RNA.encode_one(target)[::-1].copy(), device=self.device
            )
            e = float(
                cuda_duplex.duplex_energies(
                    tokens, target_rev[None], self._em, self.params.maxloop
                )[0, 0]
            )
            energies.append(e * self.seq_length / len(target))
        return np.array(energies)

    def fitness_from_tokens(self, tokens) -> torch.Tensor:
        """f32[B] fitness of int[B, L] RNA tokens, on the landscape's device."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return _rna_binding_fitness(self._fitness_params, tokens)

    def device_fitness(self):
        """(pure fitness fn, params) pair for the fused runner.

        The fn routes CUDA tensors to the kernel and CPU tensors to the
        plain version (`ops.cuda_duplex.duplex_energies`).
        """
        return _rna_binding_fitness, self._fitness_params

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        seqs = list(sequences)
        for seq in seqs:
            if len(seq) != self.seq_length:
                raise ValueError(
                    f"All sequences in `sequences` must be of length "
                    f"{self.seq_length}"
                )
        if not seqs:
            return np.zeros(0, np.float64)
        scores = self.fitness_from_tokens(_RNA.encode(seqs))
        return scores.cpu().numpy().astype(np.float64)


def registry() -> Dict[str, Dict]:
    """Return the benchmark problems (reference rna.py:119-210 verbatim)."""
    targets = [
        "GAACGAGGCACAUUCCGGCUCGCCCGGCCCAUGUGAGCAUGGGCCGGACCCCGUCCGCGCGGGGCCCCCGCGCGGACGGGGGCGAGCCGGAAUGUGCCUC",  # noqa: E501
        "GAGGCACAUUCCGGCUCGCCCCCGUCCGCGCGGGGGCCCCGCGCGGACGGGGUCCGGCCCGCGCGGGGCCCCCGCGCGGGAGCCGGAAUGUGCCUCGUUC",  # noqa: E501
        "CCGGUGAUACUGUUAGUGGUCACGGUGCAUUUAUAGCGCUAAAGUACAGUCUUCCCCUGUUGAACGGCGCCAUUGCAUACAGGGCCAGCCGCGUAACGCC",  # noqa: E501
        "UAAGAGAGCGUAAAAAUAGAGAUAUGUUCUUGGGUCAGGGCUAUGCGUACCCCAUGAGAGUAAAUCAUACCCCCAAUGGGCUUCGGCGGAAAUUCACUUA",  # noqa: E501
    ]

    starts = {
        14: {
            1: "AUGGGCCGGACCCC",
            2: "GCCCCGCCGGAAUG",
            3: "UCUUGGGGACUUUU",
            4: "GGAUAACAAUUCAU",
            5: "CCCAUGCGCGAUCA",
        },
        50: {
            1: "GAACGAGGCACAUUCCGGCUCGCCCGGCCCAUGUGAGCAUGGGCCGGACC",
            2: "CCGUCCGCGCGGGGCCCCCGCGCGGACGGGGGCGAGCCGGAAUGUGCCUC",
            3: "AUGUUUCUUUUAUUUAUCUGAGCAUGGGCGGGGCAUUUGCCCAUGCAAUU",
            4: "UAAACGAUGCUUUUGCGCCUGCAUGUGGGUUAGCCGAGUAUCAUGGCAAU",
            5: "AGGGAAGAUUAGAUUACUCUUAUAUGACGUAGGAGAGAGUGCGGUUAAGA",
        },
        100: {
            1: "GAACGAGGCACAUUCCGGCUCGCCCGGCCCAUGUGAGCAUGGGCCGGACCCCGUCCGCGCGGGGCCCCCGCGCGGACGGGGGCGAGCCGGAAUGUGCCUC",  # noqa: E501
            2: "AGCAUCUCGCCGUGGGGGCGGGCCCGGCCCAUGUGAGCAUGCGUAGGUUUAUCCCAUAGAGGACCCCGGGAGAACUGUCCAAUUGGCUCCUAGCCCACGC",  # noqa: E501
            3: "GGCGGAUACUAGACCCUAUUGGCCCGGCCCAUGUGAGCAUGGCCCCAGAUCUUCCGCUCACUCGCAUAUUCCCUCCGGUUAAGUUGCCGUUUAUGAAGAU",  # noqa: E501
            4: "UUGCAGGUCCCUACACCUCCGGCCCGGCCCAUGUGACCAUGAAUAGUCCACAUAAAAACCGUGAUGGCCAGUGCAGUUGAUUCCGUGCUCUGUACCCUUU",  # noqa: E501
            5: "UGGCGAUGAGCCGAGCCGCCAUCGGACCAUGUGCAAUGUAGCCGUUCGUAGCCAUUAGGUGAUACCACAGAGUCUUAUGCGGUUUCACGUUGAGAUUGCA",  # noqa: E501
        },
    }

    problems = {}

    for t in range(len(targets)):
        for length, start in starts.items():
            problems[f"L{length}_RNA{t + 1}"] = {
                "params": {"targets": [targets[t]], "seq_length": length},
                "starts": start,
            }

    for t1 in range(len(targets)):
        for t2 in range(t1 + 1, len(targets)):
            for length, start in starts.items():
                problems[f"L{length}_RNA{t1 + 1}+{t2 + 1}"] = {
                    "params": {
                        "targets": [targets[t1], targets[t2]],
                        "seq_length": length,
                    },
                    "starts": start,
                }

    for t1 in range(len(targets)):
        for t2 in range(t1 + 1, len(targets)):
            problems[f"C20_L100_RNA{t1 + 1}+{t2 + 1}"] = {
                "params": {
                    "targets": [targets[t1], targets[t2]],
                    "seq_length": 100,
                    "conserved_region": {
                        "start": 21,
                        "pattern": "GCCCGGCCCAUGUGAGCAUG",
                    },
                },
                "starts": starts[100],
            }

    return problems
