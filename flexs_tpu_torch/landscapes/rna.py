"""RNA binding and folding landscapes (ViennaRNA rebuilt on tensors).

Contract (reference flexs/landscapes/rna.py):
  * `RNABinding(targets, seq_length, conserved_region)`: fitness is the
    mean over targets of duplex binding energy normalized by the perfect-
    complement minimum energy scaled to seq_length (:75-85, :108-112);
    sequences violating the conserved region score 0 (:98-105); name
    "RNABinding_T{targets}_L{seq_length}" (:64).
  * `RNAFolding(norm_value)`: fitness = -MFE / norm_value (:15-27), the
    MFE from the Zuker/Turner fold DP of `ops.rna_fold`.
  * `registry()`: 4 hidden 100-nt targets, starts for L in {14, 50, 100},
    single-target, two-target, and conserved two-target problems, 36 in
    total (:119-210; target/start strings reproduced verbatim: they are
    benchmark data, not code).

The oracle is `ops.cuda_duplex.duplex_energies`: on a CUDA landscape the
hand-written kernel scores a whole batch against every target in one
launch; on a CPU landscape the plain PyTorch DP does.  The landscape
makes the kernel's per-landscape plan (`cuda_duplex.make_plan`) once, so a
call only launches.  `device_fitness()` exposes the pure
`(params, tokens)` form for the fused runner; its params are an
`RNAFitnessParams` (the plan, which holds the targets and the energy
model, the norms and the conserved pattern).  RNAFolding's pure form is
the module-level `_folding_fitness_fn`, shared by every instance, with a
`FoldingFitnessParams`.
"""
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from flexs_tpu_torch.alphabet import RNAA, Alphabet
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.ops import cuda_duplex, rna_duplex, rna_fold
from flexs_tpu_torch.types import SEQUENCES_TYPE

_RNA = Alphabet(RNAA)
_COMPLEMENTS = {"A": "U", "C": "G", "G": "C", "U": "A"}


class RNAFitnessParams(NamedTuple):
    """What `_rna_binding_fitness` reads, on the landscape's device."""

    plan: cuda_duplex.DuplexPlan  # the targets, the energy model, the kernel's inputs
    norms: torch.Tensor  # f32[T]
    conserved: torch.Tensor  # int64[L1], -1 where unconstrained


def _rna_binding_fitness(params: RNAFitnessParams, tokens):
    """Pure fitness f32[B]: mean over targets of normalized duplex energy."""
    plan = params.plan
    energies = cuda_duplex.duplex_energies(
        tokens, plan.targets_rev, plan.em, plan.maxloop, plan=plan
    )
    # Sum then divide by T, as a mean over the target axis is computed in f32.
    norms = params.norms
    fit = (energies / norms).sum(dim=1) / norms.shape[0]
    conserved = params.conserved
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

        target_rev = np.stack([_RNA.encode_one(t)[::-1] for t in targets])
        self._plan = cuda_duplex.make_plan(
            torch.as_tensor(target_rev, dtype=torch.int64, device=self.device),
            self._em,
            self.params.maxloop,
        )
        self.norm_values = self.compute_min_binding_energies()

        conserved = np.full(seq_length, -1, np.int64)
        if conserved_region is not None:
            start = conserved_region["start"]
            pattern = _RNA.encode_one(conserved_region["pattern"])
            conserved[start : start + len(pattern)] = pattern
        self._fitness_params = RNAFitnessParams(
            self._plan,
            torch.as_tensor(self.norm_values, dtype=torch.float32, device=self.device),
            torch.as_tensor(conserved, device=self.device),
        )

    def compute_min_binding_energies(self) -> np.ndarray:
        """Lowest possible binding energy per target (perfect complement).

        Each target's complement is scored against every target in one
        call; the diagonal is each complement against its own target.
        """
        complements = ["".join(_COMPLEMENTS[x] for x in t)[::-1] for t in self.targets]
        tokens = torch.as_tensor(_RNA.encode(complements), device=self.device)
        plan = self._plan
        energies = cuda_duplex.duplex_energies(
            tokens, plan.targets_rev, plan.em, plan.maxloop, plan=plan
        )
        own = energies.diagonal().cpu().numpy().astype(np.float64)
        lengths = np.array([len(t) for t in self.targets], np.float64)
        return own * self.seq_length / lengths

    def fitness_from_tokens(self, tokens) -> torch.Tensor:
        """f32[B] fitness of int[B, L] RNA tokens, on the landscape's device."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return _rna_binding_fitness(self._fitness_params, tokens)

    def device_fitness(self):
        """(pure fitness fn, params) pair for the fused runner.

        The fn routes CUDA tensors to the kernel and CPU tensors to the
        plain version (`ops.cuda_duplex.duplex_energies`); the params are an
        `RNAFitnessParams`; `params.plan` holds the targets and energy model.
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


class FoldingFitnessParams(NamedTuple):
    """What `_folding_fitness_fn` reads, on the landscape's device."""

    em: dict  # the fold's energy tables (`ops.rna_fold.fold_energy_model`)
    norm: torch.Tensor  # f32[], the normalization divisor


def _folding_fitness_fn(params: FoldingFitnessParams, tokens):
    """Pure fitness f32[B] of int64[B, L] tokens: -MFE / norm.

    Module-level, so every RNAFolding instance shares it (the generic
    sweep requires its landscapes to share one fitness function).
    """
    maxloop = params.em["interior_cost"].shape[0] - 2
    return -rna_fold.zuker_mfe_batch(tokens, params.em, maxloop) / params.norm


class RNAFolding(Landscape):
    """RNA folding stability landscape (negative MFE).

    The oracle is the Turner-structured Zuker DP of `ops.rna_fold`
    (hairpin size curve, bulge/interior/1x1 terms from the calibrated
    duplex tables, affine multiloop closure, dangles=2 helix-end
    mismatches, tetraloop/triloop bonuses), the analog of the reference's
    `RNA.fold` call (reference rna.py:15-27).  It folds sequences of any
    length; one call folds a batch of one length.
    """

    def __init__(self, norm_value: float = 1, params=None, device=None):
        """Create an RNAFolding landscape.

        Args:
            norm_value: Normalization divisor (fitness = -MFE / norm).
            params: Duplex energy parameters the fold model derives its
                sequence-dependent tables from (default: calibrated set).
            device: Where the tables live and folding runs (default
                "cuda"; pass "cpu" to fold on the CPU).
        """
        super().__init__(name="RNAFolding")
        self.norm_value = norm_value
        self.device = resolve_device(device)
        p = params or rna_duplex.DuplexParams.calibrated()
        self._fitness_params = FoldingFitnessParams(
            rna_fold.fold_energy_model(p, self.device),
            torch.tensor(norm_value, dtype=torch.float32, device=self.device),
        )

    def fitness_from_tokens(self, tokens) -> torch.Tensor:
        """f32[B] fitness of int[B, L] RNA tokens, on the landscape's device."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return _folding_fitness_fn(self._fitness_params, tokens)

    def device_fitness(self):
        """(pure fitness fn, params) pair for the fused runner and the sweeps."""
        return _folding_fitness_fn, self._fitness_params

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        # The reference folds each string on its own (reference
        # rna.py:15-27, no fixed length): fold one batch per length.
        seqs = list(sequences)
        out = np.empty(len(seqs), np.float64)
        by_len: Dict[int, list] = {}
        for i, s in enumerate(seqs):
            by_len.setdefault(len(s), []).append(i)
        for idxs in by_len.values():
            tokens = _RNA.encode([seqs[i] for i in idxs])
            out[idxs] = self.fitness_from_tokens(tokens).cpu().numpy()
        return out


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
