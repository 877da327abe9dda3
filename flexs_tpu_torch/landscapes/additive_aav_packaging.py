"""Additive AAV packaging landscape ("rough Mt. Fuji").

Contract (reference landscapes/additive_aav_packaging.py):
  * `AdditiveAAVPackaging(phenotype, minimum_fitness_multiplier, start,
    end, noise)`: name "AdditiveAAVPackaging_phenotype={p}" (:55); the
    fitness of a sequence is the sum of per-position per-residue log2
    fitness values over [start, end) (:101-107), plus
    `mfm * max_possible`, over `max_possible * (mfm + 1)` (:109-113), plus
    optional Gaussian noise, clipped at 0 (:114-116).
  * `compute_max_possible` picks, per position, the best residue whose
    `log2_packaging_v_wt > -6` (:80-98).
  * `registry()`: 6 phenotypes over region 450-540 (:121-147).

The substitution data is read in place from the JAX package's data
directory (`flexs_tpu/landscapes/data/additive_aav_packaging/`).  The
per-position dict walk of the reference becomes one [L, 20] gather-and-sum
on the landscape's device, and `device_fitness()` plugs the noiseless
landscape into the fused runner and the sweeps.  The noise is drawn on the
host from the landscape's own `torch.Generator`.
"""
import json
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from flexs_tpu_torch.alphabet import AAS, Alphabet
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.types import SEQUENCES_TYPE

AAV2_WT = (
    "MAADGYLPDWLEDTLSEGIRQWWKLKPGPPPPKPAERHKDDSRGLVLPGYKYLGPFNGLD"
    "KGEPVNEADAAALEHDKAYDRQLDSGDNPYLKYNHADAEFQERLKEDTSFGGNLGRAVFQ"
    "AKKRVLEPLGLVEEPVKTAPGKKRPVEHSPVEPDSSSGTGKAGQQPARKRLNFGQTGDAD"
    "SVPDPQPLGQPPAAPSGLGTNTMATGSGAPMADNNEGADGVGNSSGNWHCDSTWMGDRVI"
    "TTSTRTWALPTYNNHLYKQISSQSGASNDNHYFGYSTPWGYFDFNRFHCHFSPRDWQRLI"
    "NNNWGFRPKRLNFKLFNIQVKEVTQNDGTTTIANNLTSTVQVFTDSEYQLPYVLGSAHQG"
    "CLPPFPADVFMVPQYGYLTLNNGSQAVGRSSFYCLEYFPSQMLRTGNNFTFSYTFEDVPF"
    "HSSYAHSQSLDRLMNPLIDQYLYYLSRTNTPSGTTTQSRLQFSQAGASDIRDQSRNWLPG"
    "PCYRQQRVSKTSADNNNSEYSWTGATKYHLNGRDSLVNPGPAMASHKDDEEKFFPQSGVL"
    "IFGKQGSEKTNVDIEKVMITDEEEIRTTNPVATEQYGSVSTNLQRGNRQAATADVNTQGV"
    "LPGMVWQDRDVYLQGPIWAKIPHTDGHFHPSPLMGGFGLKHPPPQILIKNTPVPANPSTT"
    "FSAAKFASFITQYSTGQVSVEIEWELQKENSKRWNPEIQYTSNYNKSVNVDFTVDTNGVY"
    "SEPRPIGTRYLTRNL"
)

_AA = Alphabet(AAS)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DATA_FILE = os.path.join(
    _REPO, "flexs_tpu", "landscapes", "data", "additive_aav_packaging",
    "AAV2_single_subs.json",
)


class AAVFitnessParams(NamedTuple):
    """What `_aav_fitness` reads, on the landscape's device."""

    fit_matrix: torch.Tensor  # f32[L, 20]; residues without data score 0
    offset: torch.Tensor  # f32[]: mfm * max_possible
    norm: torch.Tensor  # f32[]: max_possible * (mfm + 1)


def _aav_fitness_unclipped(params: AAVFitnessParams, tokens) -> torch.Tensor:
    """Normalized additive fitness f32[B] before the zero clip (noise adds here)."""
    tokens = tokens.long()
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    raw = params.fit_matrix[positions, tokens].sum(dim=1)
    return (raw + params.offset) / params.norm


def _aav_fitness(params: AAVFitnessParams, tokens) -> torch.Tensor:
    """Pure fitness f32[B] of int[B, L] AA tokens: the gather-sum, clipped at 0.

    The reference's noiseless path (additive_aav_packaging.py:109-116).
    Module-level, so the fused runner and the sweeps see one function for
    every phenotype.
    """
    return torch.clamp_min(_aav_fitness_unclipped(params, tokens), 0.0)


class AdditiveAAVPackaging(Landscape):
    """Additive landscape from AAV2 capsid single-substitution data.

    Attributes:
        wild_type: AAV2 wild-type substring between `start` and `end`.
    """

    def __init__(
        self,
        phenotype: str = "heart",
        minimum_fitness_multiplier: float = 1,
        start: int = 0,
        end: int = 735,
        noise: float = 0,
        seed: Optional[int] = None,
        device=None,
    ):
        """Create an AdditiveAAVPackaging landscape.

        Args:
            phenotype: One of "heart", "lung", "kidney", "liver", "blood",
                "spleen".
            start: Starting index of the AAV subsequence to evaluate.
            end: Ending index of the AAV subsequence to evaluate.
            noise: Standard deviation of Gaussian noise added to fitness.
            seed: Seed of the noise generator (None: a fresh random seed;
                the reference is unseeded).
            device: Where the fitness matrix lives and scoring runs
                (default "cuda"; pass "cpu" to run on the CPU).
        """
        super().__init__(f"AdditiveAAVPackaging_phenotype={phenotype}")
        self.device = resolve_device(device)

        self.sequences = {}
        self.phenotype = f"log2_{phenotype}_v_wt"
        self.mfm = minimum_fitness_multiplier
        self.start = start
        self.end = end
        self.noise = noise
        self.wild_type = AAV2_WT[start:end]
        self._noise_gen = torch.Generator()
        if seed is None:
            self._noise_gen.seed()
        else:
            self._noise_gen.manual_seed(seed)

        if not os.path.exists(_DATA_FILE):
            raise FileNotFoundError(
                f"{_DATA_FILE} not found; generate it with scripts/build_aav_data.py"
            )
        with open(_DATA_FILE) as f:
            self.data = {
                int(pos): val
                for pos, val in json.load(f).items()
                if self.start <= int(pos) < self.end
            }

        self.top_seq, self.max_possible = self.compute_max_possible()

        # Dense [L, 20] fitness matrix; absent residues score 0, as the
        # reference's `if s in self.data[...]` skip does (:104).
        length = end - start
        matrix = np.zeros((length, len(AAS)), np.float32)
        for i in range(length):
            for aa, entry in self.data.get(self.start + i, {}).items():
                if aa in AAS:
                    matrix[i, AAS.index(aa)] = entry[self.phenotype]
        self._fitness_params = AAVFitnessParams(
            torch.as_tensor(matrix, device=self.device),
            torch.tensor(self.mfm * self.max_possible, dtype=torch.float32, device=self.device),
            torch.tensor(
                self.max_possible * (self.mfm + 1), dtype=torch.float32, device=self.device
            ),
        )

    def compute_max_possible(self):
        """Best viable residue per position (packaging > -6 cutoff)."""
        best_seq = ""
        max_fitness = 0.0
        for pos in self.data:
            current_max = -10.0
            current_best = "M"
            for aa in self.data[pos]:
                current_fit = self.data[pos][aa][self.phenotype]
                if current_fit > current_max and self.data[pos][aa]["log2_packaging_v_wt"] > -6:
                    current_best = aa
                    current_max = current_fit
            best_seq += current_best
            max_fitness += current_max
        return best_seq, max_fitness

    def fitness_from_tokens(self, tokens) -> torch.Tensor:
        """Noiseless f32[B] fitness of int[B, L] AA tokens, on the landscape's device."""
        return _aav_fitness(self._fitness_params, torch.as_tensor(tokens, device=self.device))

    def device_fitness(self):
        """(pure fitness fn, params) pair for the fused runner; params = `AAVFitnessParams`.

        Only for noiseless landscapes: the device path scores the
        deterministic additive model, and dropping the Gaussian `noise`
        silently would make a fused run measure another landscape than the
        host explorer does.
        """
        if self.noise:
            raise ValueError(
                "device_fitness() is noiseless; construct AdditiveAAVPackaging(noise=0) "
                "for fused runs or use the host get_fitness path"
            )
        return _aav_fitness, self._fitness_params

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        seqs = list(sequences)
        if not seqs:  # the reference returns an empty array for an empty batch
            return np.zeros(0, np.float64)
        tokens = torch.as_tensor(_AA.encode(seqs), device=self.device)
        base = _aav_fitness_unclipped(self._fitness_params, tokens).cpu().numpy()
        base = base.astype(np.float64)
        if self.noise:
            noise = torch.randn(len(seqs), generator=self._noise_gen, dtype=torch.float64)
            base = base + self.noise * noise.numpy()
        return np.maximum(base, 0.0)


def registry() -> Dict[str, Dict]:
    """Return problems (reference additive_aav_packaging.py:121-147)."""
    return {
        name: {"params": {"phenotype": name, "start": 450, "end": 540}}
        for name in ["heart", "lung", "kidney", "liver", "blood", "spleen"]
    }
