"""RNA duplex hybridization energy (ViennaRNA `duplexfold` rebuild), plain PyTorch.

The dynamic program:

    c[i, j] = best energy of a duplex in which sequence position i pairs
              target position j, extended from any previous pair (k < i,
              l < j on the reversed target) through a stack, bulge, or
              interior loop bounded by MAXLOOP unpaired bases.

Energy model: the Turner-style nearest-neighbour decomposition of
ViennaRNA's `E_IntLoop` (helix stacks, 1-bulges as stack-through, longer
bulges with terminal AU/GU, the joint 1x1 interior table, generic interior
loops with Ninio asymmetry and two mismatch terms, and the duplex-end
tables with an explicit "no neighbour" index).  The calibrated tables are
data, read in place from `flexs_tpu/landscapes/data/rna_duplex_params.npz`.

Every per-cell term depends on at most the sequence trigram
(s[i-2], s[i-1], s[i]) and target trigram (t[j-2], t[j-1], t[j]), or, for
the two forward-looking terms, on the bigrams (s[i], s[i+1]) x (t[j], t[j+1]).
`trigram_tables` enumerates those gram-pair tables once; `build_slabs`
expands them to per-cell slabs f32[B, L1, 9, L2] by index gathers (exact on
any device and under any TF32 setting); `_duplex_dp_slabs` runs the
min-plus recursion as a Python loop over rows, batched over sequences.

This is the plain version of the CUDA kernel in `ops/cuda_duplex.py`: the
kernel is held to it bit for bit, and the CPU tests run it.

`_duplex_dp` is the other form of the same recursion, as the JAX package's
`_duplex_dp`: per-cell index gathers inside the row loop, with JAX's
association (e.g. `(prev + bulge1) + stack`, where the slab path adds
`prev + (bulge1 + stack)`), so the two forms agree to rounding, not bitwise.
It is a reference, the CPU side of `make_duplex_fitness_fn` and a row of
`profile_duplex`; no path runs it on a card.
"""
import os

import numpy as np
import torch

from flexs_tpu_torch.device import resolve_device

# Token order follows RNAA = "UGCA": U=0, G=1, C=2, A=3.
_U, _G, _C, _A = 0, 1, 2, 3

# Pair types (ViennaRNA order): 0 = unpairable, 1=CG 2=GC 3=GU 4=UG 5=AU 6=UA.
PAIR_TABLE = np.zeros((4, 4), dtype=np.int32)
PAIR_TABLE[_C, _G] = 1
PAIR_TABLE[_G, _C] = 2
PAIR_TABLE[_G, _U] = 3
PAIR_TABLE[_U, _G] = 4
PAIR_TABLE[_A, _U] = 5
PAIR_TABLE[_U, _A] = 6

# Turner 2004 helix stacking dG37 (kcal/mol), indexed [pair_prev][pair_cur];
# row/col 0 (unpairable) = the finite sentinel _INF.
_INF = 1e6
STACK = np.full((7, 7), _INF, dtype=np.float32)
_stack_vals = [
    # CG     GC     GU     UG     AU     UA
    [-2.40, -3.30, -2.10, -1.40, -2.10, -2.10],  # CG
    [-3.30, -3.40, -2.50, -1.50, -2.20, -2.40],  # GC
    [-2.10, -2.50, +1.30, -0.50, -1.40, -1.30],  # GU
    [-1.40, -1.50, -0.50, -0.30, -0.60, -1.00],  # UG
    [-2.10, -2.20, -1.40, -0.60, -1.10, -0.90],  # AU
    [-2.10, -2.40, -1.30, -1.00, -0.90, -1.30],  # UA
]
STACK[1:, 1:] = np.array(_stack_vals, dtype=np.float32)

# AU/GU helix-end (weak pair) indicator per pair type.
WEAK_PAIR = np.array([0, 0, 0, 1, 1, 1, 1], dtype=np.float32)

# Size-dependent loop initiation penalties (kcal/mol), Turner-style with a
# logarithmic tail.  _BULGE indexed by bulge size, _INTERIOR by total
# unpaired count.
_BULGE = [_INF, 3.80, 2.80, 3.20, 3.60, 4.00, 4.40, 4.59, 4.70, 4.80, 4.90]
_INTERIOR = [_INF, _INF, 1.50, 1.60, 1.10, 2.00, 2.00, 2.10, 2.30, 2.40, 2.50]

# "No neighbouring base" index for the duplex-end tables (sequence edge).
NONE_BASE = 4

_DEFAULT_PARAMS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "flexs_tpu",
    "landscapes",
    "data",
    "rna_duplex_params.npz",
)


def _loop_tail(base_list, n_max):
    """Extend a loop-penalty list to n_max with 1.75*kT*ln(n/n0) growth."""
    vals = list(base_list)
    kt_175 = 1.75 * 0.616  # 1.75 * kT at 37C (kcal/mol)
    n0 = len(vals) - 1
    for n in range(len(vals), n_max + 1):
        vals.append(vals[n0] + kt_175 * np.log(n / n0))
    return np.array(vals, dtype=np.float32)


class DuplexParams:
    """Parameters of the duplex energy model (numpy, device-independent).

    Sequence-dependent tables (shapes mirror ViennaRNA's parameter file):
      stack   f32[7, 7]      helix stacking, also bridges 1-bulges
      mA      f32[7, 4, 4]   interior mismatch at the loop-opening pair
      mB      f32[7, 4, 4]   interior mismatch at the loop-closing pair
      int11   f32[7, 7, 4, 4] joint 1x1 interior-loop table
      ext5    f32[7, 5, 5]   duplex-start end term (pair, 5' nbr, 3' nbr)
      ext3    f32[7, 5, 5]   duplex-close end term; base index 4 = no nbr

    Size terms: bulge_sizes f32[maxloop+1] (by bulge length; [1] is the
    1-bulge cost used with the stack-through), interior_sizes
    f32[maxloop+1] (by total unpaired count), ninio asymmetry slope/cap.
    """

    def __init__(
        self,
        duplex_init: float = 4.10,
        terminal_au: float = 0.50,
        ninio: float = 0.60,
        ninio_max: float = 3.00,
        maxloop: int = 16,
        stack=None,
        mA=None,
        mB=None,
        int11=None,
        ext5=None,
        ext3=None,
        bulge_sizes=None,
        interior_sizes=None,
    ):
        self.duplex_init = duplex_init
        self.terminal_au = terminal_au
        self.ninio = ninio
        self.ninio_max = ninio_max
        self.maxloop = maxloop

        mm = -0.40  # default interior-mismatch contribution per side
        end = -0.45  # default per-end dangle/mismatch bonus

        def table(value, default):
            return np.asarray(value, np.float32) if value is not None else default

        self.stack = table(stack, STACK.copy())
        self.mA = table(mA, np.full((7, 4, 4), mm, np.float32))
        self.mB = table(mB, np.full((7, 4, 4), mm, np.float32))
        self.int11 = table(
            int11, np.full((7, 7, 4, 4), _INTERIOR[2] + 2 * mm, np.float32)
        )
        end_default = np.broadcast_to(
            (self.terminal_au * WEAK_PAIR + end)[:, None, None], (7, 5, 5)
        )
        self.ext5 = table(ext5, end_default.copy())
        self.ext3 = table(ext3, end_default.copy())
        self.bulge_sizes = table(
            bulge_sizes, _loop_tail(_BULGE, maxloop)[: maxloop + 1]
        )
        self.interior_sizes = table(
            interior_sizes, _loop_tail(_INTERIOR, maxloop)[: maxloop + 1]
        )
        self._em_cache = {}

    _calibrated_cache = {}

    @classmethod
    def calibrated(cls, path: str = None) -> "DuplexParams":
        """The calibrated parameter set (defaults if the file is missing).

        Returns a shared per-path instance so every landscape reuses one
        set of energy tables per device (see `energy_model`).
        """
        if path not in cls._calibrated_cache:
            cls._calibrated_cache[path] = cls._load_calibrated(path)
        return cls._calibrated_cache[path]

    @classmethod
    def _load_calibrated(cls, path: str = None) -> "DuplexParams":
        path = path or _DEFAULT_PARAMS_PATH
        if not os.path.exists(path):
            return cls()
        with np.load(path) as data:
            if "mA" not in data:  # older parameter file: scalars + stack only
                return cls(
                    duplex_init=float(data["duplex_init"]),
                    terminal_au=float(data["terminal_au"]),
                    ninio=float(data["ninio"]),
                    maxloop=int(data["maxloop"]),
                    stack=data["stack"],
                )
            return cls(
                duplex_init=float(data["duplex_init"]),
                terminal_au=float(data["terminal_au"]),
                ninio=float(data["ninio"]),
                ninio_max=float(data["ninio_max"]),
                maxloop=int(data["maxloop"]),
                stack=data["stack"],
                mA=data["mA"],
                mB=data["mB"],
                int11=data["int11"],
                ext5=data["ext5"],
                ext3=data["ext3"],
                bulge_sizes=data["bulge_sizes"],
                interior_sizes=data["interior_sizes"],
            )

    def interior_cost_matrix(self) -> np.ndarray:
        """Dense generic-interior extension cost: [di, dj] for di,dj >= 2.

        Entry [di, dj] covers (di-1, dj-1) unpaired bases on the two
        strands; the 1x1 case [2, 2] is _INF here (handled by the joint
        int11 table), as is anything beyond maxloop total.
        """
        d = self.maxloop + 2
        cost = np.full((d, d), np.float32(_INF))
        for di in range(2, d):
            for dj in range(2, d):
                n1, n2 = di - 1, dj - 1
                if n1 + n2 > self.maxloop or (n1 == 1 and n2 == 1):
                    continue
                cost[di, dj] = self.interior_sizes[n1 + n2] + min(
                    self.ninio_max, self.ninio * abs(n1 - n2)
                )
        return cost

    def bulge_cost_vectors(self):
        """(bulge_seq f32[maxloop+1], bulge_tgt f32[maxloop+2]).

        bulge_seq[r]: cost of a bulge of r >= 2 unpaired sequence bases
        (window row index r); bulge_tgt[dj]: cost of dj-1 >= 2 unpaired
        target bases (column shift dj).  1-bulges are _INF here: they take
        the stack-through path.
        """
        d = self.maxloop + 2
        bulge_seq = np.full(d - 1, np.float32(_INF))
        bulge_tgt = np.full(d, np.float32(_INF))
        for r in range(2, self.maxloop + 1):
            bulge_seq[r] = self.bulge_sizes[r]
        for dj in range(3, self.maxloop + 2):
            bulge_tgt[dj] = self.bulge_sizes[dj - 1]
        return bulge_seq, bulge_tgt

    def energy_model_numpy(self) -> dict:
        """The energy model as a dict of float32 numpy arrays."""
        bulge_seq, bulge_tgt = self.bulge_cost_vectors()
        return {
            "stack": self.stack,
            "mA": self.mA,
            "mB": self.mB,
            "int11": self.int11,
            "ext5": self.ext5,
            "ext3": self.ext3,
            "interior_cost": self.interior_cost_matrix(),
            "bulge_seq": bulge_seq,
            "bulge_tgt": bulge_tgt,
            "consts": np.array(
                [self.duplex_init, self.terminal_au, self.bulge_sizes[1], 0.0],
                np.float32,
            ),
        }

    def energy_model(self, device) -> dict:
        """The energy model as a dict of tensors on `device` (cached per device).

        Treat the params as frozen after construction.
        """
        key = str(torch.device(device))
        if key not in self._em_cache:
            self._em_cache[key] = energy_model_from_numpy(
                self.energy_model_numpy(), device
            )
        return self._em_cache[key]


def energy_model_from_numpy(em: dict, device) -> dict:
    """A dict of numpy arrays (same keys as `energy_model`) as f32 tensors."""
    return {
        k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
        for k, v in em.items()
    }


DEFAULT_PARAMS = DuplexParams()

# Slab channel indices (shared with ops/cuda_duplex.py's kernel).
OPEN, STACKC, B1S, B1T, I11, MB, MA, AU, CLOSE = range(9)
N_SLABS = 9
_PAST = (OPEN, STACKC, B1S, B1T, I11, MB, AU)  # trigram-indexed channels
_FUT = (MA, CLOSE)  # forward-bigram-indexed channels
# Permutation from concat([past, future]) order to channel order.
_CHANNEL_PERM = np.argsort(np.array(_PAST + _FUT))


def _pair_table(device) -> torch.Tensor:
    return torch.as_tensor(PAIR_TABLE, dtype=torch.int64, device=device)


def trigram_tables(em):
    """Per-channel gram-pair energy tables from the energy model.

    Returns (t_past f32[7, 64, 64], t_fut f32[2, 16, 16]), channels in
    `_PAST` and `_FUT` order.  Gram index conventions: clipped sequence
    neighbours, wrapped (rolled) target neighbours; boundary garbage is
    masked by the DP's window/shift sentinel structure, except the
    duplex-end terms, which `boundary_patches` replaces.
    """
    duplex_init, terminal_au, bulge1 = em["consts"][0], em["consts"][1], em["consts"][2]
    dev = em["consts"].device
    pair_tbl = _pair_table(dev)
    weak = torch.as_tensor(WEAK_PAIR, device=dev)

    g = torch.arange(64, device=dev)
    sm2, sm1, s0 = g // 16, (g // 4) % 4, g % 4
    tm2, tm1, t0 = sm2, sm1, s0  # same decomposition over the target axis
    rows, cols = (slice(None), None), (None, slice(None))

    pt = pair_tbl[s0[rows], t0[cols]]
    pt_m1 = pair_tbl[sm1[rows], tm1[cols]]
    pt_m2m1 = pair_tbl[sm2[rows], tm1[cols]]
    pt_m1m2 = pair_tbl[sm1[rows], tm2[cols]]
    pt_m2 = pair_tbl[sm2[rows], tm2[cols]]

    open_t = torch.where(
        pt > 0, duplex_init + em["ext5"][pt, sm1[rows], tm1[cols]], _INF
    )
    stack_t = em["stack"][pt_m1, pt]
    b1s_t = bulge1 + em["stack"][pt_m2m1, pt]
    b1t_t = bulge1 + em["stack"][pt_m1m2, pt]
    i11_t = em["int11"][pt_m2, pt, sm1[rows], tm1[cols]]
    mb_t = em["mB"][pt, sm1[rows], tm1[cols]]
    au_t = terminal_au * weak[pt]
    t_past = torch.stack([open_t, stack_t, b1s_t, b1t_t, i11_t, mb_t, au_t])

    gf = torch.arange(16, device=dev)
    s0f, sp1 = gf // 4, gf % 4
    t0f, tp1 = s0f, sp1
    ptf = pair_tbl[s0f[rows], t0f[cols]]
    ma_t = em["mA"][ptf, sp1[rows], tp1[cols]]
    close_t = em["ext3"][ptf, sp1[rows], tp1[cols]]
    t_fut = torch.stack([ma_t, close_t])
    return t_past, t_fut


def _seq_neighbours(seq_tokens):
    """(s, s[i-1], s[i-2], s[i+1]) with clipped indices, all int64[B, L1]."""
    s = seq_tokens.long()
    l1 = s.shape[1]
    i_idx = torch.arange(l1, device=s.device)
    s_im1 = s[:, (i_idx - 1).clamp(min=0)]
    s_im2 = s[:, (i_idx - 2).clamp(min=0)]
    s_ip1 = s[:, (i_idx + 1).clamp(max=l1 - 1)]
    return s, s_im1, s_im2, s_ip1


def seq_grams(seq_tokens):
    """(trigram index s3g, forward-bigram index s2g), int64[B, L1]."""
    s, s_im1, s_im2, s_ip1 = _seq_neighbours(seq_tokens)
    return s_im2 * 16 + s_im1 * 4 + s, s * 4 + s_ip1


def target_grams(target_rev):
    """(trigram index t3g, forward-bigram index t2g), int64[L2], wrapped."""
    t = target_rev.long()
    t3g = torch.roll(t, 2) * 16 + torch.roll(t, 1) * 4 + t
    t2g = t * 4 + torch.roll(t, -1)
    return t3g, t2g


def boundary_patches(seq_tokens, target_rev, em):
    """Duplex-end energies that replace the gram tables at the edges.

    Returns (open_row0 f32[B, L2], open_col0 f32[B, L1],
    close_rowl f32[B, L2], close_coll f32[B, L1]): the OPEN channel of DP
    row 0 and column 0 and the CLOSE channel of row L1-1 and column L2-1,
    where "no neighbouring base" (NONE_BASE) replaces the clipped or
    wrapped neighbour.  The row patches' corner entries equal the column
    patches' (patch order: row, then column, then corner).
    """
    s, s_im1, _, s_ip1 = _seq_neighbours(seq_tokens)
    b, l1 = s.shape
    trev = target_rev.long()
    l2 = trev.shape[0]
    dev = s.device
    pair_tbl = _pair_table(dev)
    duplex_init = em["consts"][0]
    none = NONE_BASE
    i_idx = torch.arange(l1, device=dev)
    j_idx = torch.arange(l2, device=dev)
    b3 = torch.where(j_idx > 0, torch.roll(trev, 1), none).expand(b, l2)
    a5 = torch.where(j_idx < l2 - 1, torch.roll(trev, -1), none).expand(b, l2)
    b5 = torch.where(i_idx > 0, s_im1, none)
    a3 = torch.where(i_idx < l1 - 1, s_ip1, none)

    pt_row0 = pair_tbl[s[:, :1], trev[None, :]]  # [B, L2]
    open_row0 = torch.where(
        pt_row0 > 0, duplex_init + em["ext5"][pt_row0, none, b3], _INF
    )
    pt_col0 = pair_tbl[s, trev[0]]  # [B, L1]
    open_col0 = torch.where(
        pt_col0 > 0, duplex_init + em["ext5"][pt_col0, b5, none], _INF
    )
    open_row0[:, 0] = open_col0[:, 0]

    pt_rowl = pair_tbl[s[:, l1 - 1 :], trev[None, :]]
    close_rowl = em["ext3"][pt_rowl, none, a5]
    pt_coll = pair_tbl[s, trev[l2 - 1]]
    close_coll = em["ext3"][pt_coll, a3, none]
    close_rowl[:, l2 - 1] = close_coll[:, l1 - 1]
    return open_row0, open_col0, close_rowl, close_coll


def build_slabs(seq_tokens, target_rev, em):
    """Per-cell energy slabs f32[B, L1, 9, L2] by exact index gathers."""
    t_past, t_fut = trigram_tables(em)
    s3g, s2g = seq_grams(seq_tokens)
    t3g, t2g = target_grams(target_rev)
    past = t_past[:, :, t3g][:, s3g]  # [7, 64, L2] -> [7, B, L1, L2]
    fut = t_fut[:, :, t2g][:, s2g]  # [2, B, L1, L2]
    perm = torch.as_tensor(_CHANNEL_PERM, device=past.device)
    slabs = torch.cat([past, fut])[perm].permute(1, 2, 0, 3).contiguous()

    open_row0, open_col0, close_rowl, close_coll = boundary_patches(
        seq_tokens, target_rev, em
    )
    slabs[:, 0, OPEN, :] = open_row0
    slabs[:, :, OPEN, 0] = open_col0
    slabs[:, -1, CLOSE, :] = close_rowl
    slabs[:, :, CLOSE, -1] = close_coll
    return slabs


def _shift(x, k):
    """`x` moved right by k along the last axis; vacated columns = _INF."""
    if k == 0:
        return x
    n = x.shape[-1]
    fill = x.new_full(x.shape[:-1] + (min(k, n),), _INF)
    return torch.cat([fill, x[..., : n - k]], dim=-1) if k < n else fill


def _duplex_dp_batch(seq_tokens, target_rev_tokens, em, maxloop: int):
    """Min duplex energies f32[B] of int[B, L1] sequences vs one reversed target.

    The gather form: JAX's `_duplex_dp` with its batch axis written out
    (JAX vmaps it).  Each row gathers its pair types and table entries per
    cell; the adds keep JAX's association and order.
    """
    duplex_init, terminal_au, bulge1 = em["consts"][0], em["consts"][1], em["consts"][2]
    d = maxloop + 2
    s = seq_tokens.long()
    b, l1 = s.shape
    trev = target_rev_tokens.long()
    l2 = trev.shape[0]
    dev = s.device
    pair_tbl = _pair_table(dev)
    weak = torch.as_tensor(WEAK_PAIR, device=dev)

    j_idx = torch.arange(l2, device=dev)
    trev_m1 = torch.roll(trev, 1)  # trev[j-1] (wrapped; masked where used)
    trev_p1 = torch.roll(trev, -1)  # trev[j+1]
    b3_open = torch.where(j_idx > 0, trev_m1, NONE_BASE)[None, :]
    a5_close = torch.where(j_idx < l2 - 1, trev_p1, NONE_BASE)[None, :]
    trev_m1, trev_p1 = trev_m1[None, :], trev_p1[None, :]
    none = torch.full((b, 1), NONE_BASE, dtype=torch.int64, device=dev)

    win_c = torch.full((b, d - 1, l2), _INF, dtype=torch.float32, device=dev)
    win_ca = win_c.clone()
    win_cw = win_c.clone()
    best = torch.full((b,), _INF, dtype=torch.float32, device=dev)
    icost = em["interior_cost"][2:, 2:].T[:, :, None]  # [dj - 2, r - 1, 1]

    for i in range(l1):
        s_i = s[:, i : i + 1]  # [B, 1]
        s_im1 = s[:, max(i - 1, 0)][:, None]
        s_im2 = s[:, max(i - 2, 0)][:, None]
        s_ip1 = s[:, min(i + 1, l1 - 1)][:, None]

        ptype = pair_tbl[s_i, trev]  # [B, L2]
        ptype_m1 = pair_tbl[s_im1, trev]
        ptype_m2 = pair_tbl[s_im2, trev]
        pairable = ptype > 0
        au_cur = terminal_au * weak[ptype]

        b5 = s_im1 if i > 0 else none
        open_e = duplex_init + em["ext5"][ptype, b5, b3_open]
        stack_e = _shift(win_c[:, 0], 1) + em["stack"][torch.roll(ptype_m1, 1, -1), ptype]
        b1_seq = (
            _shift(win_c[:, 1], 1) + bulge1 + em["stack"][torch.roll(ptype_m2, 1, -1), ptype]
        )
        b1_tgt = (
            _shift(win_c[:, 0], 2) + bulge1 + em["stack"][torch.roll(ptype_m1, 2, -1), ptype]
        )
        i11 = _shift(win_c[:, 1], 2) + em["int11"][
            torch.roll(ptype_m2, 2, -1), ptype, s_im1, trev_m1
        ]
        rolled = torch.stack([_shift(win_ca[:, 1:], dj) for dj in range(2, d)], 1)
        loop_e = (rolled + icost).amin(dim=(1, 2)) + em["mB"][ptype, s_im1, trev_m1]
        blg_seq = (_shift(win_cw, 1) + em["bulge_seq"][:, None]).amin(dim=1) + au_cur
        blg_tgt = (
            torch.stack([_shift(win_cw[:, 0], dj) for dj in range(3, d)], 1)
            + em["bulge_tgt"][3:, None]
        ).amin(dim=1) + au_cur

        c_row = torch.minimum(
            torch.minimum(torch.minimum(open_e, stack_e), torch.minimum(b1_seq, b1_tgt)),
            torch.minimum(torch.minimum(i11, loop_e), torch.minimum(blg_seq, blg_tgt)),
        )
        c_row = torch.where(pairable, c_row, _INF)

        a3 = s_ip1 if i < l1 - 1 else none
        close_e = c_row + em["ext3"][ptype, a3, a5_close]
        best = torch.minimum(best, close_e.amin(dim=1))

        a_row = em["mA"][ptype, s_ip1, trev_p1]
        win_c = torch.cat([c_row[:, None], win_c[:, :-1]], 1)
        win_ca = torch.cat([(c_row + a_row)[:, None], win_ca[:, :-1]], 1)
        win_cw = torch.cat([(c_row + au_cur)[:, None], win_cw[:, :-1]], 1)
    # No pairable positions at all => energy 0 (no duplex forms).
    return torch.where(best >= _INF / 2, 0.0, best)


def _duplex_dp(seq_tokens, target_rev_tokens, em, maxloop: int):
    """Min duplex energy (0-d f32) of one int[L1] sequence vs one reversed target."""
    return _duplex_dp_batch(seq_tokens[None], target_rev_tokens, em, maxloop)[0]


def _duplex_dp_slabs(slabs, interior_cost, bulge_seq, bulge_tgt, maxloop: int):
    """Min duplex energies f32[B] from per-cell slabs f32[B, L1, 9, L2].

    Window row r of each channel holds DP row i-1-r.  The additions keep
    the association the kernel must reproduce: interior candidates are
    `win_ca + interior_cost`, min-reduced, then `+ MB`; bulge candidates
    are min-reduced, then `+ AU`.
    """
    d = maxloop + 2
    b, l1, _, l2 = slabs.shape
    win_c = slabs.new_full((b, d - 1, l2), _INF)
    win_ca = win_c.clone()
    win_cw = win_c.clone()
    best = slabs.new_full((b,), _INF)
    icost = interior_cost[2:, 2:].T[:, :, None]  # [dj - 2, r - 1, 1]
    btgt = bulge_tgt[3:, None]
    bseq = bulge_seq[:, None]

    for i in range(l1):
        row = slabs[:, i]
        open_e = row[:, OPEN]
        au_e = row[:, AU]

        acc = torch.minimum(open_e, _shift(win_c[:, 0], 1) + row[:, STACKC])
        acc = torch.minimum(acc, _shift(win_c[:, 1], 1) + row[:, B1S])
        acc = torch.minimum(acc, _shift(win_c[:, 0], 2) + row[:, B1T])
        acc = torch.minimum(acc, _shift(win_c[:, 1], 2) + row[:, I11])

        rolled = torch.stack([_shift(win_ca[:, 1:], dj) for dj in range(2, d)], 1)
        acc = torch.minimum(acc, (rolled + icost).amin(dim=(1, 2)) + row[:, MB])

        blg_s = (_shift(win_cw, 1) + bseq).amin(dim=1)
        blg_t = (
            torch.stack([_shift(win_cw[:, 0], dj) for dj in range(3, d)], 1) + btgt
        ).amin(dim=1)
        acc = torch.minimum(acc, torch.minimum(blg_s, blg_t) + au_e)

        acc = torch.where(open_e >= _INF / 2, _INF, acc)
        best = torch.minimum(best, (acc + row[:, CLOSE]).amin(dim=1))

        win_c = torch.cat([acc[:, None], win_c[:, :-1]], 1)
        win_ca = torch.cat([(acc + row[:, MA])[:, None], win_ca[:, :-1]], 1)
        win_cw = torch.cat([(acc + au_e)[:, None], win_cw[:, :-1]], 1)
    # No pairable positions at all => energy 0 (no duplex forms).
    return torch.where(best >= _INF / 2, 0.0, best)


def duplex_energy_from_slabs(seq_tokens, target_rev, em, maxloop: int):
    """Duplex energies f32[B] of int[B, L1] sequences vs one reversed target."""
    slabs = build_slabs(seq_tokens, target_rev, em)
    return _duplex_dp_slabs(
        slabs, em["interior_cost"], em["bulge_seq"], em["bulge_tgt"], maxloop
    )


def duplex_energy_batch(
    seq_tokens, target_tokens, params: DuplexParams = None, device=None
):
    """Duplex energies (kcal/mol) of int[B, L1] sequences vs one target.

    `target_tokens` is int[L2] in 5'->3' orientation; it is reversed here so
    the DP scans both strands in increasing index order.  Runs on `device`
    (default "cuda"): on a card the CUDA kernel, on the CPU the plain slab
    DP, which the kernel equals bit for bit.
    """
    params = params or DEFAULT_PARAMS
    dev = resolve_device(device)
    seq = torch.as_tensor(seq_tokens, device=dev)
    target_rev = torch.as_tensor(target_tokens, device=dev).flip(0)
    em = params.energy_model(dev)
    if dev.type == "cuda":
        from flexs_tpu_torch.ops import cuda_duplex  # it imports this module

        return cuda_duplex.duplex_energies(seq, target_rev[None], em, params.maxloop)[:, 0]
    return duplex_energy_from_slabs(seq, target_rev, em, params.maxloop)


def pack_duplex_params(target_tokens, params: DuplexParams = None, device=None):
    """(reversed target, energy model) on `device` for `make_duplex_fitness_fn`."""
    params = params or DEFAULT_PARAMS
    dev = resolve_device(device)
    target_rev = torch.as_tensor(target_tokens, dtype=torch.int64, device=dev).flip(0)
    return target_rev, params.energy_model(dev)


def make_duplex_fitness_fn(maxloop: int = 16):
    """Pure `(params, tokens) -> energies f32[B]`, params from `pack_duplex_params`.

    Params on a card launch the CUDA kernel (one target); params on the CPU
    run the gather-form `_duplex_dp_batch`.  The card never runs the plain
    version through this function.
    """

    def fitness_fn(p, tokens):
        target_rev, em = p
        dev = target_rev.device
        tokens = torch.as_tensor(tokens, device=dev)
        if dev.type == "cuda":
            from flexs_tpu_torch.ops import cuda_duplex  # it imports this module

            return cuda_duplex.duplex_energies(tokens, target_rev[None], em, maxloop)[:, 0]
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return _duplex_dp_batch(tokens, target_rev, em, maxloop)

    return fitness_fn
