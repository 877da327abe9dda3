"""Single-strand RNA MFE folding: the Turner-structured Zuker DP, plain PyTorch.

The energy model is the JAX package's (`flexs_tpu/ops/rna_fold.py`, whose
docstring gives the Turner terms in full):

  * V(i, j), the best structure closed by pair (i, j): a hairpin (the
    Turner 2004 size curve with its 1.75*kT*ln tail, the closing mismatch,
    and the tetraloop / triloop family bonuses), a two-loop over interior
    windows (d1, d2) with d1 + d2 <= maxloop (stack; bulges, 1-bulges
    stacking through; the joint 1x1 table; generic interiors with the size
    curve, Ninio asymmetry and two mismatches), or a multiloop (affine
    closure a + b + terminal AU + the dangles=2 closing mismatch, split
    into two fML segments);
  * fML(i, j), a multiloop segment with >= 1 branch, by last-branch
    decomposition (unpaired cost c, branch cost b + AU + mismatch);
  * W(j), the exterior loop, with the dangles=2 mismatch on every branch
    (base-averaged one-sided dangles at the sequence ends).

The sequence-dependent tables come from the calibrated duplex model
(`ops/rna_duplex.py`); the fold-only terms are public Turner values.

Layout.  One batched function runs over int64[B, L]: a Python loop over
spans s fills V and fML a whole diagonal at a time, and a second loop over
positions fills W.  V and fML are kept in a diagonal layout,
`Xd[b, s, i] = X(i, i + s)`, and every per-sequence energy table is built
once per call in that layout by indexing the small [<=64, <=64] contraction
matrices of `_contraction_mats` with each position's base k-mer (the JAX
package reaches the same entries by one-hot products at HIGHEST precision,
which select exactly one entry each, so the values are equal).  A span step
reads every term it needs with one `index_select` per family of reads:
the interior windows' inner V, inner mismatch and outer-pair terms in one,
the multiloop's right segments in one, the last branch's V and branch terms
in one.  Each step computes only the windows whose inner pair is long
enough (`inner_ok` in the JAX package) and only the L - s positions whose
pair lies inside the sequence.

Numbers.  Every f32 sum adds its terms in the JAX package's order (e.g.
`(interior + mmA) + mmB + V`, `bulge + (AU + AU') + V`,
`(((a + b) + AU) + mismatch) + split`), and mins are exact, so the MFE of
every structure is the JAX package's to the bit.  Entries that involve the
finite sentinel `_INF` = 1e6 (impossible pairs and loops) saturate near it
and never reach a result, which is clamped at 0; their exact values may
differ from the JAX package's, which also mins over windows and spans that
this port skips.

The cost-centre knockouts of the JAX package's profiler (a module global
there, read at trace time) are the `knockout` argument here.
"""
from functools import lru_cache

import numpy as np
import torch

from flexs_tpu_torch.alphabet import RNAA, Alphabet
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.ops import rna_duplex

_INF = np.float32(1e6)

# Cost centres `zuker_mfe_batch(knockout=...)` can leave out, for profiling
# by deletion (`profile_fold.py`); None folds with the whole model.
KNOCKOUTS = (None, "hairpin_special", "interior", "multiloop", "lastbranch")

# Turner 2004 hairpin-loop initiation dG37 (kcal/mol) by loop size; sizes
# 0-2 are sterically impossible.  Extended past 30 with the standard
# 1.75*kT*ln(n/30) tail at model build time.
HAIRPIN_INIT = [
    _INF, _INF, _INF,
    5.40, 5.60, 5.70, 5.40, 6.00, 5.50, 6.40, 6.50, 6.60, 6.70, 6.78,
    6.86, 6.94, 7.01, 7.07, 7.13, 7.19, 7.25, 7.30, 7.35, 7.40, 7.44,
    7.49, 7.53, 7.57, 7.61, 7.65, 7.69,
]

# Turner multiloop affine model (ViennaRNA defaults, dG37 kcal/mol):
# closing penalty, per-branch penalty, per-unpaired-base penalty.
ML_CLOSING = 3.40
ML_BRANCH = 0.40
ML_UNPAIRED = 0.00

# Pair-type reversal: (i,j) seen as (j,i).  CG<->GC, GU<->UG, AU<->UA.
_REV_PT = np.array([0, 2, 1, 4, 3, 6, 5], dtype=np.int64)

_MAX_HAIRPIN_TABLE = 512

# Special-hairpin stabilization (dG37 kcal/mol, ADDED to the generic
# hairpin energy) for the published unusually-stable loop families, as
# family-level consensus magnitudes (UNCG ~2.5 and GNRA/CUUG ~2 kcal/mol).
_TETRALOOP_FAMILIES = [
    # (hexamer pattern: 5' closing base, 4 loop bases, 3' closing base)
    ("C U N C G G", -2.5),  # UNCG family, C-G closed (UUCG et al.)
    ("P G N R A Q", -2.0),  # GNRA family, any canonical closing pair
    ("C C U U G G", -2.0),  # CUUG, C-G closed
]
# Turner-2004 carries exactly two special triloops (total energies 6.8 /
# 6.9 vs the generic 5.4 size-3 initiation): destabilizing corrections.
_TRILOOP_BONUS = {"CAACG": 1.4, "GUUAC": 1.5}

_CANONICAL_PAIRS = [
    ("C", "G"), ("G", "C"), ("G", "U"), ("U", "G"), ("A", "U"), ("U", "A"),
]

# Channels of the per-call table tensor: V, the inner-pair tables, a zero
# channel (windows with no inner-mismatch term read it), then the outer-pair
# tables in `_OUTER` order.
_V, _AU_IN, _MMB, _MMBR, _ZERO = range(5)
_OUTER = ("ptpos", "au", "mmA", "mmclose", "stack00", "stack_b10", "stack_b01", "e11")
_OUT0 = 5
_N_CHANNELS = _OUT0 + len(_OUTER)


def _out(name: str) -> int:
    return _OUT0 + _OUTER.index(name)


def _special_hairpin_tables():
    """(tetra f32[4096], tri f32[1024]) content-addressed bonus tables.

    Index = base-4 integer of the closing-5' base, the loop bases, then
    the closing-3' base, in token order (RNAA alphabet).
    """
    rna = Alphabet(RNAA)

    def code(s):
        idx = 0
        for tok in rna.encode_one(s):
            idx = idx * 4 + int(tok)
        return idx

    tetra = np.zeros(4096, dtype=np.float32)
    for pattern, bonus in _TETRALOOP_FAMILIES:
        expansions = [""]
        for s in pattern.split():
            if s == "N":
                expansions = [e + b for e in expansions for b in "ACGU"]
            elif s == "R":
                expansions = [e + b for e in expansions for b in "AG"]
            else:
                expansions = [e + s for e in expansions]
        for e in expansions:
            if "P" in e:  # any canonical closing pair
                for p5, p3 in _CANONICAL_PAIRS:
                    tetra[code(e.replace("P", p5).replace("Q", p3))] = bonus
            else:
                tetra[code(e)] = bonus
    tri = np.zeros(1024, dtype=np.float32)
    for s, bonus in _TRILOOP_BONUS.items():
        tri[code(s)] = bonus
    return tetra, tri


def fold_energy_model(params: "rna_duplex.DuplexParams" = None, device=None) -> dict:
    """The fold's energy tables as f32 tensors on `device` (default "cuda"), cached.

    Reuses the calibrated duplex tables for every term with a duplex
    analog and adds the fold-only hairpin curve and multiloop constants.
    Treat the params as frozen after the first call.
    """
    params = params or rna_duplex.DuplexParams.calibrated()
    device = resolve_device(device)
    cache = params.__dict__.setdefault("_fold_em_cache", {})
    key = str(device)
    if key not in cache:
        tetra, tri = _special_hairpin_tables()
        # One-sided dangle fallbacks for sequence-boundary exterior
        # branches: the two-sided mismatch with the missing base averaged
        # out.  mA is indexed [pt, 5'-adjacent, 3'-adjacent]; d5 averages
        # the 3' slot, d3 the 5' slot.
        mA = np.asarray(params.mA)
        tables = {
            "tetra": tetra,
            "tri": tri,
            "mA_d5": mA.mean(axis=2),
            "mA_d3": mA.mean(axis=1),
            "stack": params.stack,
            "mA": params.mA,
            "mB": params.mB,
            "int11": params.int11,
            "interior_cost": params.interior_cost_matrix(),
            "bulge_sizes": params.bulge_sizes,
            "hairpin_sizes": rna_duplex._loop_tail(HAIRPIN_INIT, _MAX_HAIRPIN_TABLE),
            "consts": np.array(
                [ML_CLOSING, ML_BRANCH, ML_UNPAIRED, params.terminal_au], np.float32
            ),
        }
        cache[key] = rna_duplex.energy_model_from_numpy(tables, device)
    return cache[key]


def _interior_windows(maxloop: int) -> np.ndarray:
    """(d1, d2) interior-window offsets with d1 + d2 <= maxloop, int64[P, 2].

    d1/d2 = unpaired bases on the 5'/3' side between closing pair (i, j)
    and inner pair (i + d1 + 1, j - d2 - 1).  (0, 0) is the helix stack.
    """
    wins = [
        (d1, d2)
        for d1 in range(maxloop + 1)
        for d2 in range(maxloop + 1)
        if d1 + d2 <= maxloop
    ]
    return np.array(wins, dtype=np.int64)


def _contraction_mats(em) -> dict:
    """[left key, right key] energy matrices, one per sequence-dependent term.

    Left keys pack consecutive bases at the 5' position (i or k), right
    keys at the 3' position (j or l); each entry is the energy a per-pair
    lookup would give for that base combination.
    """
    dev = em["consts"].device
    PT = torch.as_tensor(rna_duplex.PAIR_TABLE, dtype=torch.int64, device=dev)
    REV = torch.as_tensor(_REV_PT, device=dev)
    weak = torch.as_tensor(rna_duplex.WEAK_PAIR, device=dev)
    term_au = em["consts"][3]

    l2 = torch.arange(16, device=dev)
    x2, a2 = l2[:, None] // 4, l2[:, None] % 4  # left: t[i]*4 + t[i+1]
    b2, y2 = l2[None, :] // 4, l2[None, :] % 4  # right: t[j-1]*4 + t[j]
    m2, xk = l2[:, None] // 4, l2[:, None] % 4  # left: t[k-1]*4 + t[k]
    yl, n2 = l2[None, :] // 4, l2[None, :] % 4  # right: t[l]*4 + t[l+1]
    l3 = torch.arange(64, device=dev)
    x3, a3, c3 = l3[:, None] // 16, (l3[:, None] // 4) % 4, l3[:, None] % 4
    d3_, e3_, y3 = l3[None, :] // 16, (l3[None, :] // 4) % 4, l3[None, :] % 4
    l1 = torch.arange(4, device=dev)

    stack_pp = em["stack"][PT[x2, y2], PT[a2, b2]]
    return {
        # outer-pair terms T(i, j): left bases around i, right around j
        "ptpos": (PT > 0).float(),
        "au": term_au * weak[PT],
        "mmA": em["mA"][PT[x2, y2], a2, b2],
        "mmclose": em["mA"][REV[PT[x2, y2]], b2, a2],
        "stack00": stack_pp,
        "stack_b10": stack_pp,  # left packs t[i], t[i+2]
        "stack_b01": stack_pp,  # right packs t[j-2], t[j]
        # e11(i,j) = int11[pt(i,j), rev(pt(i+2,j-2)), t[i+1], t[j-1]]
        "e11": em["int11"][PT[x3, y3], REV[PT[c3, d3_]], a3, e3_],
        # inner-pair / branch terms T(k, l)
        "mmB": em["mB"][REV[PT[xk, yl]], n2, m2],
        "mmbr": em["mA"][REV[PT[xk, yl]], n2, m2],
        # exterior-loop boundary dangles
        "d5": em["mA_d5"][REV[PT[l1[:, None], yl]], n2],
        "d3": em["mA_d3"][REV[PT[xk, l1[None, :]]], m2],
    }


def _keys(tokens):
    """Each position's base k-mer keys, int64[B, L]; neighbours wrap mod L."""
    t = tokens

    def at(k):
        return torch.roll(t, -k, dims=1)  # t[(i + k) % L]

    return {
        "oh": t,
        "p1": t * 4 + at(1),  # t[i]*4 + t[i+1]
        "p2": t * 4 + at(2),  # t[i]*4 + t[i+2]
        "m1": at(-1) * 4 + t,  # t[i-1]*4 + t[i]
        "m2": at(-2) * 4 + t,  # t[i-2]*4 + t[i]
        "l3": t * 16 + at(1) * 4 + at(2),
        "r3": at(-2) * 16 + at(-1) * 4 + t,
    }


# (matrix, left key, right key) of each table, by channel.
_TABLE_KEYS = {
    "ptpos": ("ptpos", "oh", "oh"),
    "au": ("au", "oh", "oh"),
    "mmA": ("mmA", "p1", "m1"),
    "mmclose": ("mmclose", "p1", "m1"),
    "stack00": ("stack00", "p1", "m1"),
    "stack_b10": ("stack_b10", "p2", "m1"),
    "stack_b01": ("stack_b01", "p1", "m2"),
    "e11": ("e11", "l3", "r3"),
    "au_in": ("au", "oh", "oh"),
    "mmB": ("mmB", "m1", "p1"),
    "mmbr": ("mmbr", "m1", "p1"),
}


def _fold_seq_tables(tokens, em):
    """Per-sequence energy tables of one call.

    Returns (X f32[B, 13, L, L], AUX f32[L, L, B], MMX f32[L, L, B],
    tetra_row f32[B, L], tri_row f32[B, L]).  X is in the diagonal layout
    X[b, c, s, i] = T_c(i, (i + s) % L), channels as `_V`.. `_OUTER` with V
    set to the sentinel; AUX and MMX are the exterior loop's terminal-AU
    and mismatch of branch (i, j), stored [j, i, b] for the W loop.
    """
    b, length = tokens.shape
    dev = tokens.device
    C = _contraction_mats(em)
    keys = _keys(tokens)
    pos = torch.arange(length, device=dev)
    right_at = (pos[None, :] + pos[:, None]) % length  # [s, i] -> (i + s) % L

    def diag(name):
        mat, left, right = _TABLE_KEYS[name]
        return C[mat][keys[left][:, None, :], keys[right][:, right_at]]

    X = torch.empty((b, _N_CHANNELS, length, length), device=dev)
    X[:, _V] = float(_INF)
    X[:, _ZERO] = 0.0
    for ch, name in ((_AU_IN, "au_in"), (_MMB, "mmB"), (_MMBR, "mmbr")):
        X[:, ch] = diag(name)
    for name in _OUTER:
        X[:, _out(name)] = diag(name)

    def std(mat, left, right):  # [j, i, b] = C[left key(i), right key(j)]
        return C[mat][keys[left].T[None, :, :], keys[right].T[:, None, :]]

    # dangles=2 exterior mismatch of branch (i, j): flanking bases (i-1,
    # j+1) when both exist, base-averaged one-sided dangles at the ends.
    i_in = (pos > 0)[None, :, None]
    j_in = (pos < length - 1)[:, None, None]
    mmx = torch.where(
        i_in,
        torch.where(j_in, std("mmbr", "m1", "p1"), std("d3", "m1", "oh")),
        torch.where(j_in, std("d5", "oh", "p1"), 0.0),
    )
    aux = std("au", "oh", "oh")

    # Special-hairpin content codes, read at spans 4 and 5 only.
    tp = [torch.roll(tokens, -k, dims=1) for k in range(6)]
    code5 = (((tp[0] * 4 + tp[1]) * 4 + tp[2]) * 4 + tp[3]) * 4 + tp[4]
    code6 = code5 * 4 + tp[5]
    return X, aux, mmx, em["tetra"][code6], em["tri"][code5]


class _SpanPlan:
    """Index tensors of the span loop for one (L, maxloop, min_hairpin, device).

    Windows are sorted by d1 + d2, so the windows whose inner pair is long
    enough at span s are a prefix of them (`n_ok[s]`).  Every `*_base`
    tensor holds flat offsets into the per-call tables to which a step adds
    s * L.
    """

    def __init__(self, length: int, maxloop: int, min_hairpin: int, device):
        L, LL = length, length * length
        wins = _interior_windows(maxloop)
        d1, d2 = wins[:, 0], wins[:, 1]
        order = np.argsort(d1 + d2, kind="stable")
        d1, d2 = d1[order], d2[order]
        dsum = d1 + d2
        bulge_n = np.maximum(d1, d2)
        is_stack = dsum == 0
        is_11 = (d1 == 1) & (d2 == 1)
        is_bulge = ((d1 == 0) | (d2 == 0)) & (bulge_n > 0)
        is_bulge2 = is_bulge & (bulge_n > 1)
        is_int = ~(is_stack | is_11 | is_bulge)
        # The outer-pair term and the inner-pair term of each window's loop
        # energy (the zero channel where there is none).
        out_ch = np.select(
            [is_stack, is_11, is_bulge & (bulge_n == 1) & (d1 == 1),
             is_bulge & (bulge_n == 1), is_bulge2],
            [_out("stack00"), _out("e11"), _out("stack_b10"), _out("stack_b01"), _out("au")],
            _out("mmA"),
        )
        in_ch = np.select([is_bulge2, is_int], [_AU_IN, _MMB], _ZERO)
        i = np.arange(L)[None, :]
        inner = (-dsum - 2)[:, None] * L + (d1 + 1)[:, None] + i  # V(i+d1+1, i+s-d2-1)
        window_base = np.stack([
            _V * LL + inner, in_ch[:, None] * LL + inner, out_ch[:, None] * LL + i,
        ])
        self.n_ok = [int((dsum <= s - min_hairpin - 3).sum()) for s in range(L)]
        p = np.arange(L)[:, None]
        # fML(i+2+p, i+s-1): the multiloop's right segment.
        right_base = (-3 - p) * L + i + 2 + p
        # V(i+t, i+s) and the branch terms of (i+t, i+s): the last branch.
        t = p
        branch = -t * L + i + t
        branch_base = np.stack([_V * LL + branch, _AU_IN * LL + branch, _MMBR * LL + branch])
        # V(i, j) = V_diag[(j - i) % L, i], as [j, i] for the W loop.
        jj, ii = np.arange(L)[:, None], np.arange(L)[None, :]
        exterior = ((jj - ii) % L) * L + ii

        def dev_tensor(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64, device=device)

        self.window_base = dev_tensor(window_base)
        self.right_base = dev_tensor(right_base)
        self.branch_base = dev_tensor(branch_base)
        self.exterior = dev_tensor(exterior.reshape(-1))
        self.is_bulge2 = torch.as_tensor(is_bulge2, device=device)[:, None]
        self.kind = {"is_bulge": torch.as_tensor(is_bulge, device=device),
                     "is_int": torch.as_tensor(is_int, device=device),
                     "bulge_n": dev_tensor(bulge_n), "d1": dev_tensor(d1), "d2": dev_tensor(d2)}


@lru_cache(maxsize=32)
def _span_plan(length: int, maxloop: int, min_hairpin: int, device: str) -> _SpanPlan:
    return _SpanPlan(length, maxloop, min_hairpin, torch.device(device))


def _window_constants(plan: _SpanPlan, em):
    """f32[P, 1]: each window's loop constant (0 for the stack and the 1x1 loop)."""
    k = plan.kind
    max_bulge = em["bulge_sizes"].shape[0] - 1
    bulge = em["bulge_sizes"][k["bulge_n"].clamp(0, max_bulge)]
    interior = em["interior_cost"][k["d1"] + 1, k["d2"] + 1]
    zero = torch.zeros((), device=bulge.device)
    return torch.where(k["is_bulge"], bulge, torch.where(k["is_int"], interior, zero))[:, None]


def zuker_mfe_batch(tokens, em, maxloop: int = 16, min_hairpin: int = 3, knockout=None):
    """MFE (kcal/mol, <= 0) f32[B] of int[B, L] RNA token rows, on em's device.

    `knockout` leaves one cost centre out of the model, for profiling by
    deletion: one of `KNOCKOUTS` ("hairpin_special": no tetraloop/triloop
    bonus; "interior": no two-loops; "multiloop": no multiloop closure;
    "lastbranch": fML without branches).
    """
    if knockout not in KNOCKOUTS:
        raise ValueError(f"knockout must be one of {KNOCKOUTS}, got {knockout!r}")
    if maxloop > em["interior_cost"].shape[0] - 2:
        raise ValueError(
            f"maxloop {maxloop} exceeds the energy model's "
            f"{em['interior_cost'].shape[0] - 2}"
        )
    dev = em["consts"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    B, L = tokens.shape
    if B == 0 or L == 0:
        return torch.zeros(B, device=dev)
    LL = L * L
    consts = em["consts"]
    ml_ab, ml_b, ml_c = consts[0] + consts[1], consts[1], consts[2]
    big = float(_INF)
    plan = _span_plan(L, maxloop, min_hairpin, str(dev))
    X, aux, mmx, tetra_row, tri_row = _fold_seq_tables(tokens, em)
    Xf = X.view(B, _N_CHANNELS * LL)
    k_win = _window_constants(plan, em)

    Md = torch.full((B, L, L), big, device=dev)  # fML, diagonal layout
    # prefix[t, i] = min(fML(i, i+t-1), c * t), and 0 at t = 0.
    ct = ml_c * torch.arange(L, dtype=torch.float32, device=dev)
    prefix = torch.minimum(Md, ct[None, :, None])
    prefix[:, 0] = 0.0

    for s in range(1, L):
        n = L - s
        row = X[:, :, s, :n]  # outer-pair terms of (i, i+s), [B, 13, n]

        def outer(name):
            return row[:, _out(name)]

        # Hairpin: loop size s - 1.
        size = s - 1
        cands = []
        if size >= min_hairpin:
            hp = em["hairpin_sizes"][min(size, _MAX_HAIRPIN_TABLE)]
            e_hp = hp + (outer("mmA") if size > min_hairpin else outer("au"))
            if knockout != "hairpin_special" and size in (3, 4):
                e_hp = e_hp + (tetra_row if size == 4 else tri_row)[:, :n]
            cands.append(e_hp)

        # Two-loops over the windows whose inner pair is long enough:
        # stack / 1-bulge / 1x1: K + O (K = 0 for the stack and 1x1);
        # bulge >= 2: K + (AU + AU'); generic interior: (K + mmA) + mmB.
        k = plan.n_ok[s]
        if k and knockout != "interior":
            idx = plan.window_base[:, :k, :n] + s * L
            v_in, t_in, t_out = torch.index_select(Xf, 1, idx.reshape(-1)).view(
                B, 3, k, n).unbind(1)
            kw = k_win[:k]
            e_loop = torch.where(plan.is_bulge2[:k], kw + (t_out + t_in), (kw + t_out) + t_in)
            cands.append((e_loop + v_in).amin(dim=1))

        # Multiloop closure: a + b + AU + closing mismatch + the best split
        # fML(i+1, i+1+p) + fML(i+2+p, i+s-1).
        if s >= 3 and knockout != "multiloop":
            left = Md[:, : s - 2, 1 : 1 + n]
            ridx = plan.right_base[: s - 2, :n] + s * L
            right = torch.index_select(Md.view(B, LL), 1, ridx.reshape(-1)).view(B, s - 2, n)
            split = (left + right).amin(dim=1)
            cands.append(((ml_ab + outer("au")) + outer("mmclose")) + split)

        if cands:
            best = cands[0]
            for c in cands[1:]:
                best = torch.minimum(best, c)
            X[:, _V, s, :n] = torch.where(outer("ptpos") > 0.5, best, big)

        # fML(i, i+s) = min(fML(i, i+s-1) + c,
        #                   min_t prefix(i, t) + V(i+t, i+s) + b + AU + mismatch)
        # over branches (i+t, i+s) long enough to close (t <= s - 4).
        m_new = Md[:, s - 1, :n] + ml_c
        n_t = s - min_hairpin
        if n_t > 0 and knockout != "lastbranch":
            bidx = plan.branch_base[:, :n_t, :n] + s * L
            v_br, au_br, mm_br = torch.index_select(Xf, 1, bidx.reshape(-1)).view(
                B, 3, n_t, n).unbind(1)
            m_branch = ((((prefix[:, :n_t, :n] + v_br) + ml_b) + au_br) + mm_br).amin(dim=1)
            m_new = torch.minimum(m_new, m_branch)
        Md[:, s, :n] = m_new
        if s + 1 < L:
            prefix[:, s + 1, :n] = torch.minimum(m_new, ct[s + 1])

    # Exterior loop: W[j + 1] = min(W[j], min_i W[i] + V(i, j) + AU + mismatch).
    vx = torch.index_select(Xf, 1, plan.exterior).view(B, L, L).permute(1, 2, 0)
    W = torch.zeros((L + 1, B), device=dev)
    for j in range(L):
        m = j - min_hairpin  # branches (i, j) with i < j - min_hairpin
        if m <= 0:
            W[j + 1] = W[j]
            continue
        cand = ((W[:m] + vx[j, :m]) + aux[j, :m]) + mmx[j, :m]
        torch.minimum(W[j], cand.amin(dim=0), out=W[j + 1])
    return W[L].clamp(max=0.0)


def zuker_mfe(tokens, em, maxloop: int = 16, min_hairpin: int = 3, knockout=None):
    """MFE (kcal/mol, <= 0), f32[], of one int[L] RNA token row."""
    tokens = torch.as_tensor(tokens).reshape(1, -1)
    return zuker_mfe_batch(tokens, em, maxloop, min_hairpin, knockout)[0]
