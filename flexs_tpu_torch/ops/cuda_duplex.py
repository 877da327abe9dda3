"""The RNA duplex DP as a hand-written CUDA kernel (csrc/duplex_dp.cu).

Counterpart of flexs_tpu/ops/pallas_duplex.py.  `duplex_energies` scores
int[B, L1] sequences against T reversed targets int[T, L2] in one launch
and returns f32[B, T].  A CUDA tensor goes to the kernel (or raises); a CPU
tensor goes to the plain version, `duplex_energies_plain`, which the kernel
matches bit for bit.

What depends only on the targets and the energy model (gram-pair tables,
target grams, duplex-end patch tables, the size costs) is a `DuplexPlan`,
made once per landscape by `make_plan`.  With a plan, a call on the card
checks its arguments without a host sync, allocates the output and
launches once; the kernel builds each sequence's records itself.

The kernel is compiled with nvcc for sm_90a on first use, from the source
in this package, into `flexs_tpu_torch/_build/` (tagged by the hash of the
source and flags), and bound with ctypes.  Nothing is built on import.

The row-cost builds that `flexs_tpu_torch.profile_duplex_rowcost` times
are `ROWCOST_BUILDS`: `baseline`, which is MAIN's library itself; the
knockouts of the main kernel in csrc/duplex_rowcost.cu (one library each,
launched on a plan by `launch_variant`); and `first`, the first CUDA kernel
in csrc/duplex_first.cu (driven by `prepare` and `launch`).  No main path
launches any of them, and each has its own launch count.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from flexs_tpu_torch.ops import rna_duplex as rd

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "duplex_dp.cu")
ROWCOST_SOURCE = os.path.join(_PKG_DIR, "csrc", "duplex_rowcost.cu")  # includes SOURCE
FIRST_SOURCE = os.path.join(_PKG_DIR, "csrc", "duplex_first.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_MAX_L2 = 1024  # one thread per target column
MAIN = "duplex_dp"  # the main path's build, of SOURCE

# The row-cost builds.  VARIANTS are scripts/profile_duplex_rowcost.py's
# names, in its order, each given its meaning on duplex_dp_kernel<16>;
# HOPPER_VARIANTS are the knockouts added for this card; FIRST is the
# first CUDA kernel.  _KNOCKOUT_ID is ROWCOST_SOURCE's DUPLEX_KNOCKOUT of
# each knockout; "baseline" is MAIN's library.
VARIANTS = ("baseline", "const-rec", "carry-windows", "unrolled")
HOPPER_VARIANTS = ("no-barrier", "chains-1", "chains-8", "dpx", "clocked")
FIRST = "first"
ROWCOST_BUILDS = VARIANTS + HOPPER_VARIANTS + (FIRST,)
_KNOCKOUT_ID = {"const-rec": 1, "unrolled": 2, "carry-windows": 3, "no-barrier": 4,
                "chains-1": 5, "chains-8": 6, "dpx": 7, "clocked": 8}
# The builds that compute the DP itself, bit for bit; the others are wrong
# by design and serve for timing only.
EXACT_VARIANTS = ("baseline", "unrolled", "chains-1", "chains-8", "clocked", FIRST)
# Every knockout is of the compile-time window (maxloop 16, L2 <= 512
# threads); "unrolled" is compiled for the profiler's L1 as well.
STATIC_L1, STATIC_MAXLOOP, STATIC_MAX_L2 = 100, 16, 512

_libs = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the duplex kernel cannot be built")
    return path


def _library(variant: str) -> str:
    """The library a build runs in: MAIN for MAIN and "baseline", else its own."""
    if variant == MAIN or variant == "baseline":
        return MAIN
    if variant not in ROWCOST_BUILDS:
        raise ValueError(f"unknown duplex kernel variant {variant!r}; one of {ROWCOST_BUILDS}")
    return variant


def check_variant(variant: str, l1: int, maxloop: int) -> None:
    """Raise ValueError for an unknown variant, or a shape its build cannot take."""
    _library(variant)
    if variant not in _KNOCKOUT_ID:
        return
    if variant == "unrolled" and (l1, maxloop) != (STATIC_L1, STATIC_MAXLOOP):
        raise ValueError(
            f"the {variant!r} build is compiled for L1={STATIC_L1}, "
            f"maxloop={STATIC_MAXLOOP}; got L1={l1}, maxloop={maxloop}"
        )
    if maxloop != STATIC_MAXLOOP:
        raise ValueError(f"the {variant!r} build is a knockout of duplex_dp_kernel<16> and "
                         f"takes maxloop={STATIC_MAXLOOP} only; got {maxloop}")


def nvcc_flags(variant: str = MAIN) -> list:
    """nvcc flags of a build: NVCC_FLAGS plus a knockout's defines."""
    if variant not in _KNOCKOUT_ID:
        _library(variant)
        return list(NVCC_FLAGS)
    defines = [f"-DDUPLEX_KNOCKOUT={_KNOCKOUT_ID[variant]}"]
    if variant == "unrolled":
        defines.append(f"-DDUPLEX_STATIC_L1={STATIC_L1}")
    return NVCC_FLAGS + defines


def _sources(variant: str) -> list:
    """The files a build compiles, the one given to nvcc first."""
    library = _library(variant)
    if library == MAIN:
        return [SOURCE]
    return [FIRST_SOURCE] if library == FIRST else [ROWCOST_SOURCE, SOURCE]


def tagged_path(name: str, sources, flags) -> str:
    """Where a library built from `sources` with `flags` goes: BUILD_DIR, tagged by both."""
    src = b"".join(open(path, "rb").read() for path in sources)
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def compile_library(lib_path: str, source: str, flags) -> Tuple[str, str]:
    """Compile `source` with nvcc and `flags` into `lib_path` unless it exists.

    Returns (path, compiler log); the log is empty when the library was there.
    """
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


def library_path(variant: str = MAIN) -> str:
    """Where a build's library goes: tagged by its sources and flags."""
    library = _library(variant)
    name = MAIN if library == MAIN else f"duplex_rowcost_{library.replace('-', '_')}"
    return tagged_path(name, _sources(library), nvcc_flags(library))


def build(variant: str = MAIN) -> Tuple[str, str]:
    """Compile a build's kernel library if needed; return (path, compiler log).

    `variant` is MAIN (the main path's kernel) or one of ROWCOST_BUILDS
    ("baseline" builds MAIN).
    """
    return compile_library(library_path(variant), _sources(variant)[0],
                           nvcc_flags(_library(variant)))


def _load(variant: str = MAIN):
    """A build's library, loaded once; its launch entry is `lib.launch`."""
    library = _library(variant)
    with _lib_lock:
        if library not in _libs:
            lib = ctypes.CDLL(build(library)[0])
            if library == FIRST:
                lib.launch = lib.duplex_first_launch
                lib.launch.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
            else:
                knockout = library in _KNOCKOUT_ID
                if knockout:
                    lib.duplex_rowcost_knockout.argtypes = []
                    lib.duplex_rowcost_knockout.restype = ctypes.c_int
                    if lib.duplex_rowcost_knockout() != _KNOCKOUT_ID[library]:
                        raise RuntimeError(f"{lib._name} is not the {library!r} build")
                if library == "clocked":
                    lib.duplex_rowcost_set_stamps.argtypes = [ctypes.c_void_p] * 2
                    lib.duplex_rowcost_set_stamps.restype = ctypes.c_int
                lib.launch = lib.duplex_rowcost_launch if knockout else lib.duplex_dp_launch
                lib.launch.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
            lib.launch.restype = ctypes.c_int
            _libs[library] = lib
    return _libs[library]


def _check_maxloop(maxloop: int) -> None:
    if maxloop < 3:
        # maxloop <= 2 leaves the kernel's interior/bulge candidate sets
        # empty; the plain slab path handles it via _INF table entries.
        raise ValueError(
            f"the duplex kernel needs maxloop >= 3 (got {maxloop}); "
            "use rna_duplex.duplex_energy_from_slabs for smaller values"
        )


def _check_em(em, maxloop: int) -> None:
    d = maxloop + 2
    expected = {"interior_cost": (d, d), "bulge_seq": (d - 1,), "bulge_tgt": (d,)}
    for name, shape in expected.items():
        if tuple(em[name].shape) != shape:
            raise ValueError(f"em[{name!r}] has shape {tuple(em[name].shape)}, "
                             f"expected {shape} for maxloop={maxloop}")


def duplex_energies_plain(tokens, targets_rev, em, maxloop: int):
    """Plain PyTorch version: f32[B, T] from the slab DP, one target at a time."""
    return torch.stack(
        [rd.duplex_energy_from_slabs(tokens, trev, em, maxloop) for trev in targets_rev],
        dim=1,
    )


# --- The plan: per-landscape inputs of the main path's kernel -------------


def cost_struct(d: int):
    """The ctypes layout of the kernel's by-value size costs for window d.

    Fields in the kernel's order (csrc/duplex_dp.cu, `Costs`): interior_cost
    f32[d * d], bulge_seq f32[d - 1], bulge_tgt f32[d].
    """
    return type(f"DuplexCosts{d}", (ctypes.Structure,), {"_fields_": [
        ("icost", ctypes.c_float * (d * d)),
        ("bseq", ctypes.c_float * (d - 1)),
        ("btgt", ctypes.c_float * d),
    ]})


@dataclass(eq=False)
class DuplexPlan:
    """What the kernel needs that depends only on the targets and the energy model.

    Made by `make_plan`; every tensor lives on the targets' device.  The
    patch tables hold the duplex-end energies that replace the gram tables
    at the edges, for every base the sequence can put there:
      open_col0  f32[T, 4, 5]   OPEN of column 0 by (s_i, s_i-1 or NONE)
      close_coll f32[T, 4, 5]   CLOSE of column L2-1 by (s_i, s_i+1 or NONE)
      open_row0  f32[T, 4, L2]  OPEN of row 0 by (s_0, column)
      close_rowl f32[T, 4, L2]  CLOSE of row L1-1 by (s_L1-1, column)
    At a corner the column's entry wins, as in `rd.boundary_patches`.
    """

    targets_rev: torch.Tensor
    em: dict
    maxloop: int
    t_past: torch.Tensor  # f32[7, 64, 64]
    t_fut: torch.Tensor  # f32[2, 16, 16]
    t3g: torch.Tensor  # int32[T, L2]
    t2g: torch.Tensor  # int32[T, L2]
    open_col0: torch.Tensor
    close_coll: torch.Tensor
    open_row0: torch.Tensor
    close_rowl: torch.Tensor
    interior_cost: torch.Tensor  # f32[d, d]
    bulge_seq: torch.Tensor  # f32[d - 1]
    bulge_tgt: torch.Tensor  # f32[d]
    host_costs: ctypes.Structure  # cost_struct(d), read from the device once
    _pointers: tuple = field(default=None, init=False, repr=False)

    @property
    def device(self) -> torch.device:
        return self.t3g.device

    @property
    def n_targets(self) -> int:
        return self.t3g.shape[0]

    @property
    def l2(self) -> int:
        return self.t3g.shape[1]

    def pointers(self) -> tuple:
        """The C entry's arguments from t3g to host_costs, as ints."""
        if self._pointers is None:
            tensors = (self.t3g, self.t2g, self.open_col0, self.close_coll, self.open_row0,
                       self.close_rowl, self.t_past, self.t_fut, self.interior_cost,
                       self.bulge_seq, self.bulge_tgt)
            self._pointers = tuple(x.data_ptr() for x in tensors) + (
                ctypes.addressof(self.host_costs),)
        return self._pointers


def _patch_tables(trev, em):
    """(open_col0 [4, 5], close_coll [4, 5], open_row0 [4, L2], close_rowl [4, L2]).

    The expressions of `rd.boundary_patches`, evaluated for every end base
    and neighbour instead of one sequence's, so each entry is bitwise the
    value that function gives.
    """
    trev = trev.long()
    l2 = trev.shape[0]
    dev = trev.device
    pair_tbl = rd._pair_table(dev)
    duplex_init = em["consts"][0]
    none = rd.NONE_BASE
    base = torch.arange(4, device=dev)[:, None]  # s_i, or the end base
    nbr = torch.arange(5, device=dev)[None, :]  # its neighbour; 4 = none
    j_idx = torch.arange(l2, device=dev)
    b3 = torch.where(j_idx > 0, torch.roll(trev, 1), none)[None, :]
    a5 = torch.where(j_idx < l2 - 1, torch.roll(trev, -1), none)[None, :]

    pt_col0 = pair_tbl[base, trev[0]]  # [4, 1]
    open_col0 = torch.where(
        pt_col0 > 0, duplex_init + em["ext5"][pt_col0, nbr, none], rd._INF
    )
    pt_row = pair_tbl[base, trev[None, :]]  # [4, L2]
    open_row0 = torch.where(pt_row > 0, duplex_init + em["ext5"][pt_row, none, b3], rd._INF)
    close_rowl = em["ext3"][pt_row, none, a5]
    pt_coll = pair_tbl[base, trev[l2 - 1]]
    close_coll = em["ext3"][pt_coll, nbr, none]
    return open_col0, close_coll, open_row0, close_rowl


def make_plan(targets_rev, em, maxloop: int) -> DuplexPlan:
    """The per-landscape inputs of the kernel for int[T, L2] reversed targets.

    Runs a few dozen torch ops and one device-to-host copy (the size costs);
    make it once and pass it to every `duplex_energies` call.
    """
    _check_maxloop(maxloop)
    if targets_rev.dim() != 2 or targets_rev.dtype.is_floating_point:
        raise ValueError("targets_rev must be an integer tensor [T, L2]")
    n_t, l2 = targets_rev.shape
    if not 1 <= l2 <= _MAX_L2 or n_t < 1:
        raise ValueError(f"unsupported shapes: targets {tuple(targets_rev.shape)}")
    _check_em(em, maxloop)
    dev = em["consts"].device
    for name, x in [("targets_rev", targets_rev)] + list(em.items()):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the energy model on {dev}")

    t_past, t_fut = rd.trigram_tables(em)
    t3g, t2g = zip(*[rd.target_grams(trev) for trev in targets_rev])
    tables = [torch.stack(p) for p in zip(*[_patch_tables(trev, em) for trev in targets_rev])]

    def f32(x):
        return x.to(torch.float32).contiguous()

    costs = [f32(em[k]) for k in ("interior_cost", "bulge_seq", "bulge_tgt")]
    host = np.concatenate([c.cpu().numpy().ravel() for c in costs])
    host_costs = cost_struct(maxloop + 2).from_buffer_copy(host.astype(np.float32).tobytes())
    return DuplexPlan(
        targets_rev, em, maxloop, f32(t_past), f32(t_fut),
        torch.stack(t3g).to(torch.int32).contiguous(),
        torch.stack(t2g).to(torch.int32).contiguous(),
        *(f32(x) for x in tables), *costs, host_costs,
    )


def plan_lookups(plan: DuplexPlan, tokens):
    """The kernel's records of int[B, L1] tokens, looked up in torch as it does.

    Returns (s3g, s2g, patches): the sequence gram indices int64[B, L1], and
    per target (open_row0 [B, L2], open_col0 [B, L1], close_rowl [B, L2],
    close_coll [B, L1]) in `rd.boundary_patches`' order.  A plain mirror of
    the kernel's formulas for the tests; nothing on the card path calls it.
    """
    s = tokens.long()
    l1 = s.shape[1]
    i = torch.arange(l1, device=s.device)
    sm1 = s[:, (i - 1).clamp(min=0)]
    sm2 = s[:, (i - 2).clamp(min=0)]
    sp1 = s[:, (i + 1).clamp(max=l1 - 1)]
    s3g = sm2 * 16 + sm1 * 4 + s
    s2g = s * 4 + sp1
    b5 = torch.where(i > 0, sm1, rd.NONE_BASE)
    a3 = torch.where(i < l1 - 1, sp1, rd.NONE_BASE)
    patches = []
    for t in range(plan.n_targets):
        open_col0 = plan.open_col0[t][s, b5]
        close_coll = plan.close_coll[t][s, a3]
        open_row0 = plan.open_row0[t][s[:, 0]]  # [B, L2]
        close_rowl = plan.close_rowl[t][s[:, -1]]
        # Column first, then row: the corners are the column's.
        open_row0[:, 0] = open_col0[:, 0]
        close_rowl[:, -1] = close_coll[:, -1]
        patches.append((open_row0, open_col0, close_rowl, close_coll))
    return s3g, s2g, patches


def _check_plan(plan: DuplexPlan, targets_rev, em, maxloop: int) -> None:
    if plan.targets_rev is not targets_rev or plan.em is not em or plan.maxloop != maxloop:
        raise ValueError("the plan was made for other targets, energy model or maxloop")


def duplex_energies(tokens, targets_rev, em, maxloop: int, plan: DuplexPlan = None):
    """Duplex energies f32[B, T] of int[B, L1] tokens vs int[T, L2] reversed targets.

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    `plan` is `make_plan(targets_rev, em, maxloop)`, made once; without it
    a CUDA call makes one first.
    """
    _check_maxloop(maxloop)
    if plan is not None:
        _check_plan(plan, targets_rev, em, maxloop)
    if tokens.device.type == "cpu":
        return duplex_energies_plain(tokens, targets_rev, em, maxloop)
    if tokens.device.type != "cuda":
        raise ValueError(f"unsupported device {tokens.device}")
    if plan is None:
        plan = make_plan(targets_rev, em, maxloop)
    return launch_plan(plan, tokens)


launches = 0  # launches of the main path's kernel; `launch_plan` adds one each
# Launches of each row-cost build, counted by `launch_variant` and `launch`.
rowcost_launches = dict.fromkeys(ROWCOST_BUILDS, 0)


def reset_launch_counts() -> None:
    """Set the launch count of every build to 0."""
    global launches
    launches = 0
    for v in rowcost_launches:
        rowcost_launches[v] = 0


def launch_counts() -> dict:
    """Launches of each build since the last reset: MAIN, then each row-cost build."""
    return {MAIN: launches, **rowcost_launches}


def _bind(load, name: str, plan: DuplexPlan, tokens):
    """Check CUDA int[B, L1] tokens against `plan` and allocate f32[B, T].

    Returns (out, enqueue): `enqueue()` launches the entry of the library
    `load()` returns on the current stream, into `out`, and raises if the
    launch failed; it is None for B = 0.
    """
    dev = plan.device
    if tokens.device != dev:
        raise ValueError(f"tokens are on {tokens.device}, the plan on {dev}")
    if tokens.dim() != 2 or tokens.dtype.is_floating_point:
        raise TypeError("tokens must be an integer tensor [B, L1]")
    if tokens.dtype not in (torch.int32, torch.int64):
        tokens = tokens.long()
    tokens = tokens.contiguous()
    b, l1 = tokens.shape
    if l1 < 1:
        raise ValueError(f"unsupported shapes: tokens {tuple(tokens.shape)}")
    out = torch.empty((b, plan.n_targets), dtype=torch.float32, device=dev)
    if b == 0:
        return out, None
    lib = load()
    dims = (int(tokens.dtype == torch.int64), b, plan.n_targets, l1, plan.l2, plan.maxloop)

    def enqueue():  # holds `tokens` (maybe a copy) and `out` as long as it lives
        with torch.cuda.device(dev):
            err = lib.launch(tokens.data_ptr(), *plan.pointers(), out.data_ptr(), *dims,
                             torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")

    return out, enqueue


def launcher(plan: DuplexPlan, tokens, variant: str = MAIN, stamps=None):
    """(out, launch): checks and allocation done once, launches left to `launch`.

    Each `launch()` launches one build on CUDA int[B, L1] tokens into
    f32[B, T] `out` on the current stream and adds one to that build's
    count; for B = 0 it does nothing.  MAIN is the main path's kernel (as
    `launch_plan`), and a row-cost build of the plan's kernel is checked as
    `launch_variant` says.  For timing a kernel that takes less time than a
    wrapper call's host work.
    """
    if variant != MAIN:
        _check_variant_call(plan, tokens, variant, stamps)

    def load():
        lib = _load(variant)
        if stamps is not None:
            _point_stamps(lib, stamps)
        return lib

    name = "duplex_dp" if variant == MAIN else f"duplex_rowcost ({variant})"
    out, enqueue = _bind(load, name, plan, tokens)

    def launch():
        global launches
        if enqueue is None:
            return
        enqueue()
        if variant == MAIN:
            launches += 1
        else:
            rowcost_launches[variant] += 1

    return out, launch


def launch_plan(plan: DuplexPlan, tokens):
    """Launch the kernel on CUDA int[B, L1] tokens; returns f32[B, T].

    Checks without a host sync, allocates the output and launches once on
    the current stream.
    """
    out, launch = launcher(plan, tokens)
    launch()
    return out


# --- The row-cost builds (profiling only) ---------------------------------


def clock_buffers(l1: int, l2: int, device):
    """Zeroed (stamps int64[2, warps, L1, 4], timer int64[2, 2]) for `clocked`.

    stamps[blk, w, i, k] is clock64() of lane 0 of warp w of the first (blk
    0) or the last block (blk 1) at point k of DP row i: 0 the row's start,
    1 after the direct and interior candidates, 2 after the bulges, 3 after
    the barrier.  timer holds (clock64, globaltimer ns) of block 0's warp 0
    before the first row and after the last.
    """
    warps = (l2 + 31) // 32
    return (torch.zeros((2, warps, l1, 4), dtype=torch.int64, device=device),
            torch.zeros((2, 2), dtype=torch.int64, device=device))


_stamp_buffers = None  # what the clocked library's stamps point at (kept alive)


def _point_stamps(lib, buffers) -> None:
    global _stamp_buffers
    if _stamp_buffers is not None and all(
            x is y for x, y in zip(buffers, _stamp_buffers)):
        return
    err = lib.duplex_rowcost_set_stamps(buffers[0].data_ptr(), buffers[1].data_ptr())
    if err != 0:
        raise RuntimeError(f"setting the clocked build's stamps failed with CUDA error {err}")
    _stamp_buffers = buffers


def _check_variant_call(plan: DuplexPlan, tokens, variant: str, stamps) -> None:
    check_variant(variant, tokens.shape[-1], plan.maxloop)
    if variant not in ROWCOST_BUILDS or variant == FIRST:
        raise ValueError(f"{variant!r} does not run as a row-cost build on a plan "
                         "(the first kernel runs through prepare and launch)")
    if variant in _KNOCKOUT_ID and not 1 <= plan.l2 <= STATIC_MAX_L2:
        raise ValueError(f"the {variant!r} build takes L2 <= {STATIC_MAX_L2}; got {plan.l2}")
    if (stamps is not None) != (variant == "clocked"):
        raise ValueError("the clocked build, and only it, takes stamps")
    if stamps is not None:
        want = (2, (plan.l2 + 31) // 32, tokens.shape[-1], 4)
        if tuple(stamps[0].shape) != want or tuple(stamps[1].shape) != (2, 2) or any(
                x.dtype != torch.int64 or x.device != plan.device or not x.is_contiguous()
                for x in stamps):
            raise ValueError(f"stamps must be clock_buffers({want[2]}, {plan.l2}) on "
                             f"{plan.device}")


def launch_variant(plan: DuplexPlan, tokens, variant: str, stamps=None):
    """Launch a row-cost build of the main kernel on `plan`; returns f32[B, T].

    `variant` is "baseline" (MAIN's library, counted apart from the main
    path) or a knockout.  "clocked" needs `stamps`, from `clock_buffers`
    at these tokens' L1 and the plan's L2; no other build takes them.  An
    unknown variant, or a shape its build cannot take, raise ValueError
    before anything is built or launched.
    """
    if variant == MAIN:
        raise ValueError(f"{MAIN!r} is the main path's kernel: use launch_plan")
    out, launch = launcher(plan, tokens, variant, stamps)
    launch()
    return out


def prepare(tokens, targets_rev, em, maxloop: int):
    """Check CUDA inputs and build the first kernel's arguments: (args, dims).

    args: the 13 input tensors and the f32[B, T] output, contiguous, in the
    C entry's order; dims: (B, T, L1, L2, maxloop).
    """
    _check_maxloop(maxloop)
    dev = tokens.device
    if dev.type != "cuda":
        raise ValueError(f"the duplex kernel needs CUDA tensors, got {dev}")
    if tokens.dim() != 2 or targets_rev.dim() != 2:
        raise ValueError("tokens must be int[B, L1] and targets_rev int[T, L2]")
    if tokens.dtype.is_floating_point or targets_rev.dtype.is_floating_point:
        raise TypeError("tokens and targets_rev must be integer tensors")
    b, l1 = tokens.shape
    n_t, l2 = targets_rev.shape
    if not 1 <= l2 <= _MAX_L2 or l1 < 1 or n_t < 1:
        raise ValueError(f"unsupported shapes: tokens {tuple(tokens.shape)}, "
                         f"targets {tuple(targets_rev.shape)}")
    _check_em(em, maxloop)
    for name, x in [("targets_rev", targets_rev)] + list(em.items()):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, tokens on {dev}")

    s3g, s2g = rd.seq_grams(tokens)
    t3g, t2g = zip(*[rd.target_grams(trev) for trev in targets_rev])
    patches = [rd.boundary_patches(tokens, trev, em) for trev in targets_rev]
    open_row0, open_col0, close_rowl, close_coll = (
        torch.stack(p, dim=1) for p in zip(*patches)
    )  # each [B, T, L]
    t_past, t_fut = rd.trigram_tables(em)

    def i32(x):
        return x.to(torch.int32).contiguous()

    def f32(x):
        return x.to(torch.float32).contiguous()

    args = [
        i32(s3g), i32(s2g), i32(torch.stack(t3g)), i32(torch.stack(t2g)),
        f32(open_col0), f32(close_coll), f32(open_row0), f32(close_rowl),
        f32(t_past), f32(t_fut), f32(em["interior_cost"]),
        f32(em["bulge_seq"]), f32(em["bulge_tgt"]),
        torch.empty((b, n_t), dtype=torch.float32, device=dev),
    ]
    return args, (b, n_t, l1, l2, maxloop)


def launch(args, dims):
    """Launch the first kernel (build FIRST) on the current stream; returns the output.

    `args, dims` come from `prepare`.
    """
    out = args[-1]
    if dims[0] == 0:
        return out
    lib = _load(FIRST)
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.launch(*[a.data_ptr() for a in args], *dims, stream)
    if err != 0:
        raise RuntimeError(f"duplex_rowcost (first) kernel launch failed with CUDA error {err}")
    rowcost_launches[FIRST] += 1
    return out
