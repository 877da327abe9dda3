"""The RNA duplex DP as a hand-written CUDA kernel (csrc/duplex_dp.cu).

Counterpart of flexs_tpu/ops/pallas_duplex.py.  `duplex_energies` scores
int[B, L1] sequences against T reversed targets int[T, L2] in one launch
and returns f32[B, T].  A CUDA tensor goes to the kernel (or raises); a CPU
tensor goes to the plain version, `duplex_energies_plain`, which the kernel
matches bit for bit.

The kernel is compiled with nvcc for sm_90a on first use, from the source
in this package, into `flexs_tpu_torch/_build/` (cached by the hash of the
source and flags), and bound with ctypes.  Nothing is built on import.

The same source builds the row-cost knockouts of `VARIANTS` (see the
source's DUPLEX_VARIANT), each into its own library, for
`flexs_tpu_torch.profile_duplex_rowcost`.  The main path only ever loads
"baseline", whose flags are `NVCC_FLAGS` with no define.
The wrapper prepares the gram indices and the duplex-end patches with
torch ops, as the TPU wrapper prepares its records outside its kernel.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Tuple

import torch

from flexs_tpu_torch.ops import rna_duplex as rd

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "duplex_dp.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_MAX_L2 = 1024  # one thread per target column

# Row-cost knockout builds, in the order of scripts/profile_duplex_rowcost.py,
# and their DUPLEX_VARIANT numbers.  "unrolled" and "carry-windows" are
# compiled for one shape, the profiler's L1 and maxloop.
VARIANTS = ("baseline", "const-rec", "carry-windows", "unrolled")
_VARIANT_ID = {"baseline": 0, "const-rec": 1, "unrolled": 2, "carry-windows": 3}
# The builds that compute the DP itself, bit for bit; the others are wrong
# by design and serve for timing only.
EXACT_VARIANTS = ("baseline", "unrolled")
STATIC_L1, STATIC_MAXLOOP = 100, 16
_STATIC_SHAPE = ("unrolled", "carry-windows")

_libs = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the duplex kernel cannot be built")
    return path


def _variant_id(variant: str) -> int:
    if variant not in _VARIANT_ID:
        raise ValueError(f"unknown duplex kernel variant {variant!r}; one of {VARIANTS}")
    return _VARIANT_ID[variant]


def check_variant(variant: str, l1: int, maxloop: int) -> None:
    """Raise ValueError for an unknown variant, or a shape its build cannot take."""
    _variant_id(variant)
    if variant in _STATIC_SHAPE and (l1, maxloop) != (STATIC_L1, STATIC_MAXLOOP):
        raise ValueError(
            f"the {variant!r} build is compiled for L1={STATIC_L1}, "
            f"maxloop={STATIC_MAXLOOP}; got L1={l1}, maxloop={maxloop}"
        )


def nvcc_flags(variant: str = "baseline") -> list:
    """nvcc flags of a variant's build: NVCC_FLAGS plus its defines."""
    number = _variant_id(variant)
    if number == 0:
        return list(NVCC_FLAGS)
    defines = [f"-DDUPLEX_VARIANT={number}"]
    if variant in _STATIC_SHAPE:
        defines += [f"-DDUPLEX_L1={STATIC_L1}", f"-DDUPLEX_MAXLOOP={STATIC_MAXLOOP}"]
    return NVCC_FLAGS + defines


def library_path(variant: str = "baseline") -> str:
    """Where a variant's library is built: tagged by the source and its flags."""
    flags = nvcc_flags(variant)
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    name = "duplex_dp" if variant == "baseline" else f"duplex_dp_{variant.replace('-', '_')}"
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build(variant: str = "baseline") -> Tuple[str, str]:
    """Compile a variant's kernel library if needed; return (path, compiler log)."""
    lib_path = library_path(variant)
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *nvcc_flags(variant), "-o", tmp, SOURCE], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


def _load(variant: str):
    with _lib_lock:
        if variant not in _libs:
            lib = ctypes.CDLL(build(variant)[0])
            fn = lib.duplex_dp_launch
            fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _libs[variant] = lib
    return _libs[variant]


def _check_maxloop(maxloop: int) -> None:
    if maxloop < 3:
        # maxloop <= 2 leaves the kernel's interior/bulge candidate sets
        # empty; the plain slab path handles it via _INF table entries.
        raise ValueError(
            f"the duplex kernel needs maxloop >= 3 (got {maxloop}); "
            "use rna_duplex.duplex_energy_from_slabs for smaller values"
        )


def duplex_energies_plain(tokens, targets_rev, em, maxloop: int):
    """Plain PyTorch version: f32[B, T] from the slab DP, one target at a time."""
    return torch.stack(
        [rd.duplex_energy_from_slabs(tokens, trev, em, maxloop) for trev in targets_rev],
        dim=1,
    )


def duplex_energies(tokens, targets_rev, em, maxloop: int):
    """Duplex energies f32[B, T] of int[B, L1] tokens vs int[T, L2] reversed targets.

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    _check_maxloop(maxloop)
    if tokens.device.type == "cpu":
        return duplex_energies_plain(tokens, targets_rev, em, maxloop)
    if tokens.device.type != "cuda":
        raise ValueError(f"unsupported device {tokens.device}")
    return launch(*prepare(tokens, targets_rev, em, maxloop))


launches = 0  # baseline kernel launches; `launch` adds one per launch
# Launches of each knockout build, counted the same way.
knockout_launches = {v: 0 for v in VARIANTS if v != "baseline"}


def reset_launch_counts() -> None:
    """Set the launch count of every build to 0."""
    global launches
    launches = 0
    for v in knockout_launches:
        knockout_launches[v] = 0


def launch_counts() -> dict:
    """Launches of each build since the last reset, by variant name."""
    return {"baseline": launches, **knockout_launches}


def prepare(tokens, targets_rev, em, maxloop: int):
    """Check CUDA inputs and build the kernel's arguments: (args, dims).

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
    d = maxloop + 2
    expected = {"interior_cost": (d, d), "bulge_seq": (d - 1,), "bulge_tgt": (d,)}
    for name, shape in expected.items():
        if tuple(em[name].shape) != shape:
            raise ValueError(f"em[{name!r}] has shape {tuple(em[name].shape)}, "
                             f"expected {shape} for maxloop={maxloop}")
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


def launch(args, dims, variant: str = "baseline"):
    """Launch a variant's kernel on the current stream; returns the output tensor.

    `args, dims` come from `prepare`.  An unknown variant, or dims that a
    compile-time build does not take, raise ValueError before anything is
    built or launched.
    """
    global launches
    check_variant(variant, dims[2], dims[4])
    out = args[-1]
    if dims[0] == 0:
        return out
    lib = _load(variant)
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.duplex_dp_launch(
            *[a.data_ptr() for a in args], *dims, _VARIANT_ID[variant], stream
        )
    if err != 0:
        raise RuntimeError(f"duplex_dp ({variant}) kernel launch failed with CUDA error {err}")
    if variant == "baseline":
        launches += 1
    else:
        knockout_launches[variant] += 1
    return out
