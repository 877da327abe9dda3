"""ctypes binding of the native host-side scorers (native/flexs_native.cc).

The C++ library is an independent host implementation of two oracles:
the Rosetta centroid scorer and the RNA duplex DP.  It reads the port's
own landscape tensors (`RosettaFolding`'s folded tables,
`ops.rna_duplex.DuplexParams`), so it cross-checks the port's device
paths, the CUDA duplex kernel included, from outside.

`load()` compiles the checkout's `native/flexs_native.cc` with `g++ -O3
-shared -fPIC` at first use into `flexs_tpu_torch/_build/` (tagged by the
hash of the source and flags), as the CUDA builds are; nothing is built on
import.  A failed build raises.  The sums of the C++ duplex DP associate
differently from the slab path's (flexs_native.cc:132,137 adds
`prev + bulge1 + stack`), so its energies agree to rounding, not bitwise.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "flexs_native.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> str:
    """Where the library goes: tagged by the source and the flags."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libflexs_native_{tag}.so")


def build() -> str:
    """Compile the library if needed; return its path.  Raises RuntimeError on failure."""
    lib_path = library_path()
    if os.path.exists(lib_path):
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Load the native library, building it first if needed."""
    lib = ctypes.CDLL(build())
    f32p, i32p, i32, f32 = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                            ctypes.c_int32, ctypes.c_float)
    lib.rosetta_score_batch.argtypes = [
        f32p, f32p, i32p, i32p, i32, i32, i32p, i32, f32, f32, f32p,
    ]
    lib.rosetta_score_batch.restype = None
    lib.rna_duplex_energy_batch.argtypes = [
        i32p, i32, i32, i32p, i32,
        f32p,  # stack
        f32p,  # mA
        f32p,  # mB
        f32p,  # int11
        f32p,  # ext5
        f32p,  # ext3
        f32p,  # interior_cost
        f32p,  # bulge_sizes
        i32, f32, f32, f32p,
    ]
    lib.rna_duplex_energy_batch.restype = None
    return lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(_host(a), np.float32)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(_host(a), np.int32)


def _host(a):
    """A tensor (on any device) or array-like as numpy."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def rosetta_score_batch(landscape, tokens) -> np.ndarray:
    """f32[B] native centroid fitness of int[B, L] AA tokens.

    `landscape` is a `flexs_tpu_torch.landscapes.RosettaFolding`; its
    folded tables (on any device) are passed to C++.
    """
    params = landscape._fitness_params
    env_site, pair_site = _f32(params.env_site), _f32(params.pair_site)
    pair_i, pair_j = _i32(params.pair_i), _i32(params.pair_j)
    consts = _f32(params.consts)
    tokens = _i32(tokens)
    batch, length = tokens.shape
    if env_site.shape[0] != length:
        raise ValueError(f"tokens have length {length}, the landscape {env_site.shape[0]}")
    out = np.empty(batch, np.float32)
    load().rosetta_score_batch(
        _f32p(env_site), _f32p(pair_site), _i32p(pair_i), _i32p(pair_j), len(pair_i), length,
        _i32p(tokens), batch, float(consts[0]), float(consts[1]), _f32p(out),
    )
    return out


def rna_duplex_energy_batch(seq_tokens, target_tokens, params=None) -> np.ndarray:
    """f32[B] native duplex energies of int[B, L1] tokens vs one target (5'->3', int[L2])."""
    from flexs_tpu_torch.ops import rna_duplex as rd

    params = params or rd.DuplexParams.calibrated()
    seq_tokens = _i32(seq_tokens)
    target_rev = np.ascontiguousarray(_i32(target_tokens)[::-1])
    batch, l1 = seq_tokens.shape
    tables = [_f32(t) for t in (params.stack, params.mA, params.mB, params.int11, params.ext5,
                                params.ext3, params.interior_cost_matrix(), params.bulge_sizes)]
    if tables[-1].shape[0] < params.maxloop + 1:
        raise ValueError(f"bulge_sizes has {tables[-1].shape[0]} entries, "
                         f"maxloop {params.maxloop} needs {params.maxloop + 1}")
    out = np.empty(batch, np.float32)
    load().rna_duplex_energy_batch(
        _i32p(seq_tokens), batch, l1, _i32p(target_rev), len(target_rev),
        *(_f32p(t) for t in tables),
        params.maxloop, float(params.duplex_init), float(params.terminal_au), _f32p(out),
    )
    return out
