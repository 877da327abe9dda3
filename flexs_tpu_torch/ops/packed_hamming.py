"""Bit-packed Hamming distance: XOR + popcount instead of one-hot products.

Every sequence packs into ceil(L / (32 // bits)) 32-bit words.  The
distance between two packed rows is:

    x = a XOR b                       # group == 0 iff tokens equal
    fold = (x | x>>1 | ... | x>>(bits-1)) & lsb_mask
    dist = popcount(fold)             # one set bit per differing position

The words are held in int64 (values < 2**32, bit-identical to the JAX
package's uint32 words), as PyTorch has limited uint32 support.

`masked_hamming_matrix` is the distance op every runner calls: the matrix
of one query block against the first `bound` rows of each cell, rows at
or past a cell's fill reading a fill value.  On a CUDA tensor it launches
the hand-written kernel csrc/packed_hamming.cu once (or raises); on a CPU
tensor it runs the plain version, `masked_hamming_matrix_plain`, torch ops
with popcount as the SWAR bit trick, which the kernel equals integer for
integer.  `packed_hamming_matrix` is the same op with no mask.  The min and
argmin over the rows stay with the callers.

The kernel is compiled with nvcc for sm_90a on first use, into
`flexs_tpu_torch/_build/` (tagged by the hash of the source and flags), and
bound with ctypes.  Nothing is built on import.  It links the CUDA runtime
that PyTorch loaded (`-cudart shared`), and under a profiler each launch
runs inside an op of its own, `PROFILER_OP`, so that the trace links the
kernel to the host code that launched it.
"""
import ctypes
import functools
import os
import threading

import numpy as np
import torch

from flexs_tpu_torch.ops import cuda_duplex

SOURCE = os.path.join(os.path.dirname(cuda_duplex.SOURCE), "packed_hamming.cu")
NVCC_FLAGS = cuda_duplex.NVCC_FLAGS + ["-cudart", "shared"]
NAME = "packed_hamming"
PROFILER_OP = "flexs::packed_hamming"  # the launch's op in a profiler trace


@functools.lru_cache(maxsize=None)
def packing_spec(length: int, alphabet_size: int):
    """(bits per symbol, symbols per word, number of words) for a length."""
    bits = max(1, int(np.ceil(np.log2(max(alphabet_size, 2)))))
    per_word = 32 // bits
    words = int(np.ceil(length / per_word))
    return bits, per_word, words


def pack_tokens(tokens, alphabet_size: int, length: int = None) -> torch.Tensor:
    """Pack int[..., L] tokens into int64[..., K] words (< 2**32 each)."""
    tokens = torch.as_tensor(tokens)
    L = tokens.shape[-1] if length is None else length
    bits, per_word, words = packing_spec(L, alphabet_size)
    pad = words * per_word - L
    if pad:
        tokens = torch.cat(
            [tokens, tokens.new_zeros(tokens.shape[:-1] + (pad,))], dim=-1
        )
    grouped = tokens.reshape(tokens.shape[:-1] + (words, per_word)).long()
    shifts = _shifts(bits, per_word, grouped.device)
    # Groups occupy disjoint bit ranges, so summing the shifted groups is
    # exactly their bitwise OR.
    return (grouped << shifts).sum(dim=-1)


@functools.lru_cache(maxsize=None)
def _shifts(bits: int, per_word: int, device: torch.device) -> torch.Tensor:
    """Bit offset of each symbol in its word (cached: read-only)."""
    return bits * torch.arange(per_word, device=device)


@functools.lru_cache(maxsize=None)
def _lsb_mask(bits: int, per_word: int) -> int:
    mask = 0
    for g in range(per_word):
        mask |= 1 << (g * bits)
    return mask


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 element holding a 32-bit value (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def packed_hamming_matrix_plain(q_packed, c_packed, bits: int, per_word: int):
    """Plain PyTorch version of `packed_hamming_matrix` (any device, any leading dims)."""
    x = q_packed.unsqueeze(-2) ^ c_packed.unsqueeze(-3)  # [..., B, N, K]
    fold = x
    for s in range(1, bits):
        fold = fold | (x >> s)
    fold = fold & _lsb_mask(bits, per_word)
    return _popcount32(fold).sum(dim=-1).to(torch.int32)


def masked_hamming_matrix_plain(q_packed, c_packed, n_rows, bound: int, bits: int,
                                per_word: int, fill: int):
    """Plain PyTorch version of `masked_hamming_matrix`."""
    d = packed_hamming_matrix_plain(q_packed, c_packed[..., :bound, :], bits, per_word)
    if n_rows is None:
        return d
    filled = torch.arange(bound, device=q_packed.device) < n_rows[..., None]
    return torch.where(filled[..., None, :], d, fill)


def packed_hamming_matrix(q_packed, c_packed, bits: int, per_word: int):
    """All-pairs Hamming distances of packed rows: int32[..., B, N].

    q_packed: int64[..., B, K]; c_packed: int64[..., N, K], with the same
    leading (cell) dimensions or none.  `masked_hamming_matrix` with no mask.
    """
    return masked_hamming_matrix(q_packed, c_packed, None, c_packed.shape[-2], bits,
                                 per_word, 0)


def masked_hamming_matrix(q_packed, c_packed, n_rows, bound: int, bits: int,
                          per_word: int, fill: int):
    """Hamming int32[..., B, bound] of packed rows to the first `bound` rows of `c_packed`.

    q_packed: int64[..., B, K]; c_packed: int64[..., N, K] with N >= bound
    and the same leading (cell) dimensions, or none; n_rows: int64[...] of
    those leading dimensions, each cell's fill, or None.
    Rows at or past a cell's fill read `fill`.  CUDA tensors launch the
    kernel once (at most one leading dimension); CPU tensors run the plain
    version.
    """
    lead = _check(q_packed, c_packed, n_rows, bound, bits, per_word)
    dev = q_packed.device
    if dev.type == "cpu":
        return masked_hamming_matrix_plain(q_packed, c_packed, n_rows, bound, bits, per_word,
                                           fill)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out, launch = _launcher(q_packed, c_packed, n_rows, bound, bits, per_word, fill, lead)
    launch()
    return out


def _check(q_packed, c_packed, n_rows, bound: int, bits: int, per_word: int):
    """The output's leading shape; raises on inputs neither version takes alike."""
    dev = q_packed.device
    for name, x in (("c_packed", c_packed), ("n_rows", n_rows)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q_packed on {dev}")
    for name, x in (("q_packed", q_packed), ("c_packed", c_packed), ("n_rows", n_rows)):
        if x is not None and x.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {x.dtype}")
    lead = q_packed.shape[:-2]
    if (q_packed.dim() < 2 or c_packed.dim() < 2 or c_packed.shape[:-2] != lead
            or q_packed.shape[-1] != c_packed.shape[-1]):
        raise ValueError(f"unsupported shapes: queries {tuple(q_packed.shape)}, "
                         f"rows {tuple(c_packed.shape)}")
    if not 0 <= bound <= c_packed.shape[-2]:
        raise ValueError(f"bound {bound} outside the {c_packed.shape[-2]} rows")
    if not 1 <= bits <= 5 or bits * per_word > 32:
        raise ValueError(f"unsupported packing: {bits} bits x {per_word} symbols a word")
    if n_rows is not None and n_rows.shape != lead:
        raise ValueError(f"n_rows has shape {tuple(n_rows.shape)}, the cells {tuple(lead)}")
    return lead


launches = 0  # kernel launches; each CUDA call of `masked_hamming_matrix` adds one
_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """Where the kernel's library goes: tagged by its source and flags."""
    return cuda_duplex.tagged_path(NAME, [SOURCE], NVCC_FLAGS)


def build():
    """Compile the kernel's library if needed; return (path, compiler log)."""
    return cuda_duplex.compile_library(library_path(), SOURCE, NVCC_FLAGS)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            lib.packed_hamming_launch.argtypes = (
                [ctypes.c_void_p] + [ctypes.c_int64] * 3
                + [ctypes.c_void_p] + [ctypes.c_int64] * 3
                + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
                + [ctypes.c_int] * 5 + [ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p]
            )
            lib.packed_hamming_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


def launcher(q_packed, c_packed, n_rows, bound: int, bits: int, per_word: int, fill: int):
    """(out, launch): checks and allocation done once, launches left to `launch`.

    Each `launch()` launches the kernel on CUDA inputs into int32[..., B,
    bound] `out` on the current stream and adds one to `launches`; for an
    empty `out` it does nothing.  For timing a kernel that takes less time
    than a wrapper call's host work.
    """
    lead = _check(q_packed, c_packed, n_rows, bound, bits, per_word)
    dev = q_packed.device
    if dev.type != "cuda":
        raise ValueError(f"the packed_hamming kernel needs CUDA tensors, got {dev}")
    return _launcher(q_packed, c_packed, n_rows, bound, bits, per_word, fill, lead)


def _launcher(q, c, n_rows, bound, bits, per_word, fill, lead):
    if len(lead) > 1:
        raise ValueError(f"the kernel takes one cell axis or none, got {tuple(lead)}")
    dev = q.device
    m, k = q.shape[-2:]
    out = torch.empty((*lead, m, bound), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out, lambda: None
    cells = lead[0] if lead else 1
    q_cs, c_cs = (q.stride(0), c.stride(0)) if lead else (0, 0)
    fills, f_cs = 0, 0
    if n_rows is not None:
        fills, f_cs = n_rows.data_ptr(), (n_rows.stride(0) if lead else 0)
    args = (q.data_ptr(), q_cs, *q.stride()[-2:], c.data_ptr(), c_cs, *c.stride()[-2:],
            fills, f_cs, out.data_ptr(), cells, m, int(bound), k, int(bits),
            _lsb_mask(bits, per_word), int(fill))
    lib = _load()

    def launch():  # holds q, c and n_rows as long as it lives
        global launches
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if torch.autograd._profiler_enabled():
                # The profiler links a kernel to the op open at its launch;
                # a ctypes launch has none, so it gets one of its own.
                with torch._C._profiler._RecordFunctionFast(PROFILER_OP):
                    err = lib.packed_hamming_launch(*args, stream)
            else:
                err = lib.packed_hamming_launch(*args, stream)
        if err != 0:
            raise RuntimeError(f"packed_hamming kernel launch failed with CUDA error {err}")
        launches += 1

    return out, launch
