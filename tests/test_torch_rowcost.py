"""The row-cost builds of the duplex kernel and the duplex profilers, on the CPU.

Nothing here builds or launches a kernel: these tests hold the build names,
flags, library paths, argument checks, the preprocessed tokens of the main
kernel and of the first one, the profiler's arithmetic (clock parts, cost
per row, the bound), and check that the profilers refuse to run without a
card.
"""
import ast
import contextlib
import hashlib
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from flexs_tpu_torch import profile_duplex, profile_duplex_rowcost
from flexs_tpu_torch.ops import cuda_duplex
from flexs_tpu_torch.ops import rna_duplex as rd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# sha256 of the first CUDA kernel's preprocessed tokens (csrc/duplex_first.cu,
# the row-cost build `first`), the yardstick of PERF.md's earlier readings.
# Update it only with a deliberate change to that kernel.
BASELINE_KERNEL_TOKENS_SHA256 = (
    "68c74dfb1fee66e3754fbbef07c12a82dd13cd9a32855754536fc30b28b70627"
)
# sha256 of the main path's kernel (csrc/duplex_dp.cu, from the kernel to
# the C entry) and of that whole file's preprocessed tokens, as they were
# before the row-cost hooks were added: the hooks must leave both unchanged.
MAIN_KERNEL_TOKENS_SHA256 = (
    "564b9a9d065ec006c50bd87a914fe1c8983a0323052189cca4808fc12a607ef3"
)
MAIN_SOURCE_TOKENS_SHA256 = (
    "bd5cb4d7d926120ac8fd9d4d3b73a2a1eb60e15ab4e5c705ac3bdc4a90c53899"
)
KNOCKOUTS = tuple(v for v in cuda_duplex.ROWCOST_BUILDS if v not in ("baseline", "first"))


def _jax_script_variants():
    """The variant tuple that scripts/profile_duplex_rowcost.py loops over."""
    path = os.path.join(ROOT, "scripts", "profile_duplex_rowcost.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    loops = [
        node for node in ast.walk(tree)
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name)
        and node.target.id == "variant" and isinstance(node.iter, ast.Tuple)
    ]
    assert len(loops) == 1
    return tuple(elt.value for elt in loops[0].iter.elts)


def test_variant_names_follow_the_jax_script():
    assert cuda_duplex.VARIANTS == _jax_script_variants()
    assert profile_duplex_rowcost.VARIANTS == cuda_duplex.VARIANTS
    assert cuda_duplex.ROWCOST_BUILDS[:4] == cuda_duplex.VARIANTS


def test_each_variant_has_its_own_build():
    # Every build but baseline (the main path's library) has its own
    # library and flags.
    builds = (cuda_duplex.MAIN,) + KNOCKOUTS + (cuda_duplex.FIRST,)
    paths = [cuda_duplex.library_path(v) for v in builds]
    assert len(set(paths)) == len(paths)
    assert all(os.path.dirname(p) == cuda_duplex.BUILD_DIR for p in paths)
    flags = [tuple(cuda_duplex.nvcc_flags(v)) for v in (cuda_duplex.MAIN,) + KNOCKOUTS]
    assert len(set(flags)) == len(flags)


def test_baseline_flags_are_the_main_paths():
    flags = cuda_duplex.nvcc_flags("baseline")
    assert flags == cuda_duplex.NVCC_FLAGS == cuda_duplex.nvcc_flags(cuda_duplex.MAIN)
    assert not any(f.startswith("-D") for f in flags)
    assert "--use_fast_math" not in flags
    assert cuda_duplex.library_path("baseline") == cuda_duplex.library_path(cuda_duplex.MAIN)


@pytest.mark.parametrize("variant,defines", [
    ("const-rec", ["-DDUPLEX_KNOCKOUT=1"]),
    ("unrolled", ["-DDUPLEX_KNOCKOUT=2", "-DDUPLEX_STATIC_L1=100"]),
    ("carry-windows", ["-DDUPLEX_KNOCKOUT=3"]),
    ("no-barrier", ["-DDUPLEX_KNOCKOUT=4"]),
    ("chains-1", ["-DDUPLEX_KNOCKOUT=5"]),
    ("chains-8", ["-DDUPLEX_KNOCKOUT=6"]),
    ("dpx", ["-DDUPLEX_KNOCKOUT=7"]),
    ("clocked", ["-DDUPLEX_KNOCKOUT=8"]),
])
def test_knockout_flags_add_only_their_defines(variant, defines):
    assert cuda_duplex.nvcc_flags(variant) == cuda_duplex.NVCC_FLAGS + defines


def test_knockouts_and_first_are_every_other_build():
    assert set(KNOCKOUTS) | {"baseline", "first"} == set(cuda_duplex.ROWCOST_BUILDS)
    assert cuda_duplex.HOPPER_VARIANTS == (
        "no-barrier", "chains-1", "chains-8", "dpx", "clocked")
    assert cuda_duplex.nvcc_flags(cuda_duplex.FIRST) == cuda_duplex.NVCC_FLAGS


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown duplex kernel variant"):
        cuda_duplex.nvcc_flags("fast")
    with pytest.raises(ValueError, match="unknown duplex kernel variant"):
        cuda_duplex.check_variant("fast", 100, 16)


def _cpu_inputs(b=4, l1=100, l2=100):
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, 4, (b, l1)))
    target_rev = torch.as_tensor(rng.integers(0, 4, l2))
    return tokens, target_rev, rd.DuplexParams.calibrated().energy_model("cpu"), 16


@pytest.mark.parametrize("variant", ["baseline", "clocked", "first"])
def test_run_variant_refuses_cpu_tensors(variant):
    with pytest.raises(ValueError, match="CUDA tensors"):
        profile_duplex_rowcost.run_variant(*_cpu_inputs(), variant)


def test_run_variant_refuses_unknown_variant():
    with pytest.raises(ValueError, match="unknown duplex kernel variant"):
        profile_duplex_rowcost.run_variant(*_cpu_inputs(), "fast")


@pytest.fixture
def no_build(monkeypatch):
    """Make any attempt to build or load a kernel library fail the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel library was built or loaded")

    monkeypatch.setattr(cuda_duplex, "build", refuse)
    monkeypatch.setattr(cuda_duplex, "_load", refuse)


def _cpu_plan(maxloop=16, l2=100):
    tokens, target_rev, _, _ = _cpu_inputs(l2=l2)
    em = rd.DuplexParams(maxloop=maxloop).energy_model("cpu")
    return cuda_duplex.make_plan(target_rev[None], em, maxloop)


@pytest.mark.parametrize("variant,l1,maxloop,match", [
    *[(v, 100, 7, "takes maxloop=16 only") for v in KNOCKOUTS if v != "unrolled"],
    ("unrolled", 100, 7, "compiled for L1=100, maxloop=16"),
    ("unrolled", 50, 16, "compiled for L1=100, maxloop=16"),
])
def test_static_shape_build_refuses_other_shapes(no_build, variant, l1, maxloop, match):
    tokens, target_rev, _, _ = _cpu_inputs(l1=l1)
    em = rd.DuplexParams(maxloop=maxloop).energy_model("cpu")
    with pytest.raises(ValueError, match=match):
        profile_duplex_rowcost.run_variant(tokens, target_rev, em, maxloop, variant)
    with pytest.raises(ValueError, match=match):
        cuda_duplex.launch_variant(_cpu_plan(maxloop), tokens, variant)


@pytest.mark.parametrize("variant", KNOCKOUTS)
def test_knockouts_refuse_the_runtime_windows_targets(no_build, variant):
    tokens, _, _, _ = _cpu_inputs()
    with pytest.raises(ValueError, match="takes L2 <= 512"):
        cuda_duplex.launch_variant(_cpu_plan(l2=513), tokens, variant)


@pytest.mark.parametrize("variant,maxloop", [
    ("baseline", 7), ("first", 7),
    *[(v, 16) for v in cuda_duplex.ROWCOST_BUILDS if v != "unrolled"],
])
def test_runtime_shape_builds_take_any_shape(variant, maxloop):
    cuda_duplex.check_variant(variant, 37, maxloop)


def test_launch_checks_before_the_empty_batch_shortcut(no_build):
    plan = _cpu_plan()
    with pytest.raises(ValueError):
        cuda_duplex.launch_variant(plan, torch.zeros((0, 50), dtype=torch.long), "unrolled")
    before = cuda_duplex.launch_counts()
    out = cuda_duplex.launch_variant(plan, torch.zeros((0, 100), dtype=torch.long), "unrolled")
    assert out.shape == (0, 1) and cuda_duplex.launch_counts() == before


def test_stamps_go_to_the_clocked_build_only(no_build):
    plan = _cpu_plan()
    tokens = torch.zeros((0, 100), dtype=torch.long)
    stamps = cuda_duplex.clock_buffers(100, plan.l2, "cpu")
    assert stamps[0].shape == (2, 4, 100, 4) and stamps[1].shape == (2, 2)
    with pytest.raises(ValueError, match="only it, takes stamps"):
        cuda_duplex.launch_variant(plan, tokens, "clocked")
    with pytest.raises(ValueError, match="only it, takes stamps"):
        cuda_duplex.launch_variant(plan, tokens, "baseline", stamps)
    with pytest.raises(ValueError, match="clock_buffers"):
        cuda_duplex.launch_variant(plan, tokens, "clocked",
                                   cuda_duplex.clock_buffers(50, plan.l2, "cpu"))
    assert cuda_duplex.launch_variant(plan, tokens, "clocked", stamps).shape == (0, 1)


def test_first_does_not_run_on_a_plan(no_build):
    with pytest.raises(ValueError, match="prepare and launch"):
        cuda_duplex.launch_variant(_cpu_plan(), torch.zeros((0, 100)), cuda_duplex.FIRST)
    with pytest.raises(ValueError, match="use launch_plan"):
        cuda_duplex.launch_variant(_cpu_plan(), torch.zeros((0, 100)), cuda_duplex.MAIN)


@pytest.mark.parametrize("variant", [cuda_duplex.MAIN, "baseline", "dpx"])
def test_launcher_checks_once_and_counts_each_launch(monkeypatch, variant):
    # A fake library stands in for the card: the bound launch passes the
    # plan's pointers and the shapes in the C entry's order, every time.
    calls = []

    class FakeLib:
        def launch(self, *args):
            calls.append(args)
            return 0

    class FakeStream:
        cuda_stream = 7

    monkeypatch.setattr(cuda_duplex, "_load", lambda variant=None: FakeLib())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: FakeStream())
    plan = _cpu_plan()
    tokens = torch.zeros((3, 100), dtype=torch.int32)
    saved = cuda_duplex.launch_counts()
    try:
        cuda_duplex.reset_launch_counts()
        out, launch = cuda_duplex.launcher(plan, tokens, variant)
        assert out.shape == (3, 1) and out.dtype == torch.float32 and not calls
        launch()
        launch()
        counts = cuda_duplex.launch_counts()
        assert counts[variant] == 2 and sum(counts.values()) == 2
    finally:
        cuda_duplex.launches = saved.pop(cuda_duplex.MAIN)
        cuda_duplex.rowcost_launches.update(saved)
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0] == (tokens.data_ptr(), *plan.pointers(), out.data_ptr(),
                        0, 3, 1, 100, 100, 16, 7)


def test_knockout_launch_counts_name_each_knockout():
    # Every row-cost build, baseline included, has its own counter;
    # `cuda_duplex.launches` counts the main path's kernel only.
    assert set(cuda_duplex.rowcost_launches) == set(cuda_duplex.ROWCOST_BUILDS)
    assert set(cuda_duplex.launch_counts()) == {cuda_duplex.MAIN, *cuda_duplex.ROWCOST_BUILDS}


def test_seeded_inputs_repeat_the_jax_scripts_draws():
    tokens, target_rev, em, maxloop = profile_duplex_rowcost.seeded_inputs("cpu")
    rng = np.random.default_rng(0)
    want_target = rng.integers(0, 4, 100, dtype=np.int32)[::-1]
    want_tokens = rng.integers(0, 4, size=(4096, 100), dtype=np.int32)
    np.testing.assert_array_equal(target_rev.numpy(), want_target)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    assert maxloop == 16 and em["interior_cost"].shape == (18, 18)


@pytest.mark.parametrize("module", [profile_duplex_rowcost, profile_duplex])
def test_profilers_exit_nonzero_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as exit_info:
        module.main()
    assert exit_info.value.code not in (0, None)


_SASS = """
        code for sm_90a
                Function : _ZN37_INTERNAL_duplex_dp_kernelEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;               /* 0x00000a00ff017b82 */
                                                                        /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                   /* 0x0000000000007919 */
        /*0020*/              @P0 BRA 0x60 ;                            /* 0x0000000000000947 */
        /*0030*/                   FMNMX R2, R2, R3, PT ;               /* 0x0000000302027209 */
        /*0040*/              @!P1 BRA 0x10 ;                           /* 0x0000000000009947 */
        /*0050*/                   EXIT ;                               /* 0x000000000000794d */
        /*0060*/                   BRA 0x60;                            /* 0xfffffffc00fc7947 */
        /*0070*/                   NOP;                                 /* 0x0000000000007918 */
"""


def test_parse_sass_counts_instructions_and_backward_branches():
    # One loop (0x40 -> 0x10); the forward branch and the trap after EXIT
    # are not loops, and NOP padding is not counted as an instruction but
    # is part of the size.
    assert profile_duplex_rowcost.parse_sass(_SASS) == {
        "instructions": 7, "bytes": 128, "backward_branches": 1,
    }


def test_longest_loop_counts_the_row_loop():
    # The loop 0x10..0x40 holds S2R, a forward branch, FMNMX and the branch back.
    assert profile_duplex_rowcost.longest_loop(_SASS) == {
        "loop_instructions": 4, "loop_shared_loads": 0, "loop_load_use": 0.0,
        "loop_loads_in_flight": 0,
    }
    looped = _SASS.replace("FMNMX R2, R2, R3, PT", "LDS R2, [R3+0x8]")
    assert profile_duplex_rowcost.longest_loop(looped)["loop_shared_loads"] == 1


def test_longest_loop_measures_how_far_loads_run_ahead():
    # Two loads in flight; R4 is read 3 instructions after its load, R5 2.
    body = """
        /*0000*/                   LDS R4, [R2] ;
        /*0010*/                   LDS R5, [R2+0x4] ;
        /*0020*/                   IADD3 R9, R1, 0x1, RZ ;
        /*0030*/                   FADD R6, R4, R5 ;
        /*0040*/              @!P1 BRA 0x0 ;
"""
    got = profile_duplex_rowcost.longest_loop(body)
    assert got["loop_shared_loads"] == 2 and got["loop_loads_in_flight"] == 2
    assert got["loop_load_use"] == 2.5


@pytest.mark.parametrize("text", ["", "/*0000*/  BRA `(.L_x_3) ;"])
def test_parse_sass_refuses_what_it_cannot_read(text):
    with pytest.raises(ValueError):
        profile_duplex_rowcost.parse_sass(text)


def test_exact_variants_are_baseline_and_unrolled():
    assert cuda_duplex.EXACT_VARIANTS == (
        "baseline", "unrolled", "chains-1", "chains-8", "clocked", "first")
    assert set(cuda_duplex.EXACT_VARIANTS) <= set(cuda_duplex.ROWCOST_BUILDS)


def test_launch_counts_reset_every_build():
    saved = cuda_duplex.launch_counts()
    try:
        cuda_duplex.launches = 3
        cuda_duplex.rowcost_launches["unrolled"] = 2
        cuda_duplex.rowcost_launches["baseline"] = 1
        cuda_duplex.rowcost_launches["first"] = 4
        cuda_duplex.reset_launch_counts()
        assert cuda_duplex.launch_counts() == dict.fromkeys(
            (cuda_duplex.MAIN,) + cuda_duplex.ROWCOST_BUILDS, 0)
    finally:
        cuda_duplex.launches = saved.pop(cuda_duplex.MAIN)
        cuda_duplex.rowcost_launches.update(saved)


def _stamps(row_parts, warps=2, rows=5, blocks=2, start=1000):
    """Synthetic int64[2, warps, rows, 4] stamps whose rows split into `row_parts`."""
    s = np.zeros((2, warps, rows, 4), dtype=np.int64)
    for blk in range(blocks):
        for w in range(warps):
            t = start + 7 * w + 1000 * blk
            for i in range(rows):
                for k in range(4):
                    s[blk, w, i, k] = t
                    t += row_parts[k]
    return s


@pytest.mark.parametrize("blocks", [1, 2])
def test_clock_parts_split_a_row_into_medians(blocks):
    parts = (600, 250, 400, 140)  # a 1,390-cycle row
    timer = np.array([[10_000, 500], [10_000 + 19_800, 500 + 10_000]])  # 1.98 cycles/ns
    got = profile_duplex_rowcost.clock_parts(_stamps(parts, blocks=blocks), timer)
    assert got["cycles"] == dict(zip(profile_duplex_rowcost.CLOCK_PARTS, map(float, parts)))
    assert got["row_cycles"] == 1390.0 and got["blocks"] == blocks and got["warps"] == 2
    assert got["sm_clock_mhz"] == pytest.approx(1980.0)
    assert got["parts_us_per_row"] == pytest.approx(1390 / 1980.0)


def test_clock_parts_refuse_empty_stamps_and_a_stopped_timer():
    with pytest.raises(ValueError, match="no stamps"):
        profile_duplex_rowcost.clock_parts(np.zeros((2, 4, 100, 4)), np.ones((2, 2)))
    with pytest.raises(ValueError, match="timer"):
        profile_duplex_rowcost.clock_parts(_stamps((1, 1, 1, 1)), np.zeros((2, 2)))


def test_row_cost_is_per_row_and_against_the_baseline():
    got = profile_duplex_rowcost.row_cost(0.0800, 100, 0.0700)
    assert got["us_per_row"] == pytest.approx(0.8)
    assert got["us_per_row_vs_baseline"] == pytest.approx(0.1)
    assert profile_duplex_rowcost.row_cost(0.07, 100, 0.07)["us_per_row_vs_baseline"] == 0


def test_dp_operations_count_adds_and_mins_apart():
    # maxloop 16: 119 interior and 30 bulge candidates, 4 direct ones.
    ops = profile_duplex_rowcost.dp_operations(1, 1, 1, 1, 16)
    assert ops == {"adds": 153 + 5, "mins": 153 + 4}
    assert profile_duplex_rowcost.dp_operations(100, 2, 100, 100, 16) == {
        "adds": 158 * 2_000_000, "mins": 157 * 2_000_000}


def test_bound_takes_the_issue_rate_not_the_fma_rate():
    # B=100, L1=L2=100: 315 operations a cell at 128 a clock on each of 132
    # SMs at 1.98 GHz (issue), not at 67e12 (an FMA counted twice).
    got = profile_duplex_rowcost.bound_entry(1_000, (100, 1, 100, 100, 16))
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(315e6 / (128 * 132 * 1.98e9) * 1e3)
    assert got["bound_ms"] > 2 * 315e6 / 67e12 * 1e3 * 0.99
    assert (got["adds"], got["mins"]) == (158_000_000, 157_000_000)
    bytes_bound = profile_duplex_rowcost.bound_entry(10**12, (1, 1, 1, 1, 16))
    assert bytes_bound["bound_by"] == "bytes"
    assert bytes_bound["bound_ms"] == pytest.approx(10**12 / 3.35e12 * 1e3)


def _preprocess(path, defines):
    """A CUDA source through the C preprocessor, its system #include lines
    dropped and a local #include "x.cu" replaced by that file, treated alike."""
    cpp = shutil.which("cpp")
    if cpp is None:
        pytest.skip("needs the C preprocessor")

    def text(p):
        out = []
        with open(p) as f:
            for line in f:
                local = re.match(r'#include "(.+)"', line)
                if local:
                    out.append(text(os.path.join(os.path.dirname(p), local.group(1))))
                elif not line.startswith("#include"):
                    out.append(line)
        return "".join(out)

    return subprocess.run(
        [cpp, "-P", *defines, "-"], input=text(path), capture_output=True, text=True, timeout=60
    )


def _token_digest(text):
    return hashlib.sha256(" ".join(re.findall(r"\w+|[^\s\w]", text)).encode()).hexdigest()


def _kernel_digest(preprocessed):
    """Digest of the tokens from the first __global__ to the first extern "C"."""
    return _token_digest(
        preprocessed[preprocessed.index("__global__"):preprocessed.index('extern "C"')])


@pytest.mark.parametrize("defines", [[], ["-DDUPLEX_KNOCKOUT=3"]])
def test_baseline_kernel_is_the_measured_kernel(defines):
    # The first kernel, build `first`, whatever a row-cost define says.
    proc = _preprocess(cuda_duplex.FIRST_SOURCE, defines)
    assert proc.returncode == 0, proc.stderr
    assert _kernel_digest(proc.stdout) == BASELINE_KERNEL_TOKENS_SHA256


@pytest.mark.parametrize("part", ["kernel", "file"])
def test_main_kernel_tokens_are_pinned(part):
    proc = _preprocess(cuda_duplex.SOURCE, [])
    assert proc.returncode == 0, proc.stderr
    if part == "kernel":
        assert _kernel_digest(proc.stdout) == MAIN_KERNEL_TOKENS_SHA256
    else:
        assert _token_digest(proc.stdout) == MAIN_SOURCE_TOKENS_SHA256


@pytest.mark.parametrize("variant", KNOCKOUTS)
def test_knockout_sources_preprocess_to_another_kernel(variant):
    defines = cuda_duplex.nvcc_flags(variant)[len(cuda_duplex.NVCC_FLAGS):]
    proc = _preprocess(cuda_duplex.ROWCOST_SOURCE, defines)
    assert proc.returncode == 0, proc.stderr
    assert _kernel_digest(proc.stdout) not in (
        MAIN_KERNEL_TOKENS_SHA256, BASELINE_KERNEL_TOKENS_SHA256)


def test_knockouts_preprocess_to_distinct_kernels():
    digests = set()
    for variant in KNOCKOUTS:
        defines = cuda_duplex.nvcc_flags(variant)[len(cuda_duplex.NVCC_FLAGS):]
        digests.add(_kernel_digest(_preprocess(cuda_duplex.ROWCOST_SOURCE, defines).stdout))
    assert len(digests) == len(KNOCKOUTS)


@pytest.mark.parametrize("defines", [[], ["-DDUPLEX_KNOCKOUT=2"], ["-DDUPLEX_KNOCKOUT=9"]])
def test_source_refuses_a_build_without_its_shape_or_number(defines):
    assert _preprocess(cuda_duplex.ROWCOST_SOURCE, defines).returncode != 0
