"""The row-cost knockout builds and the duplex profilers, on the CPU.

Nothing here builds or launches a kernel: these tests hold the variant
names, build flags, build tags and argument checks, and check that the
profilers refuse to run without a card.
"""
import ast
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
# sha256 of the baseline kernel's preprocessed tokens: the first CUDA
# kernel, kept in csrc/duplex_rowcost.cu as the yardstick of the redesign
# (PERF.md).  Update it only with a deliberate change to that kernel.
BASELINE_KERNEL_TOKENS_SHA256 = (
    "68c74dfb1fee66e3754fbbef07c12a82dd13cd9a32855754536fc30b28b70627"
)


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


def test_each_variant_has_its_own_build():
    paths = [cuda_duplex.library_path(v) for v in cuda_duplex.VARIANTS]
    assert len(set(paths)) == len(paths)
    assert all(os.path.dirname(p) == cuda_duplex.BUILD_DIR for p in paths)
    flags = [tuple(cuda_duplex.nvcc_flags(v)) for v in cuda_duplex.VARIANTS]
    assert len(set(flags)) == len(flags)


def test_baseline_flags_are_the_main_paths():
    flags = cuda_duplex.nvcc_flags("baseline")
    assert flags == cuda_duplex.NVCC_FLAGS == cuda_duplex.nvcc_flags(cuda_duplex.MAIN)
    assert not any(f.startswith("-D") for f in flags)
    assert "--use_fast_math" not in flags


@pytest.mark.parametrize("variant,defines", [
    ("const-rec", ["-DDUPLEX_VARIANT=1"]),
    ("unrolled", ["-DDUPLEX_VARIANT=2", "-DDUPLEX_L1=100", "-DDUPLEX_MAXLOOP=16"]),
    ("carry-windows", ["-DDUPLEX_VARIANT=3", "-DDUPLEX_L1=100", "-DDUPLEX_MAXLOOP=16"]),
])
def test_knockout_flags_add_only_their_defines(variant, defines):
    assert cuda_duplex.nvcc_flags(variant) == cuda_duplex.NVCC_FLAGS + defines


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


def test_run_variant_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        profile_duplex_rowcost.run_variant(*_cpu_inputs(), "baseline")


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


@pytest.mark.parametrize("variant", ["unrolled", "carry-windows"])
@pytest.mark.parametrize("l1,maxloop", [(50, 16), (100, 7)])
def test_static_shape_build_refuses_other_shapes(no_build, variant, l1, maxloop):
    tokens, target_rev, _, _ = _cpu_inputs(l1=l1)
    em = rd.DuplexParams(maxloop=maxloop).energy_model("cpu")
    with pytest.raises(ValueError, match="compiled for L1=100, maxloop=16"):
        profile_duplex_rowcost.run_variant(tokens, target_rev, em, maxloop, variant)
    out = torch.empty((4, 1))
    with pytest.raises(ValueError, match="compiled for L1=100, maxloop=16"):
        cuda_duplex.launch([out], (4, 1, l1, 100, maxloop), variant)


@pytest.mark.parametrize("variant", ["baseline", "const-rec"])
def test_runtime_shape_builds_take_any_shape(variant):
    cuda_duplex.check_variant(variant, 37, 7)


def test_launch_checks_before_the_empty_batch_shortcut(no_build):
    with pytest.raises(ValueError):
        cuda_duplex.launch([torch.empty((0, 1))], (0, 1, 50, 100, 16), "unrolled")
    out = torch.empty((0, 1))
    assert cuda_duplex.launch([out], (0, 1, 100, 100, 16), "unrolled") is out


def test_knockout_launch_counts_name_each_knockout():
    # Every row-cost build, the first kernel (baseline) included, has its own counter;
    # `cuda_duplex.launches` counts the main path's kernel only.
    assert set(cuda_duplex.rowcost_launches) == set(cuda_duplex.VARIANTS)
    assert set(cuda_duplex.launch_counts()) == {cuda_duplex.MAIN, *cuda_duplex.VARIANTS}


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
    # are not loops, and NOP padding is not counted.
    assert profile_duplex_rowcost.parse_sass(_SASS) == {
        "instructions": 7, "backward_branches": 1,
    }


def test_longest_loop_counts_the_row_loop():
    # The loop 0x10..0x40 holds S2R, a forward branch, FMNMX and the branch back.
    assert profile_duplex_rowcost.longest_loop(_SASS) == {
        "loop_instructions": 4, "loop_shared_loads": 0,
    }
    looped = _SASS.replace("FMNMX R2, R2, R3, PT", "LDS R2, [R3+0x8]")
    assert profile_duplex_rowcost.longest_loop(looped)["loop_shared_loads"] == 1


@pytest.mark.parametrize("text", ["", "/*0000*/  BRA `(.L_x_3) ;"])
def test_parse_sass_refuses_what_it_cannot_read(text):
    with pytest.raises(ValueError):
        profile_duplex_rowcost.parse_sass(text)


def test_exact_variants_are_baseline_and_unrolled():
    assert cuda_duplex.EXACT_VARIANTS == ("baseline", "unrolled")
    assert set(cuda_duplex.EXACT_VARIANTS) <= set(cuda_duplex.VARIANTS)


def test_launch_counts_reset_every_build():
    saved = cuda_duplex.launch_counts()
    try:
        cuda_duplex.launches = 3
        cuda_duplex.rowcost_launches["unrolled"] = 2
        cuda_duplex.rowcost_launches["baseline"] = 1
        cuda_duplex.reset_launch_counts()
        assert cuda_duplex.launch_counts() == dict.fromkeys(
            (cuda_duplex.MAIN,) + cuda_duplex.VARIANTS, 0)
    finally:
        cuda_duplex.launches = saved.pop(cuda_duplex.MAIN)
        cuda_duplex.rowcost_launches.update(saved)


def _preprocess(defines):
    """The CUDA source through the C preprocessor (its #include lines dropped)."""
    cpp = shutil.which("cpp")
    if cpp is None:
        pytest.skip("needs the C preprocessor")
    with open(cuda_duplex.ROWCOST_SOURCE) as f:
        src = "".join(line for line in f if not line.startswith("#include"))
    return subprocess.run(
        [cpp, "-P", *defines, "-"], input=src, capture_output=True, text=True, timeout=60
    )


def _kernel_digest(preprocessed):
    kernel = preprocessed[
        preprocessed.index("__global__ void duplex_dp_kernel"):preprocessed.index('extern "C"')
    ]
    tokens = re.findall(r"\w+|[^\s\w]", kernel)
    return hashlib.sha256(" ".join(tokens).encode()).hexdigest()


@pytest.mark.parametrize("defines", [[], ["-DDUPLEX_VARIANT=0"]])
def test_baseline_kernel_is_the_measured_kernel(defines):
    proc = _preprocess(defines)
    assert proc.returncode == 0, proc.stderr
    assert _kernel_digest(proc.stdout) == BASELINE_KERNEL_TOKENS_SHA256


@pytest.mark.parametrize("variant", ["const-rec", "unrolled", "carry-windows"])
def test_knockout_sources_preprocess_to_another_kernel(variant):
    defines = cuda_duplex.nvcc_flags(variant)[len(cuda_duplex.NVCC_FLAGS):]
    proc = _preprocess(defines)
    assert proc.returncode == 0, proc.stderr
    assert _kernel_digest(proc.stdout) != BASELINE_KERNEL_TOKENS_SHA256


@pytest.mark.parametrize("defines", [["-DDUPLEX_VARIANT=2"], ["-DDUPLEX_VARIANT=3"],
                                     ["-DDUPLEX_VARIANT=4"]])
def test_source_refuses_a_build_without_its_shape_or_number(defines):
    assert _preprocess(defines).returncode != 0
