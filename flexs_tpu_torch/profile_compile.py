"""First-run cost of the heavyweight fused programs, each in a fresh process.

    python -m flexs_tpu_torch.profile_compile [gpr_bo_surrogate cbas ... nvcc] [--cpu]

Counterpart of scripts/profile_compile.py, with its five program names.
The JAX script times each program's trace, lowering and XLA compile: the
price every fresh process paid before its first result.  The port
compiles nothing ahead of a run; a fresh process pays instead for its
imports and CUDA context, and its first run for lazy module loading,
cuBLAS/cuDNN handles and the caching allocator's growth.  So each program
runs twice in a fresh subprocess, and the columns are:

  * import + context: the imports, the CUDA context and the program's
    set-up (landscape, arguments), in seconds;
  * first: the program's first run in that process;
  * second: its second run in the same process;
  * first - second: what the first run alone pays.

The programs run at the script's `_paper_args` configuration: TF-Bind
`SIX6_REF_R1` from `STARTS[0]`, signal strength 1.0, seed 0, 10 rounds x
100 x 2000, a 3-CNN ensemble surrogate where the name says surrogate and
the NAM otherwise; `surrogate_parts` times `surrogate.train` at capacity
1002, the 16 x 4096 predict and 10 rounds of train plus score.  The
port's one compile gets a row of its own, `nvcc`: the main library's
source (`ops/cuda_duplex.py`'s SOURCE and `nvcc_flags`) built into a
temporary directory, never into `_build/`.  By default every program runs,
and `nvcc` on a card.  Each row is a line and a JSON line with the card's
name and power limit.  `--cpu` runs on the CPU; otherwise it needs a card.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from flexs_tpu_torch.bench import card_string, timed
from flexs_tpu_torch.device import resolve_device

ROUNDS = 10
BATCH, QUERIES = 100, 2000
PROFILE_TIMEOUT_S = 1200
NVCC = "nvcc"


def _generator(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return gen


def _paper_args(device, rounds: int, model: str = "surrogate", spec=None):
    """(fitness_fn, params, start tokens, cfg, signal strength) of the script's `_paper_args`."""
    from flexs_tpu_torch.alphabet import as_alphabet
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.runtime import surrogate as surrogate_lib
    from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig

    land = tf_binding.TFBinding(name="SIX6_REF_R1", device=device)
    fitness_fn, fitness_params = land.device_fitness()
    start = torch.as_tensor(as_alphabet("TGCA").encode_one(tf_binding.STARTS[0]), device=device)
    if spec is None and model == "surrogate":
        spec = surrogate_lib.SurrogateSpec(ensemble_size=3)
    cfg = AdaleadConfig(
        rounds=rounds, sequences_batch_size=BATCH, model_queries_per_batch=QUERIES,
        alphabet_size=4, perfect_model=(model == "perfect"),
        surrogate=spec if model == "surrogate" else None,
    )
    return fitness_fn, fitness_params, start, cfg, 1.0


def _full(label, run, device, rounds, model):
    fitness_fn, params, start, cfg, ss = _paper_args(device, rounds, model)
    return [(label, lambda: run(fitness_fn, params, start, cfg, ss, _generator(device)))]


def profile_gpr_bo_surrogate(device, rounds: int = ROUNDS):
    from flexs_tpu_torch.runtime.gpr_bo_runner import run_gpr_bo_nam

    return _full("gpr_bo surrogate FULL", run_gpr_bo_nam, device, rounds, "surrogate")


def profile_gpr_bo_nam(device, rounds: int = ROUNDS):
    from flexs_tpu_torch.runtime.gpr_bo_runner import run_gpr_bo_nam

    return _full("gpr_bo nam FULL", run_gpr_bo_nam, device, rounds, "nam")


def profile_surrogate_parts(device, rounds: int = ROUNDS):
    """Isolated surrogate train and 65536-point predict (GPR_BO's pieces)."""
    from flexs_tpu_torch.runtime import surrogate as surrogate_lib

    spec = surrogate_lib.SurrogateSpec(ensemble_size=3)
    A, L, cap = 4, 8, 1002
    state = surrogate_lib.init_state(spec, A, L, _generator(device))
    tokens = torch.zeros((cap, L), dtype=torch.long, device=device)
    truth = torch.zeros(cap, device=device)
    space = torch.zeros((65536, L), dtype=torch.long, device=device)

    def train(st, gen):
        return surrogate_lib.train(spec, A, st, tokens, truth, 500, gen)

    def score_all(st):
        outs = []
        for c in range(16):
            m = surrogate_lib.predict_members(spec, A, st, space[c * 4096:(c + 1) * 4096])
            outs.append((m.mean(0), m.std(0, unbiased=False)))
        return outs

    def train_and_score():
        st, gen, sums = state, _generator(device), []
        for _ in range(rounds):
            st = train(st, gen)
            sums.append(sum(mu.sum() + sig.sum() for mu, sig in score_all(st)))
        return torch.stack(sums)

    return [
        ("surrogate.train 3xCNN cap1002", lambda: train(state, _generator(device))),
        ("surrogate 16x4096 predict", lambda: score_all(state)),
        (f"{rounds}-round train+score", train_and_score),
    ]


def profile_cbas(device, rounds: int = ROUNDS):
    from flexs_tpu_torch.runtime.cbas_runner import run_cbas_nam

    return _full("cbas nam FULL", run_cbas_nam, device, rounds, "nam")


def profile_adalead_surrogate(device, rounds: int = ROUNDS):
    from flexs_tpu_torch.runtime.jit_runner import run_adalead_nam

    return _full("adalead surrogate FULL", run_adalead_nam, device, rounds, "surrogate")


PROFILES = {
    "gpr_bo_surrogate": profile_gpr_bo_surrogate,
    "gpr_bo_nam": profile_gpr_bo_nam,
    "surrogate_parts": profile_surrogate_parts,
    "cbas": profile_cbas,
    "adalead_surrogate": profile_adalead_surrogate,
}


def child(name: str, t0: float, device: str, rounds: int) -> None:
    """In a fresh process: time a profile's programs twice each; print one JSON line.

    `t0` is `time.perf_counter()` taken before this module was imported.
    """
    from flexs_tpu_torch.ops import cuda_duplex

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.empty(1, device=dev)  # the CUDA context
        torch.cuda.synchronize(dev)
    programs = PROFILES[name](dev, rounds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    import_context = time.perf_counter() - t0
    cuda_duplex.reset_launch_counts()
    rows = []
    for label, fn in programs:
        first = timed(fn, dev)[1]
        second = timed(fn, dev)[1]
        rows.append({"program": label, "first_run_s": first, "second_run_s": second})
    print(json.dumps({"profile": name, "import_context_s": import_context, "programs": rows,
                      "duplex_launches": sum(cuda_duplex.launch_counts().values())}), flush=True)


def run_profile(name: str, device, rounds: int = ROUNDS,
                timeout: float = PROFILE_TIMEOUT_S) -> dict:
    """`child(name)` in a fresh Python process; its JSON reading (raises if it fails)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    code = ("import time; t0 = time.perf_counter(); import sys; "
            "from flexs_tpu_torch import profile_compile as p; "
            "p.child(sys.argv[1], t0, sys.argv[2], int(sys.argv[3]))")
    proc = subprocess.run([sys.executable, "-c", code, name, str(device), str(rounds)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if proc.returncode or not lines:
        raise RuntimeError(f"profile {name} failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def nvcc_reading() -> dict:
    """Wall of one nvcc build of the main library into a temporary directory."""
    from flexs_tpu_torch.ops import cuda_duplex

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "libduplex_dp.so")
        cmd = [cuda_duplex._nvcc(), *cuda_duplex.nvcc_flags(), "-o", out, cuda_duplex.SOURCE]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        size = os.path.getsize(out)
    return {"profile": NVCC, "program": "nvcc csrc/duplex_dp.cu", "compile_s": wall,
            "library_bytes": size}


def main(argv=None, device=None, rounds: int = ROUNDS,
         timeout: float = PROFILE_TIMEOUT_S) -> int:
    """Run the named profiles (all by default); `device`, `rounds`, `timeout` for tests."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in argv
    names = [a for a in argv if a != "--cpu"]
    unknown = [n for n in names if n not in PROFILES and n != NVCC]
    if unknown:
        raise SystemExit(f"unknown profiles {unknown}; one of {list(PROFILES) + [NVCC]} "
                         "(and --cpu)")
    dev = resolve_device("cpu" if cpu else device)
    card = card_string(dev)
    if not names:
        names = list(PROFILES) + ([NVCC] if dev.type == "cuda" else [])
    print(f"backend: {dev} {card}; each program in a fresh process", flush=True)
    for name in names:
        if name == NVCC:
            r = nvcc_reading()
            print(f"{r['program']:40s} compile {r['compile_s']:7.1f}s  "
                  f"library {r['library_bytes'] / 1e6:.2f} MB", flush=True)
            print(json.dumps({**r, "card": card}), flush=True)
            continue
        reading = run_profile(name, dev, rounds, timeout)
        for row in reading["programs"]:
            first, second = row["first_run_s"], row["second_run_s"]
            print(f"{row['program']:40s} import+context {reading['import_context_s']:6.1f}s  "
                  f"first {first:7.2f}s  second {second:7.2f}s  "
                  f"first-second {first - second:7.2f}s", flush=True)
            print(json.dumps({
                "profile": name, "program": row["program"],
                "import_context_s": reading["import_context_s"], "first_run_s": first,
                "second_run_s": second, "first_minus_second_s": first - second,
                "duplex_launches": reading["duplex_launches"], "card": card,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
