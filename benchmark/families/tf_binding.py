"""TF-Bind-8 on the port: its landscapes, its sweep, its spans and its control."""
import contextlib

from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.parallel import sweep

# Probe target: the table sweep's oracle.
ORACLE_TARGETS = [(sweep, "_indexed_table_fitness")]


def make_inputs(config, device):
    """Nothing to make: the tables are data, read by the program and the reference alike."""
    return {}


def landscape_keys(config):
    """The problems a unit draws from: every landscape of the port's registry, sorted."""
    return sorted(tf_binding.registry())


def run_sweep(config, keys, starts, signal_strengths, seed, chunk_size, device):
    """The summary frame of `parallel.run_robustness_sweep` over the landscapes `keys`."""
    return sweep.run_robustness_sweep(
        list(keys), list(starts), signal_strengths=list(signal_strengths), seeds=[int(seed)],
        rounds=config["rounds"], sequences_batch_size=config["sequences_batch_size"],
        model_queries_per_batch=config["model_queries_per_batch"], alphabet=config["alphabet"],
        chunk_size=chunk_size, device=device,
    )


@contextlib.contextmanager
def control(reference, device):
    """The reference in the program's place, its tables in bfloat16: the sweep's oracle replaced."""
    from benchmark.probes import replaced

    with replaced([(sweep, "_indexed_table_fitness", lambda fn: reference.bf16_oracle())]):
        yield
