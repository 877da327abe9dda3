"""One rank of the port's two-process test (tests/test_torch_multihost.py).

    python tests/torch_multihost_worker.py <port> <world_size> <rank> <out_dir> <ckpt_dir>

Joins a gloo process group at tcp://localhost:<port>, builds the sweep
mesh, and writes to <out_dir>:
  * sweep_<rank>.csv: the 8-cell SIX6_REF_R1 sweep over the mesh;
  * resumed_<rank>.csv: the same grid in chunks of 2 with <ckpt_dir>,
    which a one-rank run left with its last chunk removed;
  * fit_<rank>.npy: a CNN's flat weights after a data-parallel fit
    (minibatches of 15 rows: shares of 7 and 8 rows on two ranks).
Everything runs on the CPU.
"""
import os
import sys
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

GRID = dict(
    starts_count=2, signal_strengths=[0.5, 1.0], seeds=[0, 1], rounds=2,
    sequences_batch_size=4, model_queries_per_batch=20,
)
FIT = dict(seq_len=8, num_filters=4, hidden_size=8, batch_size=15, epochs=3)
FIT_ROWS, FIT_SEED = 40, 5


def sweep(mesh, **kw):
    """The test's grid through the generic sweep on the CPU."""
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep

    landscape = flexs.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")
    grid = dict(GRID)
    starts = tf_binding.STARTS[: grid.pop("starts_count")]
    return run_landscape_robustness_sweep(
        [landscape], flexs.DNAA, starts=starts, mesh=mesh, device="cpu", **grid, **kw
    )


def fit(mesh) -> np.ndarray:
    """Flat weights of a seeded CNN after one data-parallel `train` call."""
    import flexs_tpu_torch as flexs

    rng = np.random.default_rng(FIT_SEED)
    seqs = ["".join(rng.choice(list(flexs.DNAA), FIT["seq_len"])) for _ in range(FIT_ROWS)]
    labels = rng.random(FIT_ROWS)
    model = flexs.baselines.models.CNN(
        FIT["seq_len"], FIT["num_filters"], FIT["hidden_size"], flexs.DNAA,
        batch_size=FIT["batch_size"], epochs=FIT["epochs"], mesh=mesh, device="cpu",
    )
    model.train(seqs, labels)
    return model._state.params.detach().numpy()


def main():
    port, world, rank, out_dir, ckpt_dir = sys.argv[1:6]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=240))
    try:
        from flexs_tpu_torch.parallel import multihost

        mesh = multihost.multihost_sweep_mesh()
        assert tuple(mesh.shape) == (1, world), mesh
        assert multihost.mesh_share(mesh) == (rank, world)
        sweep(mesh).to_csv(os.path.join(out_dir, f"sweep_{rank}.csv"), index=False)
        sweep(mesh, chunk_size=2, checkpoint_dir=ckpt_dir).to_csv(
            os.path.join(out_dir, f"resumed_{rank}.csv"), index=False
        )
        np.save(os.path.join(out_dir, f"fit_{rank}.npy"), fit(mesh))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"rank {rank} of {world} ok", flush=True)


if __name__ == "__main__":
    main()
