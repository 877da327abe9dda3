"""The port's checkpoint/resume module against the JAX package's.

The cases of tests/test_checkpointing.py on the port (all but its round
timer's, which the port replaced by the span registry), then the two
packages against each other: a run log written by either loads in the
other byte for byte, and a resumed seeded Random run (numpy streams in
both packages) equals the JAX package's resumed run row for row.  Also
the port's `save_state`/`load_state` over tensors, generators and
NamedTuples, which the JAX package does with orbax.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import flexs_tpu
from flexs_tpu.utils import checkpointing as jax_checkpointing

import flexs_tpu_torch as flexs
from flexs_tpu_torch.baselines.models.torch_model import AdamState
from flexs_tpu_torch.utils import checkpointing


def _fakes(pkg):
    """(landscape, model) classes of `pkg` drawing from seeded numpy streams."""

    class FakeLandscape(pkg.Landscape):
        def __init__(self):
            super().__init__(name="FakeLandscape")
            self.rng = np.random.default_rng(0)

        def _fitness_function(self, sequences):
            return self.rng.random(size=len(sequences))

    class FakeModel(pkg.Model):
        def __init__(self):
            super().__init__(name="FakeModel")
            self.rng = np.random.default_rng(1)

        def train(self, *args):
            pass

        def _fitness_function(self, sequences):
            return self.rng.random(size=len(sequences))

    return FakeLandscape, FakeModel


FakeLandscape, FakeModel = _fakes(flexs)


def _explorer(rounds=4, log_file=None, pkg=flexs, batch=5):
    return pkg.baselines.explorers.Random(
        _fakes(pkg)[1](),
        rounds=rounds,
        sequences_batch_size=batch,
        model_queries_per_batch=20,
        starting_sequence="TTGCAGCA",
        alphabet=pkg.DNAA,
        seed=0,
        log_file=log_file,
    )


def _frame():
    return pd.DataFrame(
        {
            "sequence": ["AAAA", "TTTT"],
            "model_score": [np.nan, 0.5],
            "true_score": [0.1, 0.9],
            "round": [0, 1],
            "model_cost": [0, 10],
            "measurement_cost": [1, 2],
        }
    )


def test_save_load_run_roundtrip(tmp_path):
    meta = {"exp_name": "x", "rounds": 1}
    path = str(tmp_path / "run.csv")
    checkpointing.save_run(path, _frame(), meta)
    df2, meta2 = checkpointing.load_run(path)
    assert meta2 == meta
    assert list(df2["sequence"]) == ["AAAA", "TTTT"]


def test_resume_continues_partial_run(tmp_path):
    log = str(tmp_path / "run.csv")
    partial = _explorer(rounds=2, log_file=log)
    partial.run(FakeLandscape(), verbose=False)
    df_partial, _ = checkpointing.load_run(log)
    assert df_partial["round"].max() == 2

    full = _explorer(rounds=4)
    df, _ = checkpointing.resume_explorer(full, FakeLandscape(), log, verbose=False)
    assert df["round"].max() == 4
    # The first two rounds' rows are kept byte for byte.
    pd.testing.assert_frame_equal(df.iloc[: len(df_partial)], df_partial)


def test_resume_noop_when_complete(tmp_path):
    log = str(tmp_path / "run.csv")
    df1, _ = _explorer(rounds=2, log_file=log).run(FakeLandscape(), verbose=False)
    df2, _ = checkpointing.resume_explorer(
        _explorer(rounds=2), FakeLandscape(), log, verbose=False
    )
    pd.testing.assert_frame_equal(
        df1.reset_index(drop=True), df2.reset_index(drop=True)
    )


def test_save_load_state_pytree(tmp_path):
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "step": np.int32(7)}
    path = str(tmp_path / "ckpt")
    checkpointing.save_state(path, state)
    restored = checkpointing.load_state(path)
    np.testing.assert_array_equal(restored["w"], state["w"])
    assert restored["w"].dtype == np.float32
    assert int(restored["step"]) == 7


def test_resume_rejects_foreign_log(tmp_path):
    """Resuming over a log written by a different experiment raises."""
    log = str(tmp_path / "run.csv")
    _explorer(rounds=2, log_file=log).run(FakeLandscape(), verbose=False)
    other = _explorer(rounds=4, batch=7)  # another batch size: another run
    with pytest.raises(ValueError, match="DIFFERENT experiment"):
        checkpointing.resume_explorer(other, FakeLandscape(), log, verbose=False)


def test_resume_fresh_run_creates_log_dir(tmp_path):
    """A fresh resume_explorer run makes the directories of a nested log path."""
    log = str(tmp_path / "nested" / "dir" / "run.csv")
    df, _ = checkpointing.resume_explorer(
        _explorer(rounds=1), FakeLandscape(), log, verbose=False
    )
    assert df["round"].max() == 1
    df2, _ = checkpointing.load_run(log)
    assert len(df2) == len(df)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_run_logs_cross_load(tmp_path, writer):
    """A log written by either package loads in the other, and both write the same bytes."""
    meta = {"exp_name": "x", "rounds": 1, "landscape_name": "L"}
    paths = {pkg: str(tmp_path / f"{pkg}.csv") for pkg in ("jax", "port")}
    jax_checkpointing.save_run(paths["jax"], _frame(), meta)
    checkpointing.save_run(paths["port"], _frame(), meta)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    reader = checkpointing if writer == "jax" else jax_checkpointing
    df, meta2 = reader.load_run(paths[writer])
    assert meta2 == meta
    pd.testing.assert_frame_equal(df, _frame())


def test_resumed_random_run_equals_jax_row_for_row(tmp_path):
    """Both packages resume the same partial log to the same frame (seeded numpy streams)."""
    frames = {}
    for name, pkg, ckpt in (("jax", flexs_tpu, jax_checkpointing),
                            ("port", flexs, checkpointing)):
        log = str(tmp_path / f"{name}.csv")
        land_cls, _ = _fakes(pkg)
        _explorer(rounds=2, log_file=log, pkg=pkg).run(land_cls(), verbose=False)
        frames[name], _ = ckpt.resume_explorer(
            _explorer(rounds=4, pkg=pkg), land_cls(), log, verbose=False
        )
    assert frames["port"]["round"].max() == 4
    pd.testing.assert_frame_equal(frames["port"], frames["jax"])


def test_state_of_tensors_generators_and_namedtuples(tmp_path):
    """A fit's Adam state and a generator mid-stream come back exact, typed by the template."""
    gen = torch.Generator()
    gen.manual_seed(3)
    torch.rand(5, generator=gen)
    params = torch.randn(2, 7, generator=gen)
    state = {"opt": AdamState(params, params * 0.5, params.square(), torch.tensor([4])),
             "gen": gen, "epoch": 2, "names": ["a", "b"], "x": np.ones(3, np.int16)}
    path = str(tmp_path / "sub" / "state.pt")
    checkpointing.save_state(path, state)
    plain = checkpointing.load_state(path)
    assert set(plain["opt"]) == set(AdamState._fields)  # no template: a dict
    restored = checkpointing.load_state(path, template=state)
    assert isinstance(restored["opt"], AdamState)
    for a, b in zip(restored["opt"], state["opt"]):
        assert torch.equal(a, b)
    assert restored["epoch"] == 2 and restored["names"] == ["a", "b"]
    assert restored["x"].dtype == np.int16
    assert torch.equal(torch.rand(4, generator=restored["gen"]), torch.rand(4, generator=gen))
