"""Core of the PyTorch port held against the JAX package: codecs, cost
accounting, the host run loop and the run-log format."""
import io
import json

import numpy as np
import pandas as pd
import pytest

import flexs_tpu
import flexs_tpu_torch
from flexs_tpu import explorer as jax_explorer
from flexs_tpu_torch import explorer as torch_explorer


@pytest.mark.parametrize("letters", ["ILVAGMFYWEDQNHCRKSTP", "UGCA", "TGCA", "01"])
def test_alphabet_codec_matches_jax(letters):
    port, ref = flexs_tpu_torch.Alphabet(letters), flexs_tpu.Alphabet(letters)
    rng = np.random.default_rng(len(letters))
    seqs = ["".join(rng.choice(list(letters), 9)) for _ in range(7)]
    tokens = port.encode(seqs)
    np.testing.assert_array_equal(tokens, ref.encode(seqs))
    assert tokens.dtype == np.int32
    assert port.decode(tokens) == ref.decode(tokens) == seqs
    assert port.decode_one(tokens[0]) == seqs[0]
    assert port == letters and hash(port) == hash(ref)


def test_alphabet_rejects_bad_input():
    alpha = flexs_tpu_torch.Alphabet(flexs_tpu_torch.DNAA)
    with pytest.raises(ValueError):
        alpha.encode(["TGCX"])
    with pytest.raises(ValueError):
        alpha.encode(["TG", "TGC"])
    with pytest.raises(TypeError):
        alpha.encode("TGCA")


class FakeLandscape(flexs_tpu_torch.Landscape):
    def __init__(self):
        super().__init__(name="FakeLandscape")
        self.rng = np.random.default_rng(0)

    def _fitness_function(self, sequences):
        return self.rng.random(size=len(sequences))


def test_cost_accounting():
    landscape = FakeLandscape()
    landscape.get_fitness(["AAA", "CCC"])
    landscape.get_fitness(["GGG"])
    assert landscape.cost == 3
    with pytest.raises(NotImplementedError):
        landscape.fitness_from_tokens(np.zeros((1, 3)))


def test_landscape_as_model_no_double_count():
    landscape = FakeLandscape()
    model = flexs_tpu_torch.LandscapeAsModel(landscape)
    model.get_fitness(["AAAA"])
    assert model.cost == 1
    assert landscape.cost == 0  # inner _fitness_function called directly
    assert model.name == "LandscapeAsModel=FakeLandscape"


def _explorer_class(pkg):
    class Fixed(pkg.Explorer):
        """Proposes the same deterministic batch each round."""

        def propose_sequences(self, measured):
            r = measured["round"].max() + 1
            seqs = np.array([f"{r}{c}AA" for c in "ACGT"])
            self.model.cost += 10
            return seqs, np.arange(4, dtype=np.float64) / r

    return Fixed


class _Const:
    def __init__(self, pkg):
        class Model(pkg.Model):
            def __init__(self):
                super().__init__(name="Const")

            def train(self, *args):
                pass

            def _fitness_function(self, sequences):
                return np.full(len(sequences), 0.5)

        class Landscape(pkg.Landscape):
            def __init__(self):
                super().__init__(name="Hash")

            def _fitness_function(self, sequences):
                return np.array([sum(map(ord, s)) / 1000 for s in sequences])

        self.model, self.landscape = Model(), Landscape()


def _run(pkg, log_file):
    c = _Const(pkg)
    explorer = _explorer_class(pkg)(
        c.model, "Fixed", rounds=3, sequences_batch_size=4,
        model_queries_per_batch=10, starting_sequence="0AAA", log_file=log_file,
    )
    return explorer.run(c.landscape, verbose=False), c.landscape.cost


def test_run_loop_and_log_match_jax(tmp_path):
    (df_t, meta_t), cost_t = _run(flexs_tpu_torch, str(tmp_path / "torch.csv"))
    (df_j, meta_j), cost_j = _run(flexs_tpu, str(tmp_path / "jax.csv"))
    pd.testing.assert_frame_equal(df_t, df_j)
    meta_t.pop("run_id"), meta_j.pop("run_id")
    assert meta_t == meta_j and cost_t == cost_j == 13
    lines_t = (tmp_path / "torch.csv").read_text().splitlines()
    lines_j = (tmp_path / "jax.csv").read_text().splitlines()
    assert json.loads(lines_t[0])["exp_name"] == "Fixed"
    assert lines_t[1:] == lines_j[1:]


def test_write_run_log_is_byte_identical(tmp_path):
    df = pd.DataFrame({
        "sequence": ["UGCA", "AAAA", "CGCG"],
        "model_score": [np.nan, 0.125, 1 / 3],
        "true_score": [0.5, -0.25, 2.0 / 7],
        "round": [0, 1, 1],
        "model_cost": [0, 20, 20],
        "measurement_cost": [1, 3, 3],
    })
    meta = {"run_id": "12:00:00-01/01/2026", "exp_name": "x", "rounds": 1}
    torch_explorer.write_run_log(str(tmp_path / "a" / "t.csv"), meta, df)
    jax_explorer.write_run_log(str(tmp_path / "b" / "j.csv"), meta, df)
    port = (tmp_path / "a" / "t.csv").read_bytes()
    assert port == (tmp_path / "b" / "j.csv").read_bytes()
    header = io.StringIO(port.decode()).readline()
    assert json.loads(header) == meta
