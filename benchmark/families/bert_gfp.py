"""GFP on the port: the BERT oracle with the weights the benchmark made, its spans and its control."""
import contextlib
import os
import warnings

import torch

from benchmark.reference import bert_gfp as reference_bert
from flexs_tpu_torch.landscapes import bert_gfp

ORACLE_TARGETS = [(bert_gfp, "_gfp_fitness")]


def make_inputs(config, device):
    """The oracle's weights, drawn on the device from the configuration's `weights_seed`.

    One oracle for every run, as a trained checkpoint is; the reference gets
    the same tensors.
    """
    return {"weights": reference_bert.make_weights(config, config["weights_seed"], device)}


def landscape(config, inputs, device):
    """`BertGFPBrightness` at the configuration's widths, its weights replaced by `inputs`'.

    The constructor first fills its own seeded weights on the CPU; no
    checkpoint lies at the path it is given.
    """
    heads, inter = config["hidden"] // 64, 4 * config["hidden"]
    if (heads, inter) != (config["heads"], config["intermediate"]):
        raise ValueError("BertGFPBrightness derives heads = hidden / 64 and FFN = 4 x hidden")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        land = bert_gfp.BertGFPBrightness(
            model_path=os.path.join(".bench_cache", "no-checkpoint"),
            batch_size=config["oracle_rows_per_pass"], hidden=config["hidden"],
            layers=config["layers"], device=device,
        )
    if land.module.max_len != config["positions"]:
        raise ValueError(f"the port pads to {land.module.max_len} positions, "
                         f"the configuration states {config['positions']}")
    land.module.load_state_dict(inputs["weights"])
    return land


@contextlib.contextmanager
def control(reference, device):
    """The program's own lower-precision path switched on: TF32 matrix products."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
