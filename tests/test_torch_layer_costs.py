"""Port parity: ``layer_costs`` of ``deeplearning4j_tpu_torch.models.
transformer`` against the JAX package's, row for row.

Exact: both compute the same float64 arithmetic from the same integers.
"""

import jax.numpy as jnp
import pytest
import torch

from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu_torch.models import layer_costs
from deeplearning4j_tpu_torch.models import transformer as T
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

CONFIGS = {"tiny": (J.TransformerConfig.tiny, T.TransformerConfig.tiny),
           "bert_base": (J.TransformerConfig.bert_base, T.TransformerConfig.bert_base)}
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("positions", [None, 19])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_layer_costs_equal_jax_row_for_row(config, train, positions, dtype):
    jd, td = DTYPES[dtype]
    jcfg = CONFIGS[config][0](compute_dtype=jd)
    tcfg = CONFIGS[config][1](compute_dtype=td)
    ref = J.layer_costs(jcfg, 16, 128, positions, train=train)
    got = layer_costs(tcfg, 16, 128, positions, train=train)
    assert got == ref
    assert [r["layer"] for r in got] == ["embed"] + [f"block{i}" for i in range(
        tcfg.n_layers)] + ["mlm_head"]


def test_train_flops_are_three_times_the_forward():
    cfg = T.TransformerConfig.bert_base()
    fwd = sum(r["flops"] for r in layer_costs(cfg, 16, 128, 19, train=False))
    train = sum(r["flops"] for r in layer_costs(cfg, 16, 128, 19, train=True))
    assert train == pytest.approx(3 * fwd)
    # the flagship's training step: about 1.13 TFLOP (16 x 128 tokens, 12
    # blocks, the head at 19 positions a row)
    assert 1.0e12 < train < 1.3e12
