"""The hand kernels as `torch.library` custom ops, on the CPU.

`bdd100k_tpu_torch::greedy_suppress` (ops/nms.py) and
`bdd100k_tpu_torch::depthwise3x3_s1` (ops/depthwise.py) are what the eager
path, CUDA graphs and exported artifacts call: their CUDA implementations
launch the kernels, their CPU implementations run the plain versions, and
their fake implementations give `torch.export` the output's shape and
type. Here `torch.library.opcheck` checks each op's registration (schema,
fake tensor, autograd registration, AOT dispatch with dynamic shapes), and
the op, the route the models call and the plain version give equal
results, from the same numpy inputs.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bdd100k_tpu_torch.ops import depthwise, nms  # noqa: E402

torch.set_num_threads(2)


def _nms_inputs(seed: int, b: int = 2, c: int = 3, k: int = 37):
    """Score-descending corner boxes with overlaps, a few invalid rows."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0.0, 0.7, (b, c, k, 2))
    wh = rng.uniform(0.05, 0.3, (b, c, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.uniform(size=(b, c, k)) > 0.15
    return torch.from_numpy(boxes), torch.from_numpy(valid)


def _dw_inputs(seed: int, dtype=torch.float32, shape=(2, 7, 9, 16)):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, shape[-1])).astype(np.float32))
    return x.to(dtype), k.to(dtype)


def test_ops_are_registered_under_the_package_namespace():
    assert torch.ops.bdd100k_tpu_torch.greedy_suppress.default is not None
    assert torch.ops.bdd100k_tpu_torch.depthwise3x3_s1.default is not None


@pytest.mark.parametrize("seed", [0, 1])
def test_opcheck_greedy_suppress(seed):
    boxes, valid = _nms_inputs(seed)
    torch.library.opcheck(torch.ops.bdd100k_tpu_torch.greedy_suppress.default,
                          (boxes, valid, 0.45))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_depthwise3x3_s1(dtype):
    x, k = _dw_inputs(0, dtype)
    torch.library.opcheck(torch.ops.bdd100k_tpu_torch.depthwise3x3_s1.default,
                          (x, k))


@pytest.mark.parametrize("seed,thr", [(0, 0.45), (1, 0.3), (2, 0.15)])
def test_greedy_suppress_op_route_and_plain_agree(seed, thr):
    boxes, valid = _nms_inputs(seed)
    op = torch.ops.bdd100k_tpu_torch.greedy_suppress(boxes, valid, thr)
    route = nms.greedy_suppress(boxes, valid, thr)
    plain = nms.greedy_keep_mask(boxes, valid, thr)
    assert op.dtype == torch.bool and op.shape == valid.shape
    assert torch.equal(op, plain) and torch.equal(route, plain)
    assert 0 < int(plain.sum()) < int(valid.sum())  # something was suppressed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 9, 16), (1, 1, 1, 8), (3, 5, 4, 24)])
def test_depthwise_op_route_and_plain_agree(dtype, shape):
    x, k = _dw_inputs(3, dtype, shape)
    op = torch.ops.bdd100k_tpu_torch.depthwise3x3_s1(x, k)
    route = depthwise.depthwise3x3_s1(x, k)
    plain = depthwise.depthwise3x3_s1_plain(x, k)
    assert op.dtype == dtype and op.shape == x.shape
    assert torch.equal(op, plain) and torch.equal(route, plain)
    # the layer's entry: the op at inference, the autograd Function (whose
    # forward is the op) when a gradient is wanted
    kernel = k.reshape(3, 3, 1, shape[-1])
    with torch.no_grad():
        assert torch.equal(depthwise.depthwise_conv3x3(x, kernel), plain)
    xg = x.clone().requires_grad_(True)
    assert torch.equal(depthwise.depthwise_conv3x3(xg, kernel).detach(), plain)


def test_depthwise_op_takes_a_strided_input():
    """The op makes its input contiguous itself: an exported graph need
    not hand it the layout it was traced with."""
    x, k = _dw_inputs(4)
    xt = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    assert not xt.is_contiguous()
    assert torch.equal(torch.ops.bdd100k_tpu_torch.depthwise3x3_s1(xt, k),
                       depthwise.depthwise3x3_s1_plain(x, k))

