"""BatchNorm (+ ReLU) on the CPU: the plain path of ``nn.layers.BatchNorm``
(``ops.core.batch_norm``) against the formula it replaced, bit for bit, in
train and eval, with the ReLU and the cast to the compute dtype fused or
not, running stats included; the models' call sites (one ``ops.batch_norm``
a layer, the ReLU fused where the layer has one); the kernel wrappers'
refusal of CPU tensors; the backward written out op by op (the kernels'
contract) bitwise autograd's; the geometry of ``csrc/batch_norm.cu``'s
launches; and the ``batch_norm_plain`` count through a graph's tallies. The
kernels themselves run only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from tumseg_torch import ops
from tumseg_torch.nn.layers import BatchNorm
from tumseg_torch.ops import kernels


def _replaced_forward(bn, x, relu, dtype):
    """The BatchNorm forward and its call site before the ReLU and the
    cast moved into it: ``F.relu(bn(x))``, then ``.to(dtype)``."""
    in_dtype = x.dtype
    x = x.to(torch.promote_types(in_dtype, torch.float32))
    if not bn.training:
        inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        y = ((x - bn.running_mean) * inv + bn.bias).to(in_dtype)
    else:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        sqmean = (x * x).mean(dim=dims)
        n = x.numel() // x.shape[-1]
        var = sqmean - mean * mean
        with torch.no_grad():
            m, keep = bn.momentum, bn.momentum_keep
            unbiased = var * (n / max(n - 1, 1))
            bn.running_mean.copy_(keep * bn.running_mean + m * mean)
            bn.running_var.copy_(keep * bn.running_var + m * unbiased)
            bn.num_batches_tracked += 1
        inv = torch.rsqrt(var + bn.eps) * bn.weight
        y = ((x - mean) * inv + bn.bias).to(in_dtype)
    if relu:
        y = F.relu(y)
    return y if dtype is None else y.to(dtype)


def _bn(seed):
    r = np.random.default_rng(seed)
    bn = BatchNorm(16, momentum=0.3)
    with torch.no_grad():
        for t, lo in ((bn.weight, 0.5), (bn.bias, -0.5),
                      (bn.running_mean, -0.5), (bn.running_var, 0.5)):
            t.copy_(torch.from_numpy(r.random(16).astype(np.float32) + lo))
    return bn


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_path_is_the_replaced_formula(relu, training, dtype, in_dtype):
    """Output, the gradients of x, weight and bias, the running stats and
    the batch count: bit for bit, two calls in a row."""
    r = np.random.default_rng(3)
    x0 = torch.from_numpy((r.standard_normal((2, 5, 4, 16)) * 3 + 1)
                          ).to(in_dtype)
    got_bn, want_bn = _bn(1), _bn(1)
    got_bn.train(training)
    want_bn.train(training)
    for _ in range(2):
        results = []
        for bn, call in ((got_bn, lambda b, x: b(x, relu=relu, dtype=dtype)),
                         (want_bn, lambda b, x: _replaced_forward(
                             b, x, relu, dtype))):
            x = x0.clone().requires_grad_()
            y = call(bn, x)
            g = torch.ones_like(y).cumsum(-1) / 16 - 0.4
            grads = torch.autograd.grad(y, (x, bn.weight, bn.bias), g)
            results.append((y,) + grads)
        for got, want in zip(*results):
            assert got.dtype == want.dtype
            assert torch.equal(got, want)
        for name in ("running_mean", "running_var", "num_batches_tracked"):
            assert torch.equal(getattr(got_bn, name), getattr(want_bn, name))


@pytest.mark.parametrize("name,layers,no_relu", [
    ("pointnet2_sem_seg", 22, 0), ("pointnet2_sem_seg_msg", 34, 0),
    ("pointnet_sem_seg", 16, 1)])
def test_models_fuse_the_relu_into_each_batch_norm(monkeypatch, name, layers,
                                                   no_relu):
    """One ``ops.batch_norm`` a layer, the ReLU fused into all but
    PointNet's bn3 (which has none); with a bf16 compute dtype the layers
    whose output only a Dense reads store bf16, as the cast after them
    did: every MLP layer but a stack's last, and PointNet's STN and head
    convs, conv2 and the head's three."""
    import importlib

    calls = []
    plain = ops.batch_norm

    def spy(x, *args, relu=False, dtype=None, **kw):
        calls.append((relu, dtype))
        return plain(x, *args, relu=relu, dtype=dtype, **kw)

    monkeypatch.setattr(ops, "batch_norm", spy)
    mod = importlib.import_module(f"tumseg_torch.models.{name}")
    torch.manual_seed(0)
    model = mod.get_model(8).eval()
    x = torch.rand(1, 1024, 6)
    with torch.no_grad():
        model(x)
        assert len(calls) == layers
        assert [relu for relu, _ in calls].count(False) == no_relu
        assert all(dtype is None for _, dtype in calls)
        calls.clear()
        model(x, compute_dtype=torch.bfloat16)
    stores = [dtype for _, dtype in calls]
    want = {"pointnet2_sem_seg": 22 - 9, "pointnet2_sem_seg_msg": 34 - 13,
            "pointnet_sem_seg": 2 + 2 + 1 + 3}[name]
    assert stores.count(torch.bfloat16) == want
    assert stores.count(None) == layers - want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(2, 64, 16, 32), (3, 500, 48), (37, 20),
                                   (2, 8, 4, 196)])
def test_backward_written_out_is_autograd(shape, relu, training, dtype):
    """``core.batch_norm_terms``, their row sums, ``core.batch_norm_grads``
    and ``core.batch_norm_dx`` (x's gradient in eval is the third term)
    give autograd's gradients of ``core.batch_norm`` bit for bit: the
    contract of the backward kernels, which compute the terms and dx, and
    the [C] ops that their path runs as written."""
    from tumseg_torch.ops import core

    torch.manual_seed(len(shape) + shape[-1])
    C = shape[-1]
    x = (torch.randn(shape) * 2 + 3).requires_grad_()
    w = (torch.rand(C) + 0.5).requires_grad_()
    b = torch.randn(C).requires_grad_()
    rm, rv = torch.randn(C), torch.rand(C) + 0.5
    mom = torch.tensor(0.1, dtype=torch.float64)
    y = core.batch_norm(x, w, b, rm.clone(), rv.clone(), mom, 1 - mom, 1e-5,
                        training, relu=relu, dtype=dtype)
    g = torch.randn(shape).to(y.dtype)
    want = torch.autograd.grad(y, (x, w, b), g)
    x, w, b = x.detach(), w.detach(), b.detach()
    dims = tuple(range(len(shape) - 1))
    if training:
        mean = x.mean(dim=dims)
        var = (x * x).mean(dim=dims) - mean * mean
    else:
        mean, var = rm, rv
    r = torch.rsqrt(var + 1e-5)
    terms = core.batch_norm_terms(g, x, mean, r * w, b, relu)
    dweight, dbias, ks, kmu = core.batch_norm_grads(
        [t.sum(dim=dims) for t in terms], mean, r, w, x.numel() // C,
        training)
    assert (ks is None) == (not training)
    dx = terms[2] if ks is None else core.batch_norm_dx(terms[2], x, ks, kmu)
    for got, ref in zip((dx, dweight, dbias), want):
        assert torch.equal(got, ref)


def test_kernel_wrappers_refuse_cpu_tensors():
    x, c = torch.rand(8, 4), torch.rand(4)
    kernels.reset_launches()
    for call in (lambda: kernels.bn_apply(x, c, c, c, True),
                 lambda: kernels.bn_backward_terms(x, x, c, c, c, True),
                 lambda: kernels.bn_backward_dx(x, x, c, c)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert not any(kernels.launches.values())


def test_cpu_batch_norm_counts_nothing():
    """``ops.batch_norm`` on the CPU is ``core.batch_norm`` and no plain call
    is counted: the count is of CUDA tensors on the plain path."""
    kernels.reset_launches()
    bn = _bn(2).train()
    x = torch.rand(3, 7, 16)
    want = _replaced_forward(_bn(2).train(), x, True, None)
    assert torch.equal(bn(x, relu=True), want)
    assert kernels.plain_calls == {"batch_norm_plain": 0}
    assert not any(kernels.launches.values())


# (M, C) of the models' BatchNorms at B=32 and 16 (sa1 ... the head), and
# ragged ones
BN_SHAPES = [(1048576, 32), (524288, 64), (262144, 128), (65536, 256),
             (16384, 512), (2048, 256), (131072, 128), (32768, 196),
             (32, 1024), (16, 256), (1, 32), (7, 3), (1000, 1030),
             (300, 1040), (5, 1)]


@pytest.mark.parametrize("M,C,vec", [
    (M, C, vec) for M, C in BN_SHAPES for vec in (True, False)
    if not vec or C % 4 == 0])
def test_bn_geometry(M, C, vec):
    """The column tiles cover C, R rows of a tile's threads fit a block,
    and the grid gives each thread a full unroll at least once and stays
    within the card's resident blocks. (The vector path takes C % 4 == 0
    alone.)"""
    V, tiles, R = kernels.bn_layout(C, vec)
    tile = min(C // V, kernels.BN_THREADS)
    assert V == (4 if vec else 1)
    assert (tiles - 1) * tile < C // V <= tiles * tile
    assert 1 <= R and R * tile <= kernels.BN_THREADS
    blocks = kernels.bn_blocks(M, C, vec)
    assert 1 <= blocks <= max(1, -(-M // (R * kernels.BN_UNROLL)))
    assert blocks * tiles <= max(tiles, 8 * kernels.SMS)


def test_plain_calls_follow_the_graph_tallies():
    """A plain call counts live, or in the tally of the graph being
    captured, which each replay adds; reset_launches clears it."""
    kernels.reset_launches()
    kernels.count_plain("batch_norm_plain")
    with kernels.capturing() as tally:
        kernels.count_plain("batch_norm_plain")
        kernels.count_plain("batch_norm_plain")
    assert kernels.plain_calls["batch_norm_plain"] == 1
    assert tally[2]["batch_norm_plain"] == 2
    kernels.replayed(tally)
    kernels.replayed(tally)
    assert kernels.plain_calls["batch_norm_plain"] == 5
    kernels.reset_launches()
    assert kernels.plain_calls["batch_norm_plain"] == 0
