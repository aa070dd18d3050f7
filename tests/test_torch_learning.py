"""The port learns as ``tumseg`` learns: from the same initial weights, on
the same 30 batches of facade blocks (colour on, 8 classes, weighted NLL,
Adam at 1e-3), ``tumseg``'s jitted train step and the port's
``TrainEngine.train_batch`` take loss trajectories that stay together.
Nothing is drawn on either side (train-mode BN, FPS from index 0, no
dropout, no rotation), and both gather exactly, as ``tumseg``'s CPU step
does.

The two trajectories agree closely only at the start: each step's
gradients differ in the last bits (``tests/test_torch_train.py`` says
why) and Adam's normalised updates make that grow, so after ~10 steps the
losses of one step may be 10% apart. What a fault of the training step
would move (the learning rate, the loss's weights, a gradient lost in one
layer) is the level of the whole curve: the mean loss over the 30 steps
is held within 5% and over the last 10 within 20%, and both must fall.
JAX compiles one step function in this module (B=4, N=256)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tumseg.models import pointnet2_sem_seg as jmodel
from tumseg.train import loop as jloop
from tumseg_torch.data.dataset import TrainBlockDataset
from tumseg_torch.models.convert import state_dict_from_variables
from tumseg_torch.models.pointnet2_sem_seg import get_model
from tumseg_torch.tools.miou_parity import make_tiles
from tumseg_torch.train import loop as tloop

B, N, C, STEPS, LR, WD = 4, 256, 8, 30, 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """30 batches of blocks of ``make_tiles``' small tiles at seed 0, each
    drawn from its own seeded stream; the training split's label weights
    (a class the tiles lack weighs inf and is never a target)."""
    train_paths, _ = make_tiles(str(tmp_path_factory.mktemp("tiles")), 0,
                                points=14000, color=True)
    ds = TrainBlockDataset(train_paths, num_classes=C, num_point=N,
                           color=True, class8=True, seed=0)
    rng = np.random.default_rng(0)
    out = []
    for step in range(STEPS):
        items = [ds.sample(int(i), np.random.default_rng([0, step, int(i)]))
                 for i in rng.integers(0, len(ds), B)]
        out.append((np.stack([x for x, _ in items]).astype(np.float32),
                    np.stack([t for _, t in items]).astype(np.int32)))
    return out, ds.calculate_labelweights().astype(np.float32)


def _tumseg_losses(var, batches, weights):
    tx = jloop.make_optimizer("Adam", weight_decay=WD)
    jw = jnp.asarray(weights)

    @jax.jit
    def step(params, stats, opt_state, x, t):
        def loss_fn(p):
            logp, aux, new_stats = jmodel.apply(
                {"params": p, "batch_stats": stats}, x, training=True,
                bn_momentum=0.1, rngs={})
            return jmodel.loss(logp, t, aux, jw), new_stats

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(
            params, jax.tree_util.tree_map(lambda u: u * LR, updates))
        return params, new_stats, opt_state, loss

    params, stats = var["params"], var["batch_stats"]
    opt_state = tx.init(params)
    losses = []
    for x, t in batches:
        params, stats, opt_state, loss = step(
            params, stats, opt_state, jnp.asarray(x), jnp.asarray(t))
        losses.append(float(loss))
    return np.asarray(losses)


def _port_losses(var, batches, weights):
    """The port's ``TrainEngine`` step on the CPU with nothing drawn."""
    model = get_model(C, 3)
    model.load_state_dict(state_dict_from_variables(var), strict=True)
    engine = tloop.TrainEngine(model, C, weights, weight_decay=WD,
                               augment_rotate=False, device="cpu",
                               exact_gathers=True)
    engine.generator = None
    return np.asarray([float(engine.train_batch(x, t, LR, 0.1)[0])
                       for x, t in batches])


def test_port_learns_as_tumseg_learns(batches):
    data, weights = batches
    var = jax.tree_util.tree_map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(0), C, 3))
    want = _tumseg_losses(var, data, weights)
    got = _port_losses(var, data, weights)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert got.mean() == pytest.approx(want.mean(), rel=0.05)
    assert got[-10:].mean() == pytest.approx(want[-10:].mean(), rel=0.2)
    for losses in (got, want):
        assert losses[-10:].mean() < 0.6 * losses[:5].mean()
