"""The ``data`` mesh's programs made ready for CUDA graphs, on the CPU.

On an NCCL mesh of CUDA devices the training engine and the serving runner
run their train, eval, room-id and vote programs as CUDA graphs with the
mesh's collectives inside (``tumseg_torch/utils/graphs.py``);
``chip_smoke.py`` [y] holds them bit for bit against ``cuda_graphs=False``
on a one-rank NCCL group. Here two gloo ranks (``tests/
torch_mesh_graph_ranks.py``, one thread a rank) put a stand-in with
``StepGraphs.run``'s signature into ``engine.graphs`` and
``runner.graphs``; it runs each program eagerly and records its key, and
every ``Mesh.all_reduce_`` and ``Mesh.broadcast_`` is counted by where it
was issued. The tests check what a capture with collectives needs:

- every collective of a train step (tumseg's ``rngs={}`` SGD step, and
  Adam with draws and fast gathers), an eval step, room-id calls of k = 1
  and 4 with ``eval_batch_rooms``, and two votes on each of the three
  paths is issued inside a program; outside, only ``broadcast_state`` and
  the host draws' broadcasts;
- both ranks call the same program keys in the same order;
- the results are bitwise those of the eager mesh, and the SGD step is
  within tests/test_torch_parallel.py's tolerances of ``tumseg``'s
  ``jax.jit(shard_map(step))`` on a 2-device mesh;
- the ranks' key check passes equal keys and raises on both ranks for a
  rank-dependent one;
- the capturable-mesh predicate is true for NCCL on CUDA only.

JAX compiles one function here: tumseg's sharded train step (B=4, N=256)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tumseg.models import pointnet2_sem_seg as jmodel
from tumseg.parallel import make_mesh as jax_make_mesh
from tumseg.train import loop as jloop
from tumseg_torch.models.convert import (state_dict_from_variables,
                                         variables_from_state_dict)
from tumseg_torch.parallel import mesh as pmesh

B, N, C = 4, 256, 8
LR = 1e-3
ENGINE_RUNS = ("train", "train_draws", "eval", "rooms_k1", "rooms_k4")
VOTE_RUNS = ("vote_host", "vote_features", "vote_reblock")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch():
    r = np.random.default_rng(1)
    x = (r.random((B, N, 6)) - 0.5).astype(np.float32)
    t = r.integers(0, C, (B, N)).astype(np.int64)
    w = (r.random(C) + 0.5).astype(np.float32)
    var = jax.tree_util.tree_map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(0), C, 0))
    return x, t, w, var


@pytest.fixture(scope="module")
def ranks(batch, tmp_path_factory):
    import torch_mesh_graph_ranks

    out_dir = tmp_path_factory.mktemp("mesh_graph_keys")
    x, t, w, var = batch
    out = pmesh.spawn(torch_mesh_graph_ranks.run, 2,
                      (var, x, t, w, str(out_dir)), backend="gloo",
                      threads=1, timeout=900)
    out["keys"] = [json.loads((out_dir / f"keys{r}.json").read_text())
                   for r in range(2)]
    return out


@pytest.fixture(scope="module")
def jax_step(batch):
    """tumseg's train step under ``shard_map`` on a 2-device mesh, as its
    engine builds it, with ``rngs={}`` (FPS from 0, no dropout)."""
    from jax.sharding import PartitionSpec as P

    x, t, w, var = batch
    tx = jloop.make_optimizer("SGD")
    jw = jnp.asarray(w)

    def step(params, stats, opt_state, x, t):
        def loss_fn(p):
            logp, aux, new_stats = jmodel.apply(
                {"params": p, "batch_stats": stats}, x, training=True,
                bn_momentum=0.1, rngs={}, axis_name="data")
            return jmodel.loss(logp, t, aux, jw, axis_name="data"), new_stats

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return loss, grads, new_stats

    sharded = jax.jit(jax.shard_map(
        step, mesh=jax_make_mesh(2),
        in_specs=(P(), P(), P(), P("data"), P("data")),
        out_specs=(P(), P(), P()), check_vma=True))
    loss, grads, stats = sharded(
        var["params"], var["batch_stats"], tx.init(var["params"]),
        jnp.asarray(x), jnp.asarray(t.astype(np.int32)))
    return dict(loss=float(loss), grads=grads, stats=stats)


def _as_tumseg(arrays, var):
    """Port arrays by parameter or buffer name as a tumseg tree."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict_from_variables(
        var).items()}
    sd.update({k: torch.as_tensor(v) for k, v in arrays.items()})
    return variables_from_state_dict(sd)


def test_capturable_predicate_is_nccl_on_cuda_only(ranks):
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert pmesh.collectives_capturable("nccl", cuda)
    assert pmesh.collectives_capturable("nccl", "cuda:1")
    for backend, device in (("gloo", cuda), ("nccl", cpu), ("gloo", cpu),
                            ("mpi", cuda)):
        assert not pmesh.collectives_capturable(backend, device)
    assert ranks["capturable"] is False      # the gloo CPU mesh itself


@pytest.mark.parametrize("run", ENGINE_RUNS + VOTE_RUNS)
def test_every_collective_is_inside_a_program(ranks, run):
    log = ranks[run]["log"]
    inside = [op for op, where in log if where == "program"]
    outside = [op for op, where in log if where is None]
    assert "all_reduce_" in inside
    assert outside == []
    allowed = {op for op, where in log if where == "allowed"}
    assert allowed <= {"broadcast_"}
    if run == "vote_reblock":
        assert not allowed      # every rank draws; nothing is broadcast
    elif run in ("vote_host", "vote_features"):
        assert allowed == {"broadcast_"}


@pytest.mark.parametrize("run", ENGINE_RUNS + VOTE_RUNS)
def test_ranks_call_the_same_programs(ranks, run):
    mine, other = (k[run] for k in ranks["keys"])
    assert mine == other and mine
    kinds = {k.split(",")[0].strip("('") for k in mine}
    want = {"train": {"train"}, "train_draws": {"train"}, "eval": {"eval"},
            "rooms_k1": {"train_rooms", "eval_rooms"},
            "rooms_k4": {"train_rooms", "eval_rooms"},
            "vote_host": {"host_chunk", "vote_reduce"},
            "vote_features": {"vote_chunk", "vote_reduce"},
            "vote_reblock": {"reblock", "vote_chunk", "vote_reduce"}}[run]
    assert kinds == want
    if run.startswith("vote"):
        assert sum(k.startswith("('vote_reduce'") for k in mine) == 2


@pytest.mark.parametrize("run", ENGINE_RUNS)
def test_engine_programs_bitwise_the_eager_mesh(ranks, run):
    got, want = ranks[run]["programs"], ranks[run]["eager"]
    assert len(got["calls"]) == len(want["calls"])
    for g, w in zip(got["calls"], want["calls"]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert got["state"].keys() == want["state"].keys()
    for k in want["state"]:
        np.testing.assert_array_equal(got["state"][k], want["state"][k],
                                      err_msg=k)


@pytest.mark.parametrize("run", VOTE_RUNS)
def test_vote_programs_bitwise_the_eager_mesh(ranks, run):
    got, want = ranks[run]["programs"], ranks[run]["eager"]
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["pool"], want["pool"])
    assert got["pool"].sum() > 0


def test_mesh_program_step_matches_tumseg_mesh_step(ranks, jax_step, batch):
    """The SGD step run through the stand-in against tumseg's sharded
    step: the loss within rtol 1e-4, the gradient within 20% in norm, BN
    running statistics within 1e-4 (tests/test_torch_parallel.py's bounds,
    which that file explains)."""
    step = ranks["train"]["programs"]
    np.testing.assert_allclose(step["calls"][0][0], jax_step["loss"],
                               rtol=1e-4)
    got = jax.tree_util.tree_leaves(_as_tumseg(step["grads"],
                                               batch[3])["params"])
    want = jax.tree_util.tree_leaves(jax_step["grads"])
    assert len(got) == len(want)
    diff = np.concatenate([np.ravel(np.asarray(g) - np.asarray(j))
                           for g, j in zip(got, want)])
    ref = np.concatenate([np.ravel(np.asarray(j)) for j in want])
    assert np.linalg.norm(diff) <= 0.2 * np.linalg.norm(ref)
    stats = _as_tumseg(step["stats"], batch[3])["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves(stats),
                    jax.tree_util.tree_leaves(jax_step["stats"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-4)


def test_ranks_refuse_differing_program_keys(ranks):
    assert "would capture another program than rank 0" in \
        ranks["differing_key"]
    assert [op for op, _ in ranks["agreed_log"]] == [
        "broadcast_", "all_reduce_"] * 2


def test_describe_key_names_objects_by_type():
    from tumseg_torch.utils.graphs import describe_key

    key = ("train", (4, 256, 6), torch.Generator(), None, torch.bfloat16,
           2.5, True, ((1, 3), (2, 5)))
    assert describe_key(key) == ("('train', (4, 256, 6), Generator, None, "
                                 "torch.bfloat16, 2.5, True, ((1, 3), "
                                 "(2, 5)))")
