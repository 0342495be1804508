"""The port's data-parallel path on the CPU: one spawn of two gloo ranks
(tests/torch_dist_worker.py, started with torchrun's environment) against
the same code as one process without a group, and the group's BatchNorm
and masked loss against the JAX functions on the global batch.

Two train steps of a narrow DFormer + ham (DropPath 0.1, dropout, fresh
NMF bases, the device augmentation) on a global batch of 4 whose last two
rows are mostly ignored (255): the ranks' losses, parameters and BatchNorm
statistics equal the world-1 run's to 1e-6 of each leaf's max |value|, or
of 0.1 for the leaves whose values stay below it (fp32: the group sums two
partial sums where one process sums once; measured: at most 2.4e-7
absolute, 3.4e-7 of that scale); a
step resumed from rank 0's checkpoint equals the uninterrupted one bit for
bit; the summed hist of a sharded evaluation of 5 images equals the
world-1 hist exactly. The workers start in parallel with the world-1 run;
the whole file takes ~15 s."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dformer_tpu.models.nn import BatchNorm as JBatchNorm
from dformer_tpu.ops.loss import softmax_cross_entropy_masked_mean as j_loss

import torch_dist_worker as worker

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dist_worker.py")
WORLD = 2
TIMEOUT_S = 240
STATE_REL = 1e-6   # of each leaf's max |value|, world 2 against world 1,
STATE_FLOOR = 0.1  # or of this: leaves that stay near 0 (a BatchNorm's
                   # running mean of normalised inputs, 1e-7; a bias that a
                   # BatchNorm follows, 2e-9) hold rounding noise
LOSS_REL = 1e-6
GRAD_REL = 1e-5    # of max: one step's gradient, world 2 against world 1
                   # (measured 1.1e-6 trained, 3.0e-6 frozen: fp32 sums)
JAX_REL = 1e-5     # BatchNorm output and input gradient, loss gradient
JAX_STATS_REL = 1e-6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank records of the 2-process run, the world-1 record, the JAX
    references), the last two made while the workers run."""
    out = str(tmp_path_factory.mktemp("world2"))
    port = str(_free_port())
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(WORLD), LOCAL_WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    threads = torch.get_num_threads()
    try:
        with pytest.MonkeyPatch.context() as mp:
            for key in ("RANK", "WORLD_SIZE"):
                mp.delenv(key, raising=False)
            one = worker.run(str(tmp_path_factory.mktemp("world1")))
        jax_refs = _jax_references()
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return ranks, one, jax_refs


def _close(got, want, rel, name, floor=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), floor)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{name}: {err:.3g} of max > {rel}"


def test_group_setup_and_rank_gates(runs):
    """Both ranks joined one group, share rank 0's run directories, log at
    INFO with a file on rank 0 only and WARNING without one above it,
    write TensorBoard on rank 0 only, and synced the gradients of every
    step (3: two steps, and step 2 again after the restore)."""
    ranks, one, _ = runs
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["world"] == WORLD for r in ranks) and one["world"] == 1
    assert ranks[0]["run_dirs"] == ranks[1]["run_dirs"]
    assert [(r["log_level"], r["log_files"], r["tb_writes"])
            for r in ranks] == [(20, 1, ranks[0]["tb_writes"]),
                                (30, 0, False)]
    assert [r["grad_syncs"] for r in ranks] == [3, 3]
    assert one["grad_syncs"] == 0


def test_two_ranks_take_the_world_1_steps(runs):
    """Per-step losses, every parameter and every BatchNorm running
    statistic after two steps: both ranks hold the same values, and those
    equal the world-1 run's to STATE_REL of each leaf's max |value| (or of
    STATE_FLOOR)."""
    ranks, one, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=LOSS_REL,
                                   atol=0)
    for name, want in one["state"].items():
        assert torch.equal(ranks[0]["state"][name], ranks[1]["state"][name]),\
            name
        if want.dtype.is_floating_point:
            _close(ranks[0]["state"][name], want, STATE_REL, name,
                   STATE_FLOOR)
        else:
            assert torch.equal(ranks[0]["state"][name], want), name


def test_resume_from_the_rank_0_checkpoint(runs):
    """Step 2 taken again from the checkpoint written after step 1 (rank 0
    writes, every rank restores) equals the uninterrupted step 2 exactly."""
    ranks, _, _ = runs
    for r in ranks:
        assert r["resumed_loss"] == r["losses"][1]
        for name, want in r["state"].items():
            assert torch.equal(r["resumed_state"][name], want), name


def test_sharded_eval_hist_equals_world_1(runs):
    """5 images shared 3 / 2 between the ranks: the summed hist equals the
    world-1 hist, integer for integer."""
    ranks, one, _ = runs
    for r in ranks:
        np.testing.assert_array_equal(r["hist"], one["hist"])
    assert one["hist"].sum() == worker.VAL_IMAGES * np.prod(worker.HW)


def test_sharded_eval_at_batch_2_merges_one_hist_on_every_rank(runs):
    """In batches of 2 (the tools evaluate in batches of 4) an image's
    seeded NMF bases depend on its row in its shard's batch, so the merged
    hist depends on the world size (as the JAX package's per-host eval
    does); what holds is that every rank merges the same hist, and that it
    counts every pixel of the 5 images once."""
    ranks, one, _ = runs
    np.testing.assert_array_equal(ranks[0]["hist_batch2"],
                                  ranks[1]["hist_batch2"])
    for h in (ranks[0]["hist_batch2"], one["hist_batch2"]):
        assert h.sum() == worker.VAL_IMAGES * np.prod(worker.HW)


def test_frozen_encoder_gradients_are_not_summed(runs):
    """One step with the encoder left out of the optimizer (the train
    tool's mask for a pretrained encoder): a trained parameter's gradient
    is the same on both ranks and equals world 1's to GRAD_REL of max; a
    frozen one's is not all-reduced: it differs between the ranks, and the
    ranks' two sum to world 1's (each rank's term of the global loss)."""
    ranks, one, _ = runs
    assert torch.equal(ranks[0]["trained_grad"], ranks[1]["trained_grad"])
    _close(ranks[0]["trained_grad"], one["trained_grad"], GRAD_REL,
           "trained_grad")
    assert not torch.equal(ranks[0]["frozen_grad"], ranks[1]["frozen_grad"])
    _close(ranks[0]["frozen_grad"] + ranks[1]["frozen_grad"],
           one["frozen_grad"], GRAD_REL, "frozen_grad")


def _jax_references():
    """The JAX BatchNorm in training (output, input gradient, running
    statistics) and the JAX masked loss and its logits gradient on the
    worker's global tensors."""
    rng = np.random.RandomState(1)
    x = rng.randn(*worker.BN_SHAPE).astype(np.float32) * 2 + 0.5
    g = rng.randn(*worker.BN_SHAPE).astype(np.float32)
    logits = rng.randn(*worker.LOSS_SHAPE).astype(np.float32)
    labels = rng.randint(0, worker.LOSS_SHAPE[-1], worker.LOSS_SHAPE[:3])
    half = worker.GLOBAL_BATCH // 2
    labels[half:][rng.rand(half, *worker.LOSS_SHAPE[1:3])
                  < worker.IGNORED_SHARE] = 255
    assert (labels[half:] == 255).mean() > 0.8

    bn = JBatchNorm()
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        use_running_average=False)

    @jax.jit
    def bn_fwd(xx):
        return bn.apply(variables, xx, use_running_average=False,
                        mutable=["batch_stats"])

    (out, stats), pullback = jax.vjp(bn_fwd, jnp.asarray(x))
    (dx,) = pullback((jnp.asarray(g), jax.tree_util.tree_map(
        jnp.zeros_like, stats)))
    loss, dlogits = jax.jit(jax.value_and_grad(j_loss))(
        jnp.asarray(logits), jnp.asarray(labels))
    return dict(bn_out=out, bn_dx=dx, bn_mean=stats["batch_stats"]["mean"],
                bn_var=stats["batch_stats"]["var"], loss=loss,
                dlogits=dlogits)


def test_group_batchnorm_and_loss_match_jax_on_the_global_batch(runs):
    """The ranks' BatchNorm rows (output, input gradient) concatenated, and
    their running statistics, against the JAX BatchNorm in training on the
    global batch; the loss summed over the ranks and its logits gradient
    against the JAX masked mean on the global logits and labels (the same
    255 pattern: most of rank 1's pixels). fp32: JAX_REL of max for
    outputs and gradients, JAX_STATS_REL for the statistics and loss."""
    ranks, _, want = runs
    for key in ("bn_out", "bn_dx", "dlogits"):
        _close(np.concatenate([r[key].numpy() for r in ranks]), want[key],
               JAX_REL, key)
    for r in ranks:
        for key in ("bn_mean", "bn_var", "loss"):
            _close(r[key], want[key], JAX_STATS_REL, key)


# --- the Trav tools ------------------------------------------------------------

TRAV_STATE_REL = 1e-5   # of max(each leaf's max |world 1|, STATE_FLOOR)


def _same_state(ranks, want, key):
    for name, w in want.items():
        assert torch.equal(ranks[0][key][name], ranks[1][key][name]), name
        if w.dtype.is_floating_point:
            _close(ranks[0][key][name], w, TRAV_STATE_REL, name, STATE_FLOOR)
        else:
            assert torch.equal(ranks[0][key][name], w), name


def test_trav_fss_tool_two_ranks_take_the_world_1_step(runs):
    """One step of `tools.train_trav_fss.run` on class episodes (global
    batch 2, one episode per rank): the loss and its contrastive term, and
    every parameter and BatchNorm statistic (global statistics over the
    support and query images), equal world 1's; the episodic mIoU of the
    sharded evaluation, its hists merged, is world 1's, and rank 0 alone
    wrote its one checkpoint; a rescue file of the trained state, written
    by rank 0, restores on every rank to that state."""
    ranks, one, _ = runs
    for r in ranks:
        for key in ("fss_losses", "fss_contrastive"):
            np.testing.assert_allclose(list(r[key].values()),
                                       list(one[key].values()),
                                       rtol=LOSS_REL, atol=0)
        assert r["fss_miou"] == one["fss_miou"]
        assert r["fss_checkpoints"] == one["fss_checkpoints"]
        assert r["fss_rescue_difference"] is None
    assert len(one["fss_checkpoints"]) == (1 if one["fss_miou"][1] > 0
                                           else 0)
    _same_state(ranks, one["fss_state"], "fss_state")


def test_train_trav_tool_two_ranks_take_the_world_1_step(runs):
    """One supervised step of `tools.train_trav.run` (global batch 2, one
    row per rank, the mirror draws of the global batch): the loss and every
    leaf against world 1's."""
    ranks, one, _ = runs
    for r in ranks:
        np.testing.assert_allclose(list(r["trav_losses"].values()),
                                   list(one["trav_losses"].values()),
                                   rtol=LOSS_REL, atol=0)
    _same_state(ranks, one["trav_state"], "trav_state")


def test_train_trav_tool_writes_world_1s_pseudo_labels_once(runs):
    """The 3 unlabelled images labelled 2 / 1 by the ranks: one manifest,
    in row order, equal to world 1's, and the same masks."""
    ranks, one, _ = runs
    assert one["manifest"].count("\n") == worker.TRAV_UNLABELED + 1
    for r in ranks:
        assert r["manifest"] == one["manifest"]
        assert list(r["masks"]) == list(one["masks"])
        for name, mask in one["masks"].items():
            np.testing.assert_array_equal(r["masks"][name], mask)
