"""Data parallelism over processes (counterpart of
`dformer_tpu/parallel/mesh.py`): one process per card, launched by
`torchrun`, joined in the default `torch.distributed` process group.

The JAX package shards one global batch over a mesh and lets GSPMD compute
global BatchNorm moments, the gradient all-reduce and the summed metric
hists. Here each rank holds `batch_size // world` rows of the global batch,
in rank order (rank r the rows [r * n, (r + 1) * n), as `commit_global`
concatenates the hosts' slices), and the same three things are explicit:
`all_sum` (differentiable) in BatchNorm and the loss's valid-pixel count,
`sync_grads` after the backward, `Metrics.merge_across_processes` after an
evaluation. A draw for the batch (DropPath, dropout, NMF bases, the
augmentation) is made for the global batch from the step's generator, the
same on every rank, and each rank keeps its rows (`rand_rows`,
`randint_rows`): a world-N run takes the steps a world-1 run takes on the
same global batch. A forward whose batch joins several global batches
(the few-shot episode's support images, then its queries) names its
blocks (`row_blocks`), so that each rank keeps its rows of each block.

One process drives one device, so there is no mesh inside a process.
"""

import contextlib
import os

import torch
import torch.distributed as dist

# calls of `sync_grads`: the gradient all-reduces a run made
grad_syncs = 0
# the blocks of the local batch inside `row_blocks`, else None
_blocks = None


def active() -> bool:
    """Whether a default process group is up."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """Processes in the default group; 1 without one."""
    return dist.get_world_size() if active() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if active() else 0


def init_from_env(device="cuda") -> bool:
    """Join the process group `torchrun` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL for a
    CUDA `device`, gloo for the CPU; on CUDA the process takes the card
    LOCAL_RANK. Returns whether a group is up afterwards: no RANK in the
    environment (not launched by torchrun) starts none, and a group already
    up is kept."""
    if active():
        return True
    if "RANK" not in os.environ:
        return False
    if torch.device(device).type == "cuda":
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", init_method="env://",
                                device_id=card)
    else:
        dist.init_process_group("gloo", init_method="env://")
    return True


@contextlib.contextmanager
def group_from_env(device="cuda"):
    """The process group `torchrun` describes (`init_from_env`) for the
    `with` block, left at its end if the block started it; yields whether
    a group is up."""
    started = not active() and init_from_env(device)
    try:
        yield active()
    finally:
        if started:
            dist.destroy_process_group()


@contextlib.contextmanager
def row_blocks(*sizes: int):
    """Inside the block the local batch is the concatenation of blocks of
    `sizes` rows, each this rank's rows of a global batch of world * size
    rows that lie in the same order one after the other (`meta_forward`'s
    B*S support images, then its B queries): a draw for the global batch
    of all of them (`rand_rows`) keeps this rank's rows of each block."""
    global _blocks
    outer, _blocks = _blocks, tuple(sizes)
    try:
        yield
    finally:
        _blocks = outer


def rank_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch `t`: its contiguous block of
    t.shape[0] // world rows (all of `t` without a group); inside
    `row_blocks`, when `t` holds world * sum(sizes) rows, its rows of each
    block, concatenated."""
    w, r = world(), rank()
    if _blocks is not None and t.shape[0] == w * sum(_blocks):
        parts, start = [], 0
        for n in _blocks:
            parts.append(t[start + r * n:start + (r + 1) * n])
            start += w * n
        return torch.cat(parts)
    n = t.shape[0] // w
    return t[r * n:(r + 1) * n]


def _global_shape(shape) -> tuple:
    return (shape[0] * world(),) + tuple(shape[1:])


def rand_rows(shape, generator: torch.Generator) -> torch.Tensor:
    """A uniform [0, 1) draw of `shape` from `generator`, on its device,
    made for the global batch (shape[0] rows on each rank), of which this
    rank keeps its shape[0] rows: every rank draws the same numbers."""
    return rank_rows(torch.rand(_global_shape(shape), generator=generator,
                                device=generator.device))


def randint_rows(high: int, shape,
                 generator: torch.Generator) -> torch.Tensor:
    """`rand_rows` of integers in [0, high)."""
    return rank_rows(torch.randint(0, high, _global_shape(shape),
                                   generator=generator,
                                   device=generator.device))


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the group, differentiable: the gradient of each
    rank's input is the sum of the ranks' output gradients (the loss is the
    sum of the ranks' terms). `t` itself without a group."""
    return _AllSum.apply(t) if active() else t


def sync_grads(params) -> None:
    """Sum each parameter's gradient over the group, in place: one
    all-reduce per dtype of a flat copy of the gradients, copied back in
    one multi-tensor launch. Each rank's loss is its term of the
    global-batch loss, so the sum is the gradient of that loss (no
    division by the world size). A parameter without a gradient takes part
    as zeros and keeps them. Counted in `grad_syncs`."""
    global grad_syncs
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        parts = flat.split([g.numel() for g in grads])
        # one multi-tensor copy, not a launch per parameter
        torch._foreach_copy_(grads, [part.view_as(g)
                                     for part, g in zip(parts, grads)])
    grad_syncs += 1


def check_replicas_equal(params) -> None:
    """Raise unless every rank holds the same values: one all-reduce (MAX)
    of each parameter's fp64 sum and its negation."""
    sums = torch.stack([p.detach().double().sum() for p in params])
    both = torch.cat([sums, -sums])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    n = len(sums)
    if not torch.equal(both[:n], -both[n:]):
        raise RuntimeError("data-parallel ranks hold different parameters "
                           "after the first step")
