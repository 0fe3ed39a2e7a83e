"""What the kernels' vmap rules share.

Each kernel wrapper is a ``torch.library.custom_op`` with a
``register_vmap`` rule, so ``torch.func.vmap`` over the single-stream step
sees a batched call once and launches one kernel for the whole batch. An
argument the batch shares reaches a rule either unbatched (in_dim None) or,
where an earlier vmap handed it back, expanded with a batch stride of 0;
both are read once, never copied B times.
"""
from __future__ import annotations


def split(x, in_dim):
    """(x with its batch dimension first, True), or (x unbatched, False)
    where the batch shares it."""
    if in_dim is None:
        return x, False
    x = x.movedim(in_dim, 0)
    if x.shape[0] > 1 and x.stride(0) == 0:
        return x[0], False
    return x, True


def rows(x, in_dim, B: int):
    """x as (B, ...) rows, a shared x expanded without a copy."""
    x, batched = split(x, in_dim)
    return x if batched else x.expand(B, *x.shape)


def flat(x, in_dim, B: int):
    """x's rows joined on its first axis, (B * n, ...), contiguous."""
    x = rows(x, in_dim, B)
    return x.reshape(B * x.shape[1], *x.shape[2:]).contiguous()
