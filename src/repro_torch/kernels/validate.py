"""Shared launch-parameter validation (port of ``repro.kernels.validate``).

* **bound** (``divides=False``): a block must fit inside its dimension
  (``1 <= block <= dim``);
* **divisibility** (``divides=True``): the block must divide the dimension.

Both raise a ``ValueError`` naming the kernel, the offending dimension and
the nearest valid block.  The reference's ``resolve_interpret`` (Pallas
execution mode) and ``dtype_name`` (tuning-DB tag) have no counterpart
yet: the port has no interpret mode, and the tuner is ROADMAP Queue 1,
slice 5.
"""
from __future__ import annotations


def nearest_valid_block(dim: int, block: int, *, divides: bool = False) -> int:
    """The valid block size closest to ``block`` for ``dim``.

    ``divides=False``: clamp into ``[1, dim]``.  ``divides=True``: the
    divisor of ``dim`` nearest to ``block`` (ties go to the larger one).
    """
    if dim < 1:
        raise ValueError(f"dimension must be positive, got {dim}")
    if not divides:
        return max(1, min(block, dim))
    divisors = [d for d in range(1, dim + 1) if dim % d == 0]
    return min(reversed(divisors), key=lambda d: abs(d - block))


def validate_block(kernel: str, dim_name: str, dim: int,
                   block_name: str, block: int, *,
                   divides: bool = False) -> int:
    """Validate one launch parameter; returns it unchanged when valid."""
    if not isinstance(block, int) or isinstance(block, bool):
        raise ValueError(f"{kernel}: {block_name} must be an int, "
                         f"got {block!r}")
    if block < 1 or block > dim:
        raise ValueError(
            f"{kernel}: {block_name}={block} is outside [1, {dim_name}={dim}] "
            f"(nearest valid: {nearest_valid_block(dim, block, divides=divides)})")
    if divides and dim % block != 0:
        raise ValueError(
            f"{kernel}: {block_name}={block} does not divide {dim_name}={dim} "
            f"(nearest valid: {nearest_valid_block(dim, block, divides=True)})")
    return block
